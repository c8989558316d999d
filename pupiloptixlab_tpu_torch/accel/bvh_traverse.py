"""Closest-hit and any-hit BVH traversal over ray planes.

Counterpart of pupiloptixlab_tpu/accel/pallas_bvh.py for the resident,
non-instanced forms, with the same argument order as its ``bvh_closest``
and ``bvh_anyhit``. Kernels (csrc/bvh_traverse.cu):
  bvh_closest (K1) <- _make_closest_kernel
  bvh_anyhit  (K2) <- _make_anyhit_kernel

The plain versions (``plain_closest`` for K1, ``plain_anyhit`` for K2) are
the brute-force sweep of accel/sweep.py over every triangle: the closest
hit with ties at equal t going to the lowest row, a miss (1e16, -1). The
kernels return exactly that (t, row), bit for bit.
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel.sweep import plain_sweep_anyhit as plain_anyhit
from pupiloptixlab_tpu_torch.accel.sweep import plain_sweep_closest as plain_closest

STACK_SIZE = 64  # per-thread traversal stack of the CUDA kernels


def stack_fits(depth: int) -> bool:
    """The kernels pop one node and push up to eight children per level,
    so a tree of ``depth`` levels needs at most 7 * depth + 1 entries."""
    return 7 * depth + 1 <= STACK_SIZE


def _check_args(name, planes, tri, child, axis, boxes, tcl, depth):
    dev = tri.device
    n = planes[0].shape[0]
    for i, p in enumerate(planes):
        if (p.device != dev or p.dtype != torch.float32 or p.dim() != 1
                or p.shape[0] != n or not p.is_contiguous()):
            raise ValueError(f"{name}: ray plane {i} must be a contiguous (N,) "
                             f"float32 tensor on {dev}")
    for label, t, dt, shape in (
        ("tri", tri, torch.float32, (None, 12)),
        ("bvh_child", child, torch.int32, (None,)),
        ("bvh_axis", axis, torch.int32, (None,)),
        ("bvh_boxes", boxes, torch.float32, (None, 8)),
    ):
        if (t.device != dev or t.dtype != dt or t.dim() != len(shape)
                or (len(shape) == 2 and t.shape[1] != shape[1])
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous {dt} "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)}")
    n_nodes = axis.shape[0]
    if child.shape[0] != n_nodes * 8 or boxes.shape[0] != n_nodes * 8 or n_nodes == 0:
        raise ValueError(f"{name}: node tables disagree ({child.shape[0]} child "
                         f"ids, {n_nodes} axes, {boxes.shape[0]} boxes)")
    if tcl <= 0 or tri.shape[0] < tcl:
        raise ValueError(f"{name}: leaf size {tcl} vs {tri.shape[0]} rows")
    if not stack_fits(depth):
        raise ValueError(f"{name}: BVH depth {depth} needs {7 * depth + 1} stack "
                         f"entries; the kernel holds {STACK_SIZE}")
    return n, n_nodes


def _raise_on_flag(name, err):
    code = int(err.item())
    if code:
        raise RuntimeError(f"{name}: traversal fault flag {code} "
                           "(1 = visit cap exceeded, 2 = stack overflow)")


def bvh_closest(rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                tri, bvh_child, bvh_axis, bvh_boxes, tcl: int = 16, depth: int = 1):
    """Closest-hit traversal over ray planes; returns (t, idx) with
    (1e16, -1) on a miss. ``depth``: the tree depth the flatten records
    (checked against the kernel's stack)."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if tri.device.type == "cpu":
        return plain_closest(*planes, tri)
    n, n_nodes = _check_args("bvh_closest", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    t_out = torch.empty(n, dtype=torch.float32, device=tri.device)
    i_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_closest")
    kernels.LAUNCHES["bvh_closest"] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), bvh_child.data_ptr(),
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), n, tri.shape[0], tcl,
            n_nodes, t_out.data_ptr(), i_out.data_ptr(), err.data_ptr(),
            kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_closest")
    _raise_on_flag("bvh_closest", err)
    return t_out, i_out


def bvh_anyhit(rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
               tri, bvh_child, bvh_axis, bvh_boxes, tcl: int = 16, depth: int = 1):
    """Occlusion-only traversal; returns (N,) int32 (1 = occluded)."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if tri.device.type == "cpu":
        return plain_anyhit(*planes, tri)
    n, n_nodes = _check_args("bvh_anyhit", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    occ = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_anyhit")
    kernels.LAUNCHES["bvh_anyhit"] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), bvh_child.data_ptr(),
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), n, tri.shape[0], tcl,
            n_nodes, occ.data_ptr(), err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_anyhit")
    _raise_on_flag("bvh_anyhit", err)
    return occ
