"""Closest-hit and any-hit BVH traversal over ray planes.

Counterpart of pupiloptixlab_tpu/accel/pallas_bvh.py, with the same
argument order as its ``bvh_closest`` and ``bvh_anyhit``. Kernels
(csrc/bvh_traverse.cu):
  bvh_closest      (K1) <- _make_closest_kernel, resident and stream=True
  bvh_anyhit       (K2) <- _make_anyhit_kernel, resident and stream=True
  bvh_closest_inst (K7) <- _make_closest_kernel(instanced=True)
  bvh_anyhit_inst  (K8) <- _make_anyhit_kernel(instanced=True)
The TPU streams triangle tables above 8 MB through a DMA ring; K1/K2 read
every table from device memory, so one kernel serves both.

The plain versions of K1/K2 (``plain_closest``, ``plain_anyhit``) are the
brute-force sweep of accel/sweep.py over every triangle: the closest hit
with ties at equal t going to the lowest row, a miss (1e16, -1). Those of
K7/K8 (``plain_closest_inst``, ``plain_anyhit_inst``) scan every world
leaf in table order with the ray mapped into the leaf's instance space,
as the reference's ``_sweep_tris_xla_instanced`` does: ties at equal t go
to the lowest world leaf, then the lowest row. The kernels return exactly
those results, bit for bit.
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel.sweep import _PAIR_BUDGET, MAX_DISTANCE, mt_hit_t
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


def leaf_scan_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, leaf_start,
                   leaf_inst, inst_w2o, tcl: int, any_hit: bool = False):
    """Closest hit (t, unique row, world leaf) of every ray over every world
    leaf of an instanced scene, leaves in table order: the ray goes into
    the leaf's instance space as w0*x + w1*y + w2*z + w3 (not
    renormalised, so t is the world parameter), then ``mt_hit_t`` over the
    leaf's ``tcl`` rows. Ties at equal t go to the lowest leaf, then the
    lowest row; a miss is (1e16, -1, -1). With ``any_hit`` a ray chunk
    stops once all its rays hit."""
    n = rox.shape[0]
    dev = rox.device
    tbest = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    ibest = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lbest = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(tmax > tmin).squeeze(1)
    n_leaves = leaf_start.shape[0]
    if live.numel() == 0 or n_leaves == 0:
        return tbest, ibest, lbest
    start = torch.clamp(leaf_start.long(), 0, tri.shape[0] - tcl)
    rows = start[:, None] + torch.arange(tcl, device=dev)[None, :]  # (L, tcl)
    w_all = inst_w2o[leaf_inst.long()]                               # (L, 12)
    r_chunk = max(min(live.numel(), _PAIR_BUDGET // tcl), 1)
    for rs in range(0, live.numel(), r_chunk):
        lanes = live[rs:rs + r_chunk]
        ox, oy, oz, dx, dy, dz, tmn, tmx = (
            a[lanes][:, None, None] for a in (rox, roy, roz, rdx, rdy, rdz, tmin, tmax))
        bt = torch.full((lanes.numel(),), MAX_DISTANCE, dtype=torch.float32, device=dev)
        bi = torch.full((lanes.numel(),), -1, dtype=torch.int32, device=dev)
        bl = torch.full((lanes.numel(),), -1, dtype=torch.int32, device=dev)
        l_chunk = max(_PAIR_BUDGET // (lanes.numel() * tcl), 1)
        for ls in range(0, n_leaves, l_chunk):
            le = min(ls + l_chunk, n_leaves)
            w = [w_all[ls:le, k][None, :, None] for k in range(12)]  # (1, B, 1)
            ray = (
                w[0] * ox + w[1] * oy + w[2] * oz + w[3],
                w[4] * ox + w[5] * oy + w[6] * oz + w[7],
                w[8] * ox + w[9] * oy + w[10] * oz + w[11],
                w[0] * dx + w[1] * dy + w[2] * dz,
                w[4] * dx + w[5] * dy + w[6] * dz,
                w[8] * dx + w[9] * dy + w[10] * dz,
            )
            blk = tri[rows[ls:le]]  # (B, tcl, 12)
            t = mt_hit_t(*ray, tmn, tmx, [blk[None, :, :, k] for k in range(9)])
            # leaf-major, row-minor: the first minimum is the lowest leaf,
            # then the lowest row
            tj, j = torch.min(t.reshape(t.shape[0], -1), dim=1)
            better = tj < bt
            leaf = ls + torch.div(j, tcl, rounding_mode="floor")
            bt = torch.where(better, tj, bt)
            bl = torch.where(better, leaf.to(torch.int32), bl)
            bi = torch.where(better, (start[leaf] + j % tcl).to(torch.int32), bi)
            if any_hit and bool((bi >= 0).all()):
                break
        tbest[lanes] = bt
        ibest[lanes] = bi
        lbest[lanes] = bl
    return tbest, ibest, lbest


def plain_closest_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, leaf_start,
                       leaf_inst, inst_w2o, tcl: int = 32):
    """Plain version of K7: ``leaf_scan_inst``'s (t, row, leaf)."""
    return leaf_scan_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, leaf_start,
                          leaf_inst, inst_w2o, tcl)


def plain_anyhit_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, leaf_start,
                      leaf_inst, inst_w2o, tcl: int = 32):
    """Plain version of K8: any hit of ``leaf_scan_inst`` as int32."""
    _, idx, _ = leaf_scan_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri,
                               leaf_start, leaf_inst, inst_w2o, tcl, any_hit=True)
    return (idx >= 0).to(torch.int32)


def _check_inst(name, tri, leaf_start, leaf_inst, inst_w2o):
    dev = tri.device
    for label, t, dt, width in (("leaf_start", leaf_start, torch.int32, None),
                                ("leaf_inst", leaf_inst, torch.int32, None),
                                ("inst_w2o", inst_w2o, torch.float32, 12)):
        if (t.device != dev or t.dtype != dt or t.dim() != (1 if width is None else 2)
                or (width is not None and t.shape[1] != width) or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous {dt} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if leaf_start.shape[0] != leaf_inst.shape[0] or leaf_start.shape[0] == 0:
        raise ValueError(f"{name}: {leaf_start.shape[0]} leaf starts for "
                         f"{leaf_inst.shape[0]} leaf instances")
    return leaf_start.shape[0]


def bvh_closest_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, bvh_child, bvh_axis,
                     bvh_boxes, leaf_start, leaf_inst, inst_w2o, tcl: int = 32,
                     depth: int = 1):
    """Instanced closest-hit traversal; returns (t, unique row, world leaf)
    with (1e16, -1, -1) on a miss. ``leaf_inst[leaf]`` is the instance."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if tri.device.type == "cpu":
        return plain_closest_inst(*planes, tri, leaf_start, leaf_inst, inst_w2o, tcl=tcl)
    n, n_nodes = _check_args("bvh_closest_inst", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    n_leaves = _check_inst("bvh_closest_inst", tri, leaf_start, leaf_inst, inst_w2o)
    t_out = torch.empty(n, dtype=torch.float32, device=tri.device)
    i_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    l_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_closest_inst")
    kernels.LAUNCHES["bvh_closest_inst"] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), bvh_child.data_ptr(),
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), leaf_start.data_ptr(),
            leaf_inst.data_ptr(), inst_w2o.data_ptr(), n, tri.shape[0], tcl, n_nodes,
            n_leaves, t_out.data_ptr(), i_out.data_ptr(), l_out.data_ptr(),
            err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_closest_inst")
    _raise_on_flag("bvh_closest_inst", err)
    return t_out, i_out, l_out


def bvh_anyhit_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, bvh_child, bvh_axis,
                    bvh_boxes, leaf_start, leaf_inst, inst_w2o, tcl: int = 32,
                    depth: int = 1):
    """Instanced occlusion-only traversal; returns (N,) int32 (1 = occluded)."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if tri.device.type == "cpu":
        return plain_anyhit_inst(*planes, tri, leaf_start, leaf_inst, inst_w2o, tcl=tcl)
    n, n_nodes = _check_args("bvh_anyhit_inst", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    n_leaves = _check_inst("bvh_anyhit_inst", tri, leaf_start, leaf_inst, inst_w2o)
    occ = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_anyhit_inst")
    kernels.LAUNCHES["bvh_anyhit_inst"] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), bvh_child.data_ptr(),
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), leaf_start.data_ptr(),
            leaf_inst.data_ptr(), inst_w2o.data_ptr(), n, tri.shape[0], tcl, n_nodes,
            n_leaves, occ.data_ptr(), err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_anyhit_inst")
    _raise_on_flag("bvh_anyhit_inst", err)
    return occ
