"""Closest-hit and any-hit BVH traversal over ray planes.

Counterpart of pupiloptixlab_tpu/accel/pallas_bvh.py for the resident,
non-instanced forms, with the same argument order as its ``bvh_closest``
and ``bvh_anyhit``. Kernels (csrc/bvh_traverse.cu):
  bvh_closest (K1) <- _make_closest_kernel
  bvh_anyhit  (K2) <- _make_anyhit_kernel

The plain versions are a chunked brute-force sweep over every triangle in
``_mt_planes``'s arithmetic (the JAX package's CPU path,
intersect.py::_sweep_tris_xla): the closest hit with ties at equal t going
to the lowest row. The kernels return exactly that (t, row), bit for bit.
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch import kernels

MAX_DISTANCE = 1e16
_DET_EPS = 1e-12
STACK_SIZE = 64  # per-thread traversal stack of the CUDA kernels
_PAIR_BUDGET = 1 << 22  # (ray, triangle) pairs per chunk of the plain sweep


def stack_fits(depth: int) -> bool:
    """The kernels pop one node and push up to eight children per level,
    so a tree of ``depth`` levels needs at most 7 * depth + 1 entries."""
    return 7 * depth + 1 <= STACK_SIZE


def _sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit: bool):
    n = rox.shape[0]
    dev = rox.device
    tbest = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    ibest = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(tmax > tmin).squeeze(1)
    n_tris = tri.shape[0]
    if live.numel() == 0 or n_tris == 0:
        return tbest, ibest
    cols = [tri[:, k] for k in range(9)]
    r_chunk = max(min(live.numel(), _PAIR_BUDGET // 64), 1)
    for rs in range(0, live.numel(), r_chunk):
        lanes = live[rs:rs + r_chunk]
        ox, oy, oz, dx, dy, dz, tmn, tmx = (
            a[lanes][:, None] for a in (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
        )
        bt = torch.full((lanes.numel(),), MAX_DISTANCE, dtype=torch.float32, device=dev)
        bi = torch.full((lanes.numel(),), -1, dtype=torch.int32, device=dev)
        t_chunk = max(_PAIR_BUDGET // lanes.numel(), 8)
        for ts in range(0, n_tris, t_chunk):
            p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                c[ts:ts + t_chunk][None, :] for c in cols
            )
            # _mt_planes, operation by operation
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv = torch.reciprocal(
                torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det)
            )
            tvx = ox - p0x
            tvy = oy - p0y
            tvz = oz - p0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
            del pvx, pvy, pvz
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            del tvx, tvy, tvz
            v = (dx * qvx + dy * qvy + dz * qvz) * inv
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
            del qvx, qvy, qvz, inv
            ok = (
                (torch.abs(det) >= _DET_EPS)
                & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > tmn) & (t < tmx)
            )
            t = torch.where(ok, t, MAX_DISTANCE)
            tj, j = torch.min(t, dim=1)  # first (lowest) index among ties
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bi = torch.where(better, (j + ts).to(torch.int32), bi)
            if any_hit and bool((bi >= 0).all()):
                break
        tbest[lanes] = bt
        ibest[lanes] = bi
    return tbest, ibest


def plain_closest(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri):
    """Plain version of K1: brute-force closest hit (t, row); a miss is
    (1e16, -1)."""
    return _sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit=False)


def plain_anyhit(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri):
    """Plain version of K2: ``plain_closest(...).idx >= 0`` as int32."""
    _, idx = _sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit=True)
    return (idx >= 0).to(torch.int32)


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
