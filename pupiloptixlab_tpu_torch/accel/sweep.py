"""Closest-hit and any-hit chunk sweep over a small triangle table: the
route of scenes without a BVH (``config.bvh_nodes == 0``).

Counterpart of pupiloptixlab_tpu/accel/pallas_intersect.py, with the same
argument order as its ``sweep_triangles`` and ``sweep_triangles_any``.
Kernels (csrc/sweep.cu):
  sweep_closest (K5) <- _kernel_grid and _make_kernel
  sweep_anyhit  (K6) <- _kernel_grid_any

The wrappers take ``rows``, the number of rows the flatten gave
triangles (``config.tri_count`` on the sweep route): every row at or past
it is all zero and never hit, and the kernels test only the rows below it.
They also take the table's box table, ``sweep_boxes`` of
accel/bvh_traverse.py (``TriSoup.sweep_boxes``): padded chunk boxes and,
above ``GROUP`` chunks, padded super-boxes, built once per table.
The plain versions are the brute-force sweep over every row with no
culling (the yardstick that proves no live row is dropped);
accel/bvh_traverse.py takes them as its own plain versions. The kernels
return exactly that (t, row) and flag, bit for bit: from 2 chunks on they
skip chunks (and above 32 chunks, 32-chunk groups) whose padded boxes a ray
cannot improve in, and they reject a pair before the division only where
``mt_pretest`` says it must fail, neither of which changes a lane (save a
ray nearly in a triangle's plane, whose t no box margin bounds; the BVH
shares that exception). The reference pads N to its ray tile; the CUDA
kernels take any N.
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch import kernels

MAX_DISTANCE = 1e16
_DET_EPS = 1e-12
_PAIR_BUDGET = 1 << 22  # (ray, triangle) pairs per chunk of the plain sweep
_ONE_THREAD_PAIR_BUDGET = 1 << 16  # the same, for one CPU thread (_pair_budget)
CHUNK = 64   # rows per chunk (flatten's pad_tris_to)
GROUP = 32   # chunks per super-box (second culling level)


def mt_hit_t(ox, oy, oz, dx, dy, dz, tmn, tmx, tri_cols):
    """Moller-Trumbore in ``_mt_planes``'s arithmetic, operation by
    operation, on broadcast-compatible ray and row planes: t where the ray
    hits in (tmn, tmx), 1e16 elsewhere. ``tri_cols`` is the 9 row planes
    (p0, e1, e2). The kernels repeat these operations in this order."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri_cols
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
    return torch.where(ok, t, MAX_DISTANCE)


def mt_pretest(ox, oy, oz, dx, dy, dz, tri_cols):
    """The kernels' test before the IEEE division (csrc/sweep.cu
    mt_cheap), on broadcast-compatible planes: False where the pair is sure
    to fail ``mt_hit_t``, True where the full test decides. With s(x) = x
    with det's sign (u has the sign of s(u_num)): |det| below the epsilon;
    s(u_num) below -|det| * 2^-100 (u < 0, too far from 0 to underflow to
    -0.0, which passes u >= 0); s(u_num) above |det| * (1 + 2^-20) (u > 1,
    so u + v > 1 for every v >= 0). It repeats ``mt_hit_t``'s operations
    for det and u's numerator."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri_cols
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    un = (ox - p0x) * pvx + (oy - p0y) * pvy + (oz - p0z) * pvz
    adet = torch.abs(det)
    su = torch.where(det < 0.0, -un, un)
    reject = (su < -(adet * 2.0 ** -100)) | (su > adet * (1.0 + 2.0 ** -20))
    return (adet >= _DET_EPS) & ~reject


def _pair_budget(device) -> int:
    """Pairs per chunk of the plain sweep. One CPU thread sweeps ~2.5x
    faster when a chunk's temporaries stay in its cache (mesh_env's table);
    with more threads each operation is a parallel region, whose start-up
    (and, with more threads than free cores, their spinning) a large chunk
    amortises; on the card a large chunk keeps the launches few."""
    if device.type == "cpu" and torch.get_num_threads() == 1:
        return _ONE_THREAD_PAIR_BUDGET
    return _PAIR_BUDGET


def brute_sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit: bool):
    """Closest hit (t, row) of every ray over every row of ``tri`` in
    ``_mt_planes``'s arithmetic (the JAX package's CPU path,
    intersect.py::_sweep_tris_xla), in chunks of at most ``_PAIR_BUDGET``
    (ray, triangle) pairs (``_pair_budget``); ties at equal t go to the
    lowest row, a miss is (1e16, -1). With ``any_hit`` a ray chunk stops
    once all its rays hit (the rows are then a hit, not the closest)."""
    n = rox.shape[0]
    dev = rox.device
    tbest = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    ibest = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(tmax > tmin).squeeze(1)
    n_tris = tri.shape[0]
    if live.numel() == 0 or n_tris == 0:
        return tbest, ibest
    cols = [tri[:, k].contiguous() for k in range(9)]
    budget = _pair_budget(dev)
    r_chunk = max(min(live.numel(), budget // 64), 1)
    for rs in range(0, live.numel(), r_chunk):
        lanes = live[rs:rs + r_chunk]
        ray = [a[lanes][:, None] for a in (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)]
        bt = torch.full((lanes.numel(),), MAX_DISTANCE, dtype=torch.float32, device=dev)
        bi = torch.full((lanes.numel(),), -1, dtype=torch.int32, device=dev)
        t_chunk = max(budget // lanes.numel(), 8)
        for ts in range(0, n_tris, t_chunk):
            t = mt_hit_t(*ray, [c[ts:ts + t_chunk][None, :] for c in cols])
            tj, j = torch.min(t, dim=1)  # first (lowest) index among ties
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bi = torch.where(better, (j + ts).to(torch.int32), bi)
            if any_hit and bool((bi >= 0).all()):
                break
        tbest[lanes] = bt
        ibest[lanes] = bi
    return tbest, ibest


def plain_sweep_closest(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes=None):
    """Plain version of K5 (and of K1, as ``plain_closest`` of
    accel/bvh_traverse.py): brute-force closest hit (t, row) over every row;
    ``boxes`` is accepted and unused."""
    return brute_sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit=False)


def plain_sweep_anyhit(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes=None):
    """Plain version of K6 (and of K2): ``plain_sweep_closest(...).row >= 0``
    as int32."""
    _, idx = brute_sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit=True)
    return (idx >= 0).to(torch.int32)


def group_count(n_chunks: int) -> int:
    """Super-box groups of the culled form, as the reference's wrapper
    counts them; 1 means no super-box (up to ``GROUP`` chunks)."""
    return (n_chunks + GROUP - 1) // GROUP if n_chunks > GROUP else 1


def _check_rows(name, tri, rows):
    """``rows`` must be given, an int within [0, T]."""
    if rows is None:
        raise ValueError(f"{name}: rows= (the table's live row count) is required")
    if isinstance(rows, bool) or not isinstance(rows, int):
        raise ValueError(f"{name}: rows must be an int, got {type(rows).__name__}")
    if not 0 <= rows <= tri.shape[0]:
        raise ValueError(f"{name}: rows={rows} outside [0, {tri.shape[0]}]")


def _check_args(name, planes, tri, boxes):
    dev = tri.device
    n = planes[0].shape[0]
    for i, p in enumerate(planes):
        if (p.device != dev or p.dtype != torch.float32 or p.dim() != 1
                or p.shape[0] != n or not p.is_contiguous()):
            raise ValueError(f"{name}: ray plane {i} must be a contiguous (N,) "
                             f"float32 tensor on {dev}")
    for label, t, width in (("tri", tri, 12), ("boxes", boxes, 8)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 2
                or t.shape[1] != width or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous float32 "
                             f"(None, {width}) on {dev}, got {t.dtype} {tuple(t.shape)}")
    if tri.shape[0] == 0 or tri.shape[0] % CHUNK != 0:
        raise ValueError(f"{name}: {tri.shape[0]} rows; the table must be a "
                         f"positive multiple of {CHUNK} rows (pad with zero rows)")
    n_chunks = tri.shape[0] // CHUNK
    n_super = group_count(n_chunks) if n_chunks > GROUP else 0
    if boxes.shape[0] != n_chunks + n_super:
        raise ValueError(f"{name}: {boxes.shape[0]} boxes; sweep_boxes gives {n_chunks} "
                         f"chunk boxes and {n_super} super-boxes")
    return n, n_chunks


def _launch(name, planes, tri, boxes, rows, outs):
    n, n_chunks = _check_args(name, planes, tri, boxes)
    fn = kernels.launcher(name)
    kernels.LAUNCHES[name] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), boxes.data_ptr(), n, n_chunks,
            rows, *(o.data_ptr() for o in outs), kernels.stream_ptr(tri.device))
    kernels.check(rc, name)


def sweep_closest(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes, *, rows=None):
    """Closest-hit sweep over ray planes (N,) each; ``tri`` (T, 12) with T a
    multiple of 64, ``rows`` (required) the rows below which it holds
    triangles (every row at or past it all zero), ``boxes`` its
    ``sweep_boxes`` (accel/bvh_traverse.py). Returns (t, row) with (1e16,
    -1) on a miss. On the CPU: the brute sweep over every row."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    _check_rows("sweep_closest", tri, rows)
    if tri.device.type == "cpu":
        return plain_sweep_closest(*planes, tri, boxes)
    n = rox.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=tri.device)
    i_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    _launch("sweep_closest", planes, tri, boxes, rows, (t_out, i_out))
    return t_out, i_out


def sweep_anyhit(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes, *, rows=None):
    """Occlusion-only sweep (arguments as ``sweep_closest``); returns (N,)
    int32 (1 = occluded)."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    _check_rows("sweep_anyhit", tri, rows)
    if tri.device.type == "cpu":
        return plain_sweep_anyhit(*planes, tri, boxes)
    occ = torch.empty(rox.shape[0], dtype=torch.int32, device=tri.device)
    _launch("sweep_anyhit", planes, tri, boxes, rows, (occ,))
    return occ
