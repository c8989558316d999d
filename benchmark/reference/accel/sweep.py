"""Brute-force closest-hit and any-hit sweep over a triangle table.

The reference's only triangle route: every ray against every row, in
Moller-Trumbore arithmetic, ties at equal t to the lowest row. Copied from
the port's plain sweep (accel/sweep.py: ``mt_hit_t``, ``brute_sweep``),
with its kernel wrappers and culling tables left out.
"""

from __future__ import annotations

import torch

MAX_DISTANCE = 1e16
_DET_EPS = 1e-12
_PAIR_BUDGET = 1 << 24  # (ray, triangle) pairs per chunk of the sweep
_ONE_THREAD_PAIR_BUDGET = 1 << 16  # the same, for one CPU thread (_pair_budget)


def mt_hit_t(ox, oy, oz, dx, dy, dz, tmn, tmx, tri_cols):
    """Moller-Trumbore in ``_mt_planes``'s arithmetic, operation by
    operation, on broadcast-compatible ray and row planes: t where the ray
    hits in (tmn, tmx), 1e16 elsewhere. ``tri_cols`` is the 9 row planes
    (p0, e1, e2). """
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
    """Brute-force closest hit (t, row) over every row; ``boxes`` is
    accepted and unused."""
    return brute_sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit=False)


def plain_sweep_anyhit(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes=None):
    """``plain_sweep_closest(...).row >= 0`` as int32."""
    _, idx = brute_sweep(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, any_hit=True)
    return (idx >= 0).to(torch.int32)
