"""Ring-sharded scene traversal: triangle tables sharded over the ranks,
rotated rank to rank while the rays stay resident.

Counterpart of pupiloptixlab_tpu/parallel/ring_sweep.py. parallel/sharding.py
replicates the scene on every rank; this module is the other regime, for
tables too large to replicate: each rank holds 1/D of the triangle rows.
A closest-hit query runs D rounds; in each, a rank tests its own rays
against the shard it holds, then passes that shard to rank (r - 1) % D and
takes the next from rank (r + 1) % D (``dist.batch_isend_irecv``, the
reference's ``ppermute``; nothing moves when D = 1, and the last round does
not rotate). At round k rank r holds the shard that started on rank
(r + k) % D. After D rounds every ray has seen the whole scene, with
O(T / D) rows on each rank and one full table of traffic a query.

Two forms, as in the reference:
* ``ring_closest``: each round sweeps the held rows, through the plain
  brute sweep (``inner="plain"``, the reference's jnp inner) or K5
  ``sweep_closest`` (``inner="kernel"``, the reference's Pallas inner)
  over the shard's ``sweep_boxes``, which each rank builds once for its own
  shard and rotates with it (the reference builds chunk boxes each round).
* ``ring_closest_bvh``: each shard carries its own 8-wide BVH and sub-leaf
  table (``build_ring_bvh``), and each round runs K1 ``bvh_closest`` over
  the held shard's tree.

One round (test the held shard, merge by strict t < best t, map shard rows
to global rows) is ``sweep_round`` / ``bvh_round`` (a shard as held:
``sweep_shard`` / ``RingBvh.shard_tables``); the distributed loops
call them, and a single process can call them over D shards to simulate
D ranks. Rays are this rank's own slab: (3, n) origin and direction
component rows and (n,) intervals; results are this rank's (t, row), row
-1 on a miss. A strict merge keeps the earlier round's hit at equal t, so
on an exact tie across shards the row can differ from a single-table
query's lowest row; t cannot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pupiloptixlab_tpu_torch.accel.bvh import BvhArrays, build_bvh, bvh_depth, pick_leaf_size
from pupiloptixlab_tpu_torch.accel.bvh_traverse import bvh_closest, make_baked_subleaf, sweep_boxes
from pupiloptixlab_tpu_torch.accel.sweep import CHUNK, MAX_DISTANCE, plain_sweep_closest, sweep_closest
from pupiloptixlab_tpu_torch.parallel.sharding import check_group


@dataclass(frozen=True)
class RingBvh:
    """Per-shard 8-wide BVHs for ring-rotated traversal, stacked over a
    leading shard dimension. Every shard has the same shapes (rows padded
    to the largest, node tables padded to the largest node count with
    nodes the root never reaches), so one set of buffers rotates."""

    rows: torch.Tensor    # (D, S, 12) shard triangle rows (BVH order)
    child: torch.Tensor   # (D, M*8) i32
    axis: torch.Tensor    # (D, M) i32
    boxes: torch.Tensor   # (D, M*8, 8) f32
    subleaf_rows: torch.Tensor   # (D, S) u8 each shard tree's sub-leaf row order
    subleaf_boxes: torch.Tensor  # (D, S/tcl*8, 8) f32 and its group boxes
    remap: torch.Tensor   # (D*S,) i32: (shard, local row) -> global row
    depth: tuple          # (D,) each shard tree's depth (the kernels' stack check)
    shard_rows: int
    tcl: int

    def shard_tables(self, s: int) -> tuple:
        """K1's six tables of shard ``s``: (rows, child, axis, boxes,
        subleaf_rows, subleaf_boxes), the ones a round holds."""
        return tuple(x[s] for x in (self.rows, self.child, self.axis, self.boxes,
                                    self.subleaf_rows, self.subleaf_boxes))


def build_ring_bvh(tris_packed: torch.Tensor, n_shards: int, tcl: int | None = None,
                   min_tcl: int = 16) -> RingBvh:
    """Split the global BVH-ordered (T, 12) table into ``n_shards``
    contiguous row ranges (compact in space, since the table is in BVH
    order) and build one 8-wide BVH per shard with the flatten's builder
    (accel/bvh.py), and its sub-leaf table (``make_baked_subleaf``). The
    tables land on ``tris_packed``'s device."""
    rows = tris_packed.detach().cpu().numpy().astype(np.float32)
    t, cols = rows.shape
    d = n_shards
    if tcl is None:
        tcl = pick_leaf_size(max(-(-t // d), 1), min_tcl=min_tcl)
    shard_rows = -(-t // d)
    shard_rows = ((shard_rows + tcl - 1) // tcl) * tcl
    shard_rows = max(shard_rows, 2 * tcl)  # build_bvh needs T > tcl
    pad = d * shard_rows - t
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, cols), np.float32)], 0)

    shard_rows_l, childs, axes, boxes_l, remap = [], [], [], [], []
    for s in range(d):
        rs = rows[s * shard_rows:(s + 1) * shard_rows]
        valid = int(np.clip(t - s * shard_rows, 0, shard_rows))
        p0 = rs[:, 0:3]
        p1 = p0 + rs[:, 3:6]
        p2 = p0 + rs[:, 6:9]
        if valid == 0:
            # an empty shard (a tiny scene over many ranks): one node whose
            # children are all empty leaves
            bv = BvhArrays(
                order=np.arange(shard_rows), child=np.full(8, -1, np.int32),
                axis=np.zeros(1, np.int32),
                boxes=np.tile(np.array([[1e30, 1e30, 1e30, -1e30, -1e30, -1e30, 0, 0]],
                                       np.float32), (8, 1)),
                tcl=tcl, n_nodes=1,
            )
        else:
            bv = build_bvh(p0, p1, p2, valid, tcl)
        shard_rows_l.append(rs[bv.order])
        childs.append(bv.child)
        axes.append(bv.axis)
        boxes_l.append(bv.boxes)
        remap.append(s * shard_rows + bv.order.astype(np.int64))

    m_max = max(c.shape[0] // 8 for c in childs)

    def pad_nodes(c, a, b):
        m = c.shape[0] // 8
        return (np.concatenate([c, np.full((m_max - m) * 8, -1, np.int32)]),
                np.concatenate([a, np.zeros(m_max - m, np.int32)]),
                np.concatenate([b, np.zeros(((m_max - m) * 8, 8), np.float32)], 0))

    padded = [pad_nodes(c, a, b) for c, a, b in zip(childs, axes, boxes_l)]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(tris_packed.device)

    rows_t = put(np.stack(shard_rows_l))
    subs = [make_baked_subleaf(rows_t[s], tcl) for s in range(d)]
    return RingBvh(
        rows=rows_t,
        child=put(np.stack([p[0] for p in padded])),
        axis=put(np.stack([p[1] for p in padded])),
        boxes=put(np.stack([p[2] for p in padded])),
        subleaf_rows=torch.stack([r for r, _ in subs]),
        subleaf_boxes=torch.stack([b for _, b in subs]),
        remap=put(np.concatenate(remap).astype(np.int32)),
        depth=tuple(bvh_depth(c) for c in childs),
        shard_rows=shard_rows,
        tcl=tcl,
    )


def _merge(best_t, best_i, t, rows):
    """Keep the earlier hit unless the new one is strictly nearer."""
    better = t < best_t
    return torch.where(better, t, best_t), torch.where(better, rows, best_i)


def _planes(ro_flat, rd_flat, tmin, tmax):
    return [p.contiguous() for p in (ro_flat[0], ro_flat[1], ro_flat[2],
                                     rd_flat[0], rd_flat[1], rd_flat[2], tmin, tmax)]


def _misses(n, device):
    return (torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device))


def _rotate(tensors, group):
    """Send the held tensors to rank (r - 1) % D and receive the next
    rank's, (r + 1) % D: one hop of the ring."""
    d = dist.get_world_size(group)
    if d == 1:
        return tensors
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r - 1) % d) if group is not None else (r - 1) % d
    src = dist.get_global_rank(group, (r + 1) % d) if group is not None else (r + 1) % d
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, src, group) for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(recv)


def bvh_round(best_t, best_i, planes, held, shard: int, ring: RingBvh):
    """One round of ``ring_closest_bvh``: K1 over ``held`` =
    ``ring.shard_tables(shard)`` (its own tree), merged into (best_t,
    best_i) by strict t < best_t, shard rows mapped to global rows."""
    t, i = bvh_closest(*planes, *held, tcl=ring.tcl, depth=ring.depth[shard])
    glob = torch.where(i >= 0, ring.remap[shard * ring.shard_rows + i.clamp(min=0).long()],
                       -1)
    return _merge(best_t, best_i, t, glob)


def sweep_shard(rows: torch.Tensor, inner: str = "plain") -> tuple:
    """What a rank holds of a shard's ``rows`` and rotates with it: (rows,)
    for the plain inner; for K5 the rows padded with zero rows to whole
    64-row chunks and their ``sweep_boxes``, built once a shard."""
    if inner == "plain":
        return (rows.contiguous(),)
    if inner != "kernel":
        raise ValueError(f"ring_closest: inner must be 'plain' or 'kernel', not {inner!r}")
    pad = (-rows.shape[0]) % CHUNK
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))], 0)
    rows = rows.contiguous()
    return rows, sweep_boxes(rows)


def sweep_round(best_t, best_i, planes, held, base: int, n_rows: int, inner: str = "plain"):
    """One round of ``ring_closest``: the held shard (``sweep_shard``; its
    ``n_rows`` rows are global rows ``base`` onward) swept by the plain
    brute sweep or by K5 (which tests those rows, not the zero rows
    ``sweep_shard`` appends), merged by strict t < best_t."""
    if inner == "kernel":
        t, p = sweep_closest(*planes, *held, rows=n_rows)
    elif inner == "plain":
        t, p = plain_sweep_closest(*planes, held[0])
    else:
        raise ValueError(f"ring_closest: inner must be 'plain' or 'kernel', not {inner!r}")
    return _merge(best_t, best_i, t, torch.where(p >= 0, p + base, p))


def shard_tris(tris_packed: torch.Tensor, n_shards: int):
    """Pad the (T, 12) rows with zero rows to a multiple of ``n_shards``;
    returns (padded table, shard_rows): rank r holds rows
    [r * shard_rows, (r + 1) * shard_rows)."""
    pad = (-tris_packed.shape[0]) % n_shards
    if pad:
        tris_packed = torch.cat([tris_packed, tris_packed.new_zeros((pad, 12))], 0)
    return tris_packed, tris_packed.shape[0] // n_shards


def ring_closest(group, ro_flat, rd_flat, tmin, tmax, shard: torch.Tensor,
                 shard_rows: int, inner: str = "plain"):
    """Closest hit of this rank's rays over the whole row-sharded table:
    ``shard`` is this rank's (shard_rows, 12) rows (``shard_tris``); D
    rounds of ``sweep_round``, the shard (with K5 its boxes, built once
    here) rotating around the ring."""
    check_group(group, tmin.device)
    my, d = dist.get_rank(group), dist.get_world_size(group)
    planes = _planes(ro_flat, rd_flat, tmin, tmax)
    best_t, best_i = _misses(tmin.shape[0], tmin.device)
    held = sweep_shard(shard, inner)
    for k in range(d):
        base = ((my + k) % d) * shard_rows
        best_t, best_i = sweep_round(best_t, best_i, planes, held, base, shard_rows, inner)
        if k + 1 < d:
            held = _rotate(held, group)
    return best_t, best_i


def ring_closest_bvh(group, ro_flat, rd_flat, tmin, tmax, ring: RingBvh):
    """Closest hit with per-shard BVH traversal under rotation: D rounds of
    ``bvh_round``, this rank starting on shard ``rank`` and the (rows,
    child, axis, boxes and sub-leaf table) of the held shard rotating one
    hop a round."""
    check_group(group, tmin.device)
    my, d = dist.get_rank(group), dist.get_world_size(group)
    planes = _planes(ro_flat, rd_flat, tmin, tmax)
    best_t, best_i = _misses(tmin.shape[0], tmin.device)
    held = tuple(x.contiguous() for x in ring.shard_tables(my))
    for k in range(d):
        best_t, best_i = bvh_round(best_t, best_i, planes, held, (my + k) % d, ring)
        if k + 1 < d:
            held = _rotate(held, group)
    return best_t, best_i
