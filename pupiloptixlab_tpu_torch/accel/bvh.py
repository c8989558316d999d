"""Host-side 8-wide BVH builder over the flattened triangle soup.

Counterpart of pupiloptixlab_tpu/accel/bvh.py, with bit-identical
``order``, ``child``, ``axis`` and ``boxes``.

Builder design: binned-SAH splits over triangle centroids, three binary
levels collapsed into one 8-ary node, triangles reordered so every leaf
is one contiguous TCL-aligned row range, children sorted ascending along
the node's dominant split axis (the traversal pushes far-to-near by the
ray's direction sign along that axis).

Child-id encoding: ``id >= 0`` is an internal node; ``id < 0`` is a
leaf whose triangle rows start at ``-(id + 1)``. Empty slots carry child
id 0 (the root) with a never-hit point box at 1e30. Node 0 is the root.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np

# 8-ary nodes carry 9 int32 (8 child ids + axis); the reference sizes
# leaves so the node tables fit the TPU's scalar memory, and the port
# keeps its leaf-size rule so both packages build the same tree.
_SMEM_BUDGET_BYTES = 160 * 1024
_NODE_SMEM_BYTES = 9 * 4
_MAX_NODES = _SMEM_BUDGET_BYTES // _NODE_SMEM_BYTES
# Triangle tables above this many bytes take the reference's streamed TPU
# traversal (pallas_bvh.STREAM_TRI_BYTES), which prefers 32-row leaves at
# flatten time and never runs the matmul-form leaf test (accel/intersect.py).
STREAM_TRI_BYTES = 8 * 1024 * 1024


@dataclass
class BvhArrays:
    order: np.ndarray   # (T,) permutation of padded triangle rows
    child: np.ndarray   # (M*8,) i32 child ids (see encoding above)
    axis: np.ndarray    # (M,) i32 dominant split axis per node
    boxes: np.ndarray   # (M*8, 8) f32 [lox loy loz hix hiy hiz 0 0]
    tcl: int            # leaf size (tri rows per leaf)
    n_nodes: int


def pick_leaf_size(t_pad: int, min_tcl: int = 16) -> int:
    """Smallest leaf size (>= min_tcl, doubling) whose 8-ary node count
    fits the node budget (internal nodes ~= n_leaves / 7). ``PUPIL_TCL``
    overrides ``min_tcl``, read here as the reference's pick_leaf_size
    reads it, so that one environment gives both packages one tree (and
    ``PUPIL_TCL=32`` the 32-row leaves of the matmul-form leaf test)."""
    env = os.environ.get("PUPIL_TCL")
    if env:
        min_tcl = int(env)
    tcl = min_tcl
    while True:
        n_leaves = max((t_pad + tcl - 1) // tcl, 1)
        if n_leaves // 7 + 8 <= _MAX_NODES:
            return tcl
        tcl *= 2


# "Never hit" box for empty child slots and all-padding leaves: a POINT
# at 1e30. An inverted box does not work with the min/max slab test
# (swapped slabs match every ray); the point box yields |t| ~ 1e30 >
# every tmax on at least one axis, so tn > tf for every real ray.
_NEVER_LO = np.full(3, 1e30, np.float32)
_NEVER_HI = np.full(3, 1e30, np.float32)


def build_bvh(
    p0: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    valid_count: int,
    tcl: int,
    allow_native: bool = True,
) -> BvhArrays:
    """Build the 8-wide BVH over padded world-space triangle vertices
    ((T,3) each; rows >= valid_count are degenerate padding). T must be
    a multiple of tcl and > tcl.

    Prefers the C++ builder (csrc/pupil_native.cpp through native.py),
    as the JAX package's build_bvh does with its own copy, so both
    packages flatten a scene to the same tables; this numpy
    implementation is the behavioral specification and the fallback.
    ``allow_native=False`` forces numpy."""
    if allow_native:
        from pupiloptixlab_tpu_torch.native import build_bvh8_native

        native = build_bvh8_native(p0, p1, p2, valid_count, tcl)
        if native is not None:
            return native

    t_pad = p0.shape[0]
    assert t_pad % tcl == 0 and t_pad > tcl
    lo_tri = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    hi_tri = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    # padding must never contribute to boxes (inverted "empty" interval)
    if valid_count < t_pad:
        lo_tri[valid_count:] = 1e30
        hi_tri[valid_count:] = -1e30
    centroid = 0.5 * (lo_tri + hi_tri)
    if valid_count < t_pad:
        # cluster padding with the last valid triangle so it stays in the
        # final leaf instead of spreading empty rows across the tree
        anchor = centroid[valid_count - 1] if valid_count else np.zeros(3)
        centroid[valid_count:] = anchor

    order = np.arange(t_pad, dtype=np.int64)
    child: list[list[int]] = []   # 8 ids per node
    axis_l: list[int] = []
    boxes_l: list[np.ndarray] = []  # (8, 8) per node

    _N_BINS = 16

    def sah_split(lo: int, hi: int) -> tuple[int, int]:
        """Binned-SAH partition of order[lo:hi] at a TCL-aligned cut;
        returns (mid, axis). Falls back to the TCL-aligned median when
        SAH degenerates (all centroids coincident)."""
        idx = order[lo:hi]
        c = centroid[idx]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        n_leaves = (hi - lo) // tcl
        best = None  # (cost, axis, n_left_rows)
        for ax in range(3):
            if ext[ax] < 1e-12:
                continue
            bins = np.minimum(
                ((c[:, ax] - cmin[ax]) / ext[ax] * _N_BINS).astype(np.int32),
                _N_BINS - 1,
            )
            counts = np.bincount(bins, minlength=_N_BINS)
            # per-bin bounds over triangle boxes
            blo = np.full((_N_BINS, 3), 1e30, np.float32)
            bhi = np.full((_N_BINS, 3), -1e30, np.float32)
            np.minimum.at(blo, bins, lo_tri[idx])
            np.maximum.at(bhi, bins, hi_tri[idx])
            # prefix/suffix surface areas
            def areas(lo_b, hi_b):
                # f64: sentinel boxes (hidden/degenerate rows, +-1e30)
                # square past f32 range and the inf can poison the SAH
                # compare via inf*0
                d = np.maximum((hi_b - lo_b).astype(np.float64), 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]
            plo = np.minimum.accumulate(blo, axis=0)
            phi = np.maximum.accumulate(bhi, axis=0)
            slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            nl = np.cumsum(counts)[:-1]
            nr = (hi - lo) - nl
            cost = areas(plo, phi)[:-1] * nl + areas(slo, shi)[1:] * nr
            valid = (nl > 0) & (nr > 0)
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            b = int(np.argmin(cost))
            # align the cut to whole leaves
            n_left = int(round(nl[b] / tcl)) * tcl
            n_left = min(max(n_left, tcl), (n_leaves - 1) * tcl)
            if best is None or cost[b] < best[0]:
                best = (cost[b], ax, n_left)
        if best is None:  # degenerate: median split on the widest axis
            ax = int(np.argmax(ext))
            best = (0.0, ax, (n_leaves // 2) * tcl)
        _, ax, half = best
        part = np.argpartition(c[:, ax], half - 1)
        order[lo:hi] = idx[part]
        return lo + half, ax

    def make_node(lo: int, hi: int) -> tuple[int, np.ndarray, np.ndarray]:
        """Create the 8-ary node for range [lo, hi) (> tcl rows).
        Returns (node_id, box_lo, box_hi)."""
        nid = len(child)
        child.append([0] * 8)
        axis_l.append(0)
        boxes_l.append(np.zeros((8, 8), np.float32))

        # collapse 3 binary split levels into <= 8 subranges
        subranges = [(lo, hi)]
        first_axis = None
        for _ in range(3):
            nxt = []
            for a, b in subranges:
                if b - a <= tcl:
                    nxt.append((a, b))
                    continue
                mid, ax = sah_split(a, b)
                if first_axis is None:
                    first_axis = ax
                nxt.append((a, mid))
                nxt.append((mid, b))
            subranges = nxt

        entries = []  # (child_id, lo3, hi3)
        for a, b in subranges:
            if b - a <= tcl:
                rows = order[a:b]
                blo = lo_tri[rows].min(axis=0)
                bhi = hi_tri[rows].max(axis=0)
                if blo[0] > bhi[0]:  # all-padding leaf -> never visit
                    blo, bhi = _NEVER_LO, _NEVER_HI
                entries.append((-(a + 1), blo, bhi))
            else:
                entries.append(make_node(a, b))

        ax = first_axis or 0
        # sort children ascending along the dominant axis so the kernel's
        # far-to-near push order follows the tile's direction sign
        entries.sort(key=lambda e: 0.5 * float(e[1][ax] + e[2][ax]))
        box = boxes_l[nid]
        total_lo = np.full(3, 1e30, np.float32)
        total_hi = np.full(3, -1e30, np.float32)
        for k, (cid, blo, bhi) in enumerate(entries):
            child[nid][k] = cid
            box[k, 0:3] = blo
            box[k, 3:6] = bhi
            if bhi[0] < 1e30:  # skip never-boxes in the union
                total_lo = np.minimum(total_lo, blo)
                total_hi = np.maximum(total_hi, bhi)
        for k in range(len(entries), 8):  # empty slots: never-hit boxes
            box[k, 0:3] = _NEVER_LO
            box[k, 3:6] = _NEVER_HI
        if total_lo[0] > total_hi[0]:  # node entirely padding
            total_lo, total_hi = _NEVER_LO, _NEVER_HI
        axis_l[nid] = ax
        return nid, total_lo, total_hi

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        make_node(0, t_pad)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(child)
    return BvhArrays(
        order=order,
        child=np.asarray(child, np.int32).reshape(-1),
        axis=np.asarray(axis_l, np.int32),
        boxes=np.concatenate(boxes_l, axis=0),
        tcl=tcl,
        n_nodes=m,
    )


def bvh_depth(child: np.ndarray) -> int:
    """Depth of the 8-ary tree (root alone = 1); 0 for an empty table.
    The traversal kernels hold at most ``7 * depth + 1`` stack entries
    (pop one node, push up to eight children per level)."""
    ids = np.asarray(child).reshape(-1, 8)
    depth = np.zeros(ids.shape[0], np.int64)
    for i in range(ids.shape[0]):
        for cid in ids[i]:
            if cid > 0:
                depth[cid] = depth[i] + 1
    return int(depth.max()) + 1 if ids.shape[0] else 0


def max_stack_depth(child: np.ndarray) -> int:
    """Worst-case traversal stack bound: up to 8 pushes per level of the
    8-ary tree (pop one, push its live children). The reference's bound
    (its accel/bvh.py:269), 7 * depth + 8 over the levels below the root;
    the kernels' own rule is ``bvh_traverse.stack_fits``."""
    ids = np.asarray(child).reshape(-1, 8)
    depth = np.zeros(ids.shape[0], np.int32)
    peak = 8
    for i in range(ids.shape[0]):
        for cid in ids[i]:
            if cid > 0:
                depth[cid] = depth[i] + 1
                # pop one, push <= 8 -> <= 7 net per level plus the burst
                peak = max(peak, 7 * (int(depth[i]) + 1) + 8)
    return peak
