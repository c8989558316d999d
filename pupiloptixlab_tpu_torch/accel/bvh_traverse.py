"""Closest-hit and any-hit BVH traversal over ray planes.

Counterpart of pupiloptixlab_tpu/accel/pallas_bvh.py, with the same
argument order as its ``bvh_closest`` and ``bvh_anyhit``. Kernels
(csrc/bvh_traverse.cu):
  bvh_closest      (K1) <- _make_closest_kernel, resident and stream=True
  bvh_anyhit       (K2) <- _make_anyhit_kernel, resident and stream=True
  bvh_closest_inst (K7) <- _make_closest_kernel(instanced=True)
  bvh_anyhit_inst  (K8) <- _make_anyhit_kernel(instanced=True)
  bvh_closest_mt   (K10) <- _make_closest_kernel_mxu (bvh_closest(mxu=True))
  bvh_closest_count (K11) <- _make_closest_kernel(count_iters=True), through
                          bvh_closest(count_iters=True)
The TPU streams triangle tables above 8 MB through a DMA ring; K1/K2 read
every table from device memory, so one kernel serves both.

K1, K2 and K11 also take the port's sub-leaf table of a baked tree
(``make_baked_subleaf``: per leaf of ``tcl`` rows, a leaf-local row order
in 8 spatial groups and one world box a group) and test a leaf's rows only
in the groups whose boxes the ray enters: K1 and K11 nearest group first,
stopping once the nearest group left starts beyond the best hit, K2 in
table order, stopping at its first hit. The results stay the reference's:
the tie rule compares (t, row) outright, so the order in which rows are
tested does not matter, and a group the ray does not enter before the best
hit holds no row that could win. The plain versions do not read the table.

The plain versions of K1/K2 (``plain_closest``, ``plain_anyhit``) are the
brute-force sweep of accel/sweep.py over every triangle: the closest hit
with ties at equal t going to the lowest row, a miss (1e16, -1). Those of
K7/K8 (``plain_closest_inst``, ``plain_anyhit_inst``) scan every world
leaf in table order with the ray mapped into the leaf's instance space,
as the reference's ``_sweep_tris_xla_instanced`` does: ties at equal t go
to the lowest world leaf, then the lowest row. The kernels return exactly
those results, bit for bit. K7/K8 also take the port's sub-leaf table
(``make_subleaf_boxes``: 8 object-space boxes per unique leaf, each over
tcl / 8 consecutive rows) and test a world leaf's rows only in the groups
whose boxes the object ray enters; the plain scans do not read it.

K11 is K1 with traversal counters: K1's (t, row), bit for bit, and per
tile of 1024 consecutive rays the sums of two counts over its rays (inner
nodes taken off the stack, pruned ones included; leaves taken off and
tested), as (N / 1024, 2) int32 [pops, leaves]. A brute sweep walks no tree,
so its plain version (``plain_closest_counts``) is K1's walk itself, ray by
ray in lockstep in PyTorch (``tree_walk``): the same stack, visit order,
pruning, sub-leaf step and tie rule, and the same counts (with the groups
and rows it tests, which the measurement launcher ``bvh_closest_visits``
counts on the card).

K10 walks K1's tree (32-row leaves) but tests each leaf through the
reference's linear form (``mt_cols_table``): det, u*det, v*det and t*det
are 10-term dots of the ray's feature vector [d, (o-c) x d, o-c, 1] with
each row's table columns, summed left to right, and t = (t*det) / det in
IEEE division. Its plain version (``plain_closest_mt``) is the brute
linear-form sweep over every row in the same arithmetic, elementwise (not
through a matrix product, whose summation order is the library's), with
ties at equal t going to the lowest row; K10 returns exactly that. K10
reads its own tables (``mt_kernel_tables``): the 19 non-zero factors of
each row (``mt_lean_table``) for its exact test, and each leaf's
tensor-core operand in fragment order (``mt_frag_table``) for the TF32
filter that every pending leaf of a warp's leaf step goes through first,
once for the lanes that share it; the filter only rejects pairs whose
sign tests must fail
(``mt_filter_rejects``), and the exact test's 19 products give the 40
terms' values (``mt_lean_hit_t``).

Every wrapper of K1, K2, K7, K8, K10 and K11 reads its kernel's fault
flag after the launch and raises on it. Inside ``deferred_flags`` (the
capture of ``render_frame_batch``'s sample) it ORs the flag into a batch
flag on the card instead, which ``raise_on_flags`` reads once, after the
replays.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel.sweep import (
    _DET_EPS,
    _PAIR_BUDGET,
    CHUNK,
    GROUP,
    MAX_DISTANCE,
    mt_hit_t,
)
from pupiloptixlab_tpu_torch.accel.sweep import plain_sweep_anyhit as plain_anyhit
from pupiloptixlab_tpu_torch.accel.sweep import plain_sweep_closest as plain_closest

STACK_SIZE = 128  # per-thread traversal stack of the CUDA kernels (the reference's)
COUNT_TILE = 1024  # rays per K11 count tile (the reference's rb = 8 tile of 8 x 128)


def stack_fits(depth: int) -> bool:
    """The kernels pop one node and push up to eight children per level,
    so a tree of ``depth`` levels needs at most 7 * depth + 1 entries:
    depth 18 fits, 19 does not."""
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
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {label} must be contiguous 16-byte aligned {dt} "
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


KERNEL_TCLS = (16, 32, 64, 128)  # leaf sizes K1/K2/K11 are compiled for


def _check_baked_subleaf(name, tri, subleaf_rows, subleaf_boxes, tcl):
    """The sub-leaf table of a baked tree (``make_baked_subleaf``): (T,)
    uint8 leaf-local row order and (T / tcl * 8, 8) float32 group boxes,
    contiguous, on the table's device, 16-byte aligned (the kernels read
    them in 16-byte vectors)."""
    t_rows = tri.shape[0]
    if tcl not in KERNEL_TCLS or t_rows % tcl:
        raise ValueError(f"{name}: leaf size {tcl} over {t_rows} rows has no kernel "
                         f"(compiled for leaves of {KERNEL_TCLS} rows)")
    for label, t, dt, shape in (("subleaf_rows", subleaf_rows, torch.uint8, (t_rows,)),
                                ("subleaf_boxes", subleaf_boxes, torch.float32,
                                 (t_rows // tcl * SUBLEAF_GROUPS, 8))):
        if (t.device != tri.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {label} must be contiguous 16-byte aligned {dt} "
                             f"{shape} on {tri.device} (make_baked_subleaf of {t_rows} rows "
                             f"in leaves of {tcl}), got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


# the kernels that raise a fault flag, each a slot of the deferred batch flag
FLAGGED = ("bvh_closest", "bvh_closest_count", "bvh_anyhit", "bvh_closest_inst",
           "bvh_anyhit_inst", "bvh_closest_mt")
_deferred = None  # the (len(FLAGGED),) int32 batch flag inside deferred_flags


def _fault_text(name, code):
    return (f"{name}: traversal fault flag {code} (1 = visit cap exceeded, 2 = stack "
            "overflow, 4 = a leaf start off the leaf grid)")


@contextlib.contextmanager
def deferred_flags(device):
    """Inside: each traversal wrapper ORs its fault flag into its kernel's
    slot (``FLAGGED``) of one int32 tensor on ``device``, in a kernel of
    the stream, instead of reading it on the host, which a stream being
    captured into a CUDA graph forbids. The tensor is made and zeroed here,
    once, outside any graph, so a fault in any replay survives every later
    one. Yields it; ``raise_on_flags`` reads it once, at the end."""
    global _deferred
    flags = torch.zeros(len(FLAGGED), dtype=torch.int32, device=device)
    _deferred = flags
    try:
        yield flags
    finally:
        _deferred = None


def raise_on_flags(flags):
    """One read of a deferred batch flag: raises naming every kernel whose
    slot is set, with ``_raise_on_flag``'s text."""
    faults = [_fault_text(name, code) for name, code in zip(FLAGGED, flags.tolist()) if code]
    if faults:
        raise RuntimeError("; ".join(faults))


def _raise_on_flag(name, err):
    if _deferred is not None:
        slot = FLAGGED.index(name)
        _deferred[slot:slot + 1].bitwise_or_(err)
        return
    code = int(err.item())
    if code:
        raise RuntimeError(_fault_text(name, code))


def bvh_closest(rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                tri, bvh_child, bvh_axis, bvh_boxes, subleaf_rows, subleaf_boxes,
                tcl: int = 16, depth: int = 1, count_iters: bool = False):
    """Closest-hit traversal over ray planes; returns (t, idx) with
    (1e16, -1) on a miss. ``subleaf_rows`` / ``subleaf_boxes``: the tree's
    sub-leaf table (``make_baked_subleaf``, ``TriSoup``'s fields). ``depth``:
    the tree depth the flatten records (checked against the kernel's
    stack). With ``count_iters`` (K11; N a multiple of 1024) it returns (t,
    idx, counts): the same t and idx, and per tile of 1024 rays the (N /
    1024, 2) int32 sums [pops, leaves]."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    _check_baked_subleaf("bvh_closest", tri, subleaf_rows, subleaf_boxes, tcl)
    if count_iters:
        return _closest_count(planes, tri, bvh_child, bvh_axis, bvh_boxes, subleaf_rows,
                              subleaf_boxes, tcl, depth)
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
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), subleaf_rows.data_ptr(),
            subleaf_boxes.data_ptr(), n, tri.shape[0], tcl, n_nodes, t_out.data_ptr(),
            i_out.data_ptr(), err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_closest")
    _raise_on_flag("bvh_closest", err)
    return t_out, i_out


def _closest_count(planes, tri, bvh_child, bvh_axis, bvh_boxes, subleaf_rows,
                   subleaf_boxes, tcl, depth):
    """K11 (``bvh_closest(count_iters=True)``): K1 with per-tile counts."""
    n = planes[0].shape[0]
    if n % COUNT_TILE:
        raise ValueError(f"bvh_closest(count_iters=True): N = {n} is not a multiple "
                         f"of the {COUNT_TILE}-ray count tile")
    tabs = (tri, bvh_child, bvh_axis, bvh_boxes, subleaf_rows, subleaf_boxes)
    if tri.device.type == "cpu":
        return plain_closest_counts(*planes, *tabs, tcl)
    n, n_nodes = _check_args("bvh_closest_count", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    t_out = torch.empty(n, dtype=torch.float32, device=tri.device)
    i_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    counts = torch.zeros((n // COUNT_TILE, 2), dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_closest_count")
    kernels.LAUNCHES["bvh_closest_count"] += 1
    rc = fn(*(p.data_ptr() for p in planes), *(t.data_ptr() for t in tabs), n, tri.shape[0],
            tcl, n_nodes, t_out.data_ptr(), i_out.data_ptr(), counts.data_ptr(),
            err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_closest_count")
    _raise_on_flag("bvh_closest_count", err)
    return t_out, i_out, counts


def bvh_anyhit(rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
               tri, bvh_child, bvh_axis, bvh_boxes, subleaf_rows, subleaf_boxes,
               tcl: int = 16, depth: int = 1):
    """Occlusion-only traversal; returns (N,) int32 (1 = occluded). The
    sub-leaf table as for ``bvh_closest``."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    _check_baked_subleaf("bvh_anyhit", tri, subleaf_rows, subleaf_boxes, tcl)
    if tri.device.type == "cpu":
        return plain_anyhit(*planes, tri)
    n, n_nodes = _check_args("bvh_anyhit", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    occ = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_anyhit")
    kernels.LAUNCHES["bvh_anyhit"] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), bvh_child.data_ptr(),
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), subleaf_rows.data_ptr(),
            subleaf_boxes.data_ptr(), n, tri.shape[0], tcl, n_nodes, occ.data_ptr(),
            err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_anyhit")
    _raise_on_flag("bvh_anyhit", err)
    return occ


def _safe_inv(d):
    """sign(d) / max(|d|, 1e-12), the sign of 0 taken as +1 (ray_tests.cuh)."""
    one = torch.ones_like(d)
    return torch.where(d < 0.0, -one, one) / torch.clamp(torch.abs(d), min=1e-12)


def _slab(box, o, d, inv, tmin, tfar):
    """The slab test of ray_tests.cuh on (m, 8, 8) box rows: whether each
    box passes (tn <= tf) and its entry distance tn. An axis of exactly
    zero direction bounds nothing, and the box fails when the origin lies
    outside its span on that axis (faces included)."""
    t0, t1 = [], []
    outside = torch.zeros(box.shape[:-1], dtype=torch.bool, device=box.device)
    for k in range(3):
        lo, hi = box[..., k], box[..., k + 3]
        zero = d[k] == 0.0
        t0.append(torch.where(zero, -torch.inf, (lo - o[k]) * inv[k]))
        t1.append(torch.where(zero, torch.inf, (hi - o[k]) * inv[k]))
        outside |= zero & ((o[k] < lo) | (o[k] > hi))
    tn = torch.fmax(torch.fmax(torch.fmin(t0[0], t1[0]), torch.fmin(t0[1], t1[1])),
                    torch.fmax(torch.fmin(t0[2], t1[2]), tmin))
    tf = torch.fmin(torch.fmin(torch.fmax(t0[0], t1[0]), torch.fmax(t0[1], t1[1])),
                    torch.fmin(torch.fmax(t0[2], t1[2]), tfar))
    return ~outside & (tn <= tf), tn


def group_slab(box, o, d, inv, tmin, tfar):
    """The kernels' slab test of a baked tree's sub-leaf group boxes
    (csrc/bvh_traverse.cu group_slab), operation for operation: the entry
    and exit distances of the axes with a nonzero direction component,
    widened by the relative slack s = ``SUBLEAF_SLACK`` before their clamps
    (tn * (1 - s) where tn >= 0, tn * (1 + s) below; the exit the other
    way), then clamped by tmin and ``tfar``; an axis with a zero component
    fails the box when the origin lies outside its span widened by s times
    max(|tn|, |tf|) times the direction's largest component. Returns
    (passes, tn)."""
    t0, t1, zero = [], [], []
    for k in range(3):
        z = d[k] == 0.0
        t0.append(torch.where(z, -torch.inf, (box[..., k] - o[k]) * inv[k]))
        t1.append(torch.where(z, torch.inf, (box[..., k + 3] - o[k]) * inv[k]))
        zero.append(z)
    tn = torch.fmax(torch.fmax(torch.fmin(t0[0], t1[0]), torch.fmin(t0[1], t1[1])),
                    torch.fmin(t0[2], t1[2]))
    tf = torch.fmin(torch.fmin(torch.fmax(t0[0], t1[0]), torch.fmax(t0[1], t1[1])),
                    torch.fmax(t0[2], t1[2]))
    dmax = torch.fmax(torch.fmax(torch.abs(d[0]), torch.abs(d[1])), torch.abs(d[2]))
    m = SUBLEAF_SLACK * torch.fmax(torch.abs(tn), torch.abs(tf)) * dmax
    outside = torch.zeros(box.shape[:-1], dtype=torch.bool, device=box.device)
    for k in range(3):
        outside |= zero[k] & ((o[k] < box[..., k] - m) | (o[k] > box[..., k + 3] + m))
    lo_s, hi_s = 1.0 - SUBLEAF_SLACK, 1.0 + SUBLEAF_SLACK
    tn = torch.fmax(tn * torch.where(tn >= 0.0, lo_s, hi_s), tmin)
    tf = torch.fmin(tf * torch.where(tf >= 0.0, hi_s, lo_s), tfar)
    return ~outside & (tn <= tf), tn


def _lowest(t, rows):
    """Per lane the lowest (t, row) of (m, k) candidates: the least t, then
    the least row among those at that t."""
    tj = t.min(dim=1).values
    rj = torch.where(t == tj[:, None], rows, torch.iinfo(torch.int32).max).min(dim=1).values
    return tj, rj


def tree_walk(rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
              tri, bvh_child, bvh_axis, bvh_boxes, subleaf_rows, subleaf_boxes,
              tcl: int = 16) -> dict:
    """K1's traversal in PyTorch, every ray walking its own stack, the rays
    stepping in lockstep: each step pops one entry of every ray whose
    stack is not empty. A step counts an inner entry (id >= 0) as a pop,
    pruned or not; drops the entry when its t exceeds the ray's best t;
    takes a leaf through its sub-leaf groups (``group_slab`` against
    min(best t, tmax) at the leaf's entry, then the passing groups nearest
    entry first, the lower group on equal entry, until the nearest left
    starts beyond the best t, each group's rows through ``mt_hit_t``,
    keeping the lowest (t, row)); or slab-tests the node's 8 child boxes
    against min(best t, tmax) and pushes those that pass far-to-near by the
    ray's sign on the node's split axis. The stack holds ``STACK_SIZE``
    (id, entry t) pairs, as the kernels' does.

    Returns {"t", "idx"} as K1's, the (N,) int32 counts of each ray
    {"pops", "leaves", "groups", "rows"} (groups entered, rows tested) and
    "deepest", the deepest stack any ray reached. Raises where the kernel
    would set its fault flag (stack overflow, visit cap)."""
    n = rox.shape[0]
    dev = rox.device
    n_nodes = bvh_axis.shape[0]
    t_rows = tri.shape[0]
    gr = tcl // SUBLEAF_GROUPS
    tbest = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    ibest = torch.full((n,), -1, dtype=torch.int32, device=dev)
    count = {k: torch.zeros(n, dtype=torch.int32, device=dev)
             for k in ("pops", "leaves", "groups", "rows")}
    visits = torch.zeros(n, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int32, device=dev)
    stack_tn = torch.zeros((n, STACK_SIZE), dtype=torch.float32, device=dev)
    stack_tn[:, 0] = tmin
    sp = (tmax > tmin).to(torch.int64)  # the root, for live lanes only
    deepest = int(sp.max()) if n else 0
    o = (rox, roy, roz)
    d = (rdx, rdy, rdz)
    inv = [_safe_inv(x) for x in d]
    push = torch.arange(8, device=dev)
    in_group = torch.arange(gr, device=dev)
    cols = [tri[:, k] for k in range(9)]
    order = subleaf_rows.to(torch.int64)
    group_boxes = subleaf_boxes.reshape(-1, SUBLEAF_GROUPS, 8)
    active = torch.nonzero(sp > 0).squeeze(1)
    while active.numel():
        sp[active] -= 1
        top = sp[active]
        ids = stack[active, top]
        tn_e = stack_tn[active, top]
        visits[active] += 1
        if bool((visits[active] > n_nodes * 8 + 1).any()):
            raise RuntimeError("tree_walk: visit cap exceeded")
        inner = ids >= 0
        count["pops"][active] += inner.to(torch.int32)
        kept = ~(tn_e > tbest[active])  # the kernel's prune test, negated

        leaf = ~inner & kept
        if bool(leaf.any()):
            lanes = active[leaf]
            count["leaves"][lanes] += 1
            start = torch.clamp(-(ids[leaf] + 1), 0, t_rows - tcl).to(torch.int64)
            if bool((start % tcl != 0).any()):
                raise RuntimeError("tree_walk: a leaf start off the leaf grid")
            ray = [a[lanes][:, None] for a in (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)]
            ok, gtn = group_slab(group_boxes[start // tcl], ray[0:3], ray[3:6],
                                 [x[lanes][:, None] for x in inv], ray[6],
                                 torch.fmin(tbest[lanes], tmax[lanes])[:, None])
            todo = ok
            for _ in range(SUBLEAF_GROUPS):
                ts, gs = torch.min(torch.where(todo, gtn, torch.inf), dim=1)  # first minimum
                go = todo.any(dim=1) & ~(ts > tbest[lanes])
                todo = todo & go[:, None]
                if not bool(go.any()):
                    break
                todo[go, gs[go]] = False
                g_lanes = lanes[go]
                count["groups"][g_lanes] += 1
                count["rows"][g_lanes] += gr
                slot = start[go, None] + gs[go, None] * gr + in_group[None, :]  # (m, gr)
                rows = start[go, None] + order[slot]
                t = mt_hit_t(*[x[go] for x in ray], [c[rows] for c in cols])
                tj, rj = _lowest(t, rows.to(torch.int32))
                tb, ib = tbest[g_lanes], ibest[g_lanes]
                better = (tj < MAX_DISTANCE) & ((tj < tb) | ((tj == tb) & (rj < ib)))
                tbest[g_lanes] = torch.where(better, tj, tb)
                ibest[g_lanes] = torch.where(better, rj, ib)

        node = inner & kept
        if bool(node.any()):
            lanes = active[node]
            nid = ids[node].to(torch.int64)
            ax = bvh_axis[nid].to(torch.int64)
            dsel = torch.stack([x[lanes] for x in d], 1).gather(1, ax[:, None]).squeeze(1)
            fwd = dsel >= 0.0
            # push order: children ascend along the axis, so a forward ray
            # pushes 7..0 and pops the near child 0 first
            kk = torch.where(fwd[:, None], 7 - push[None, :], push[None, :])  # (m, 8)
            slot = nid[:, None] * 8 + kk
            tfar = torch.fmin(tbest[lanes], tmax[lanes])[:, None]
            ok, tn = _slab(bvh_boxes[slot], [x[lanes][:, None] for x in o],
                           [x[lanes][:, None] for x in d], [x[lanes][:, None] for x in inv],
                           tmin[lanes][:, None], tfar)
            pos = sp[lanes][:, None] + torch.cumsum(ok, dim=1) - 1
            if bool((pos[ok] >= STACK_SIZE).any()):
                raise RuntimeError(f"tree_walk: stack overflow (more than {STACK_SIZE} entries)")
            r_idx = lanes[:, None].expand_as(pos)[ok]
            stack[r_idx, pos[ok]] = bvh_child[slot[ok]]
            stack_tn[r_idx, pos[ok]] = tn[ok]
            sp[lanes] += ok.sum(dim=1)
            deepest = max(deepest, int(sp[lanes].max()))
        active = active[sp[active] > 0]
    return {"t": tbest, "idx": ibest, **count, "deepest": deepest}


def plain_closest_counts(rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                         tri, bvh_child, bvh_axis, bvh_boxes, subleaf_rows, subleaf_boxes,
                         tcl: int = 16):
    """Plain version of K11: ``tree_walk``'s (t, idx) and its counts summed
    over each tile of 1024 rays, (N / 1024, 2) int32 [pops, leaves]."""
    w = tree_walk(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, bvh_child, bvh_axis,
                  bvh_boxes, subleaf_rows, subleaf_boxes, tcl)
    per_ray = torch.stack([w["pops"], w["leaves"]], 1).to(torch.int64)
    return w["t"], w["idx"], per_ray.reshape(-1, COUNT_TILE, 2).sum(dim=1).to(torch.int32)


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


SUBLEAF_GROUPS = 8        # group boxes a leaf: baked (K1/K2/K11) and unique (K7/K8)
SUBLEAF_PAD = 2.0 ** -13  # a group box's outward margin over its largest |coordinate|
SCENE_PAD = 2.0 ** -19    # and, on a baked tree, over the table's largest |coordinate|
SUBLEAF_SLACK = 2.0 ** -13  # relative slack of a baked group's slab test (group_slab)
_NEVER = 1e30             # the never-box of accel/bvh.py: a point at 1e30


def _live_rows(p):
    """Rows whose e1 and e2 are both nonzero; the others (the flatten's
    padding, hidden rows) have det exactly 0 and never pass
    Moller-Trumbore."""
    return (p[:, 3:6] != 0).any(1) & (p[:, 6:9] != 0).any(1)


def _tight_bounds(verts, live, gr: int):
    """(lo, hi, some) of groups of ``gr`` consecutive rows: the float64
    bounds (G, 3) of the vertices (G * gr, 3, 3) of their live rows (+-inf
    without one) and whether a group holds one (G, 1)."""
    lo = torch.where(live[:, None], verts.amin(1), torch.inf).reshape(-1, gr, 3).amin(1)
    hi = torch.where(live[:, None], verts.amax(1), -torch.inf).reshape(-1, gr, 3).amax(1)
    return lo, hi, live.reshape(-1, gr).any(1)[:, None]


def _group_boxes(verts, live, gr: int, extra_pad, device):
    """(G, 8) float32 boxes [lox loy loz hix hiy hiz 0 0] over the vertices
    (G * gr, 3, 3) float64 of live rows, ``gr`` consecutive rows a group,
    padded by ``_pad_boxes``."""
    return _pad_boxes(*_tight_bounds(verts, live, gr), extra_pad, device)


def _pad_boxes(lo, hi, some, extra_pad, device):
    """(G, 8) float32 boxes from float64 bounds (G, 3): widened on every
    axis by ``SUBLEAF_PAD`` times the box's largest |coordinate| plus
    ``extra_pad`` and rounded outward to float32; a box without a live row
    (``some`` False) gets the never-box."""
    pad = SUBLEAF_PAD * torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True) + extra_pad
    lo, hi = lo - pad, hi + pad
    lo32, hi32 = lo.to(torch.float32), hi.to(torch.float32)
    inf = torch.full_like(lo32, torch.inf)
    lo32 = torch.where(lo32.to(torch.float64) > lo, torch.nextafter(lo32, -inf), lo32)
    hi32 = torch.where(hi32.to(torch.float64) < hi, torch.nextafter(hi32, inf), hi32)
    boxes = torch.zeros((lo.shape[0], 8), dtype=torch.float32, device=device)
    boxes[:, 0:3] = torch.where(some, lo32, _NEVER)
    boxes[:, 3:6] = torch.where(some, hi32, _NEVER)
    return boxes


def _vertices(p):
    """(T, 3 vertices, 3) float64: p0, p0 + e1, p0 + e2 of (T, >= 9) rows."""
    p0, e1, e2 = p[:, 0:3], p[:, 3:6], p[:, 6:9]
    return torch.stack([p0, p0 + e1, p0 + e2], 1)


def make_subleaf_boxes(packed, tcl: int):
    """K7/K8's sub-leaf level: (T / tcl * 8, 8) float32 boxes [lox loy loz
    hix hiy hiz 0 0] (the layout of ``bvh_boxes``) in OBJECT space, on
    ``packed``'s device. Unique leaf u (rows [u * tcl, (u + 1) * tcl))
    splits into 8 groups of tcl / 8 consecutive rows (Morton-ordered by the
    flatten, so a group is compact); box u * 8 + g bounds the vertices p0,
    p0 + e1, p0 + e2 of group g's rows, in float64, widened on every axis
    by ``SUBLEAF_PAD`` times the box's largest |coordinate| and rounded
    outward to float32. A row whose e1 or e2 is zero (the flatten's
    padding rows are all zero) can never pass Moller-Trumbore (its det is
    exactly 0) and is left out; a group of such rows alone gets the
    never-box.

    The margin keeps the slab test from dropping a group that holds a row
    Moller-Trumbore accepts: a slab entry or exit t of a box coordinate c
    rounds by ~2e-7 relative, i.e. ~2e-7 |c - o| in space, which the
    margin (1.2e-4 |c|) covers for object-space origins up to ~600 box
    radii away, and it covers a hit that Moller-Trumbore's rounding puts
    just outside its triangle. ``tests/test_torch_inst_subleaf.py`` holds
    it on rays along box faces and rays with zero direction components."""
    t_rows = packed.shape[0]
    if tcl % SUBLEAF_GROUPS or t_rows % tcl:
        raise ValueError(f"make_subleaf_boxes: {t_rows} rows in leaves of {tcl} do not "
                         f"split into {SUBLEAF_GROUPS} groups a leaf")
    p = packed[:, 0:9].to(torch.float64)
    return _group_boxes(_vertices(p), _live_rows(p), tcl // SUBLEAF_GROUPS, 0.0,
                        packed.device)


def _split_segments(seg, cnt, cen):
    """One level of the sub-leaf split: each segment (L, S, C) of row
    indices, whose first ``cnt`` (L, S) entries are live rows and the rest
    dead ones, is sorted by the live rows' centroids along their widest
    axis (stable; dead rows last, in their order) and cut into two
    segments of C / 2: the left takes the first min(C / 2, ceil(cnt / 2))
    live rows, the right the rest, each filled up with dead rows."""
    c_len = seg.shape[2]
    half = c_len // 2
    c = cen[seg]                                                   # (L, S, C, 3)
    slot_live = torch.arange(c_len, device=seg.device) < cnt[..., None]
    hi = torch.where(slot_live[..., None], c, -torch.inf).amax(2)
    lo = torch.where(slot_live[..., None], c, torch.inf).amin(2)
    ext = torch.where(cnt[..., None] > 0, hi - lo, 0.0)
    ax = torch.argmax(ext, dim=-1)                                 # first widest axis
    key = c.gather(3, ax[..., None, None].expand(*seg.shape, 1)).squeeze(3)
    key = torch.where(slot_live, key, torch.inf)
    seg = seg.gather(2, torch.sort(key, dim=2, stable=True).indices)
    nl = torch.clamp((cnt + 1) // 2, max=half)
    j = torch.arange(half, device=seg.device)
    left = torch.where(j < nl[..., None], j, cnt[..., None] + j - nl[..., None])
    right = torch.where(j < (cnt - nl)[..., None], nl[..., None] + j, half + j)
    seg = torch.stack([seg.gather(2, left), seg.gather(2, right)], 2)
    return seg.reshape(seg.shape[0], -1, half), torch.stack([nl, cnt - nl], 2).reshape(
        cnt.shape[0], -1)


def make_baked_subleaf(packed, tcl: int):
    """The sub-leaf table of a baked tree (the port's own, not the
    reference's) on ``packed``'s device: (rows, boxes).

    ``rows`` (T,) uint8: the leaf-local order of each leaf's rows. Leaf l
    (rows [l * tcl, (l + 1) * tcl), a tree leaf of accel/bvh.py) splits its
    live rows (``_live_rows``; the others go last) into
    ``SUBLEAF_GROUPS`` (8) groups by three levels of median splits
    (``_split_segments``) on the centroids
    p0 + (e1 + e2) / 3 (taken as 3 p0 + e1 + e2 in float64) along the
    widest axis of the segment's live centroids; with G = ``SUBLEAF_GROUPS``
    group g of leaf l is rows l * tcl + rows[l * tcl + g * tcl / G + j],
    j < tcl / G.

    ``boxes`` (T / tcl * G, 8) float32, ``bvh_boxes``' layout: group g's
    world box over its live rows' vertices (``baked_subleaf_boxes``).
    Needs tcl a multiple of G up to 256."""
    t_rows = packed.shape[0]
    if tcl % SUBLEAF_GROUPS or t_rows % tcl or not 0 < tcl <= 256:
        raise ValueError(f"make_baked_subleaf: {t_rows} rows in leaves of {tcl} do not "
                         f"split into {SUBLEAF_GROUPS} groups a leaf of at most 256 rows")
    p = packed[:, 0:9].to(torch.float64)
    live = _live_rows(p)
    cen = 3.0 * p[:, 0:3] + p[:, 3:6] + p[:, 6:9]
    n_leaves = t_rows // tcl
    base = torch.arange(n_leaves, device=packed.device)[:, None] * tcl
    # live rows first, in row order, then the dead ones
    first = torch.sort((~live).reshape(n_leaves, tcl).to(torch.int8), dim=1,
                       stable=True).indices
    seg = (base + first)[:, None, :]
    cnt = live.reshape(n_leaves, 1, tcl).sum(2)
    for _ in range(SUBLEAF_GROUPS.bit_length() - 1):
        seg, cnt = _split_segments(seg, cnt, cen)
    rows = (seg.reshape(n_leaves, tcl) - base).reshape(-1).to(torch.uint8)
    return rows, baked_subleaf_boxes(packed, rows, tcl)


def baked_subleaf_boxes(packed, rows, tcl: int):
    """The group boxes of ``make_baked_subleaf`` for the leaf-local order
    ``rows``, from the rows of ``packed`` as they are now (the baked refit
    keeps the order and rebuilds the boxes from the moved rows). Each box
    bounds its live rows' vertices in float64, is widened on every axis by
    ``SUBLEAF_PAD`` times its largest |coordinate| plus ``SCENE_PAD`` times
    the largest |coordinate| of the table's live vertices, and is rounded
    outward to float32; a group without a live row gets the never-box.

    Soundness: a hit that Moller-Trumbore accepts must lie in a group whose
    box the ray enters (``group_slab``) no later than the hit. A slab t of
    a box coordinate c rounds by ~3 ulp relative (~2e-7 |c - o| in space),
    and Moller-Trumbore's own rounding can put an accepted hit outside its
    triangle by a few ulp of |o - p0| / sin(angle). Both scale with the
    distance from the origin: the slack of ``group_slab`` (2^-13, ~2,000
    ulp, on t, and on the span of an axis with a zero direction component
    relative to the distance along the ray) covers them from any distance;
    the spatial margin (2^-19 of the scene's extent, 2^-13 of the box's
    own) covers rays nearly parallel to a box face (whose t on that axis is
    huge) for origins within the scene's extent of the box.
    ``tests/test_torch_bvh_subleaf.py`` holds it on far origins, groups
    near the origin, face rays and zero-direction rays."""
    gr = tcl // SUBLEAF_GROUPS
    p = packed[:, 0:9].to(torch.float64)
    live = _live_rows(p)
    verts = _vertices(p)
    extent = float(torch.where(live[:, None, None], verts.abs(), 0.0).max()) if len(p) else 0.0
    base = torch.arange(p.shape[0], device=p.device) // tcl * tcl
    grouped = base + rows.to(torch.int64)  # table row of each slot, in group order
    return _group_boxes(verts[grouped], live[grouped], gr, SCENE_PAD * extent, packed.device)


def sweep_boxes(packed):
    """The chunk sweep's box table (K5/K6, csrc/sweep.cu) on ``packed``'s
    device: (C + G, 8) float32 boxes [lox loy loz hix hiy hiz 0 0], the C =
    T / ``CHUNK`` chunk boxes, then, when C > ``GROUP``, the G = ceil(C /
    ``GROUP``) super-boxes of ``GROUP`` chunks each (none otherwise). Each
    bounds its live rows' vertices in float64 and is padded as the baked
    sub-leaf groups are (``baked_subleaf_boxes``: ``SUBLEAF_PAD`` of its
    largest |coordinate| plus ``SCENE_PAD`` of the table's, rounded outward
    to float32), so that ``group_slab`` never drops a chunk that holds an
    accepted hit; a box without a live row gets the never-box. The kernels
    test these boxes as they are; ``tests/test_torch_sweep_rows.py`` holds
    them on far, face, grazing and zero-direction rays. Nothing here reads
    the device back (a ring rank builds its shard's on the card)."""
    t_rows = packed.shape[0]
    if t_rows == 0 or t_rows % CHUNK:
        raise ValueError(f"sweep_boxes: {t_rows} rows are not whole chunks of {CHUNK}")
    p = packed[:, 0:9].to(torch.float64)
    live = _live_rows(p)
    verts = _vertices(p)
    pad = SCENE_PAD * torch.where(live[:, None, None], verts.abs(), 0.0).amax()
    lo, hi, some = _tight_bounds(verts, live, CHUNK)
    n_chunks = t_rows // CHUNK
    if n_chunks > GROUP:  # a group's bounds are its chunks' (none past the last)
        extra = -n_chunks % GROUP
        lo = torch.cat([lo, torch.cat([lo, lo.new_full((extra, 3), torch.inf)])
                        .reshape(-1, GROUP, 3).amin(1)])
        hi = torch.cat([hi, torch.cat([hi, hi.new_full((extra, 3), -torch.inf)])
                        .reshape(-1, GROUP, 3).amax(1)])
        some = torch.cat([some, torch.cat([some, some.new_zeros((extra, 1))])
                          .reshape(-1, GROUP).any(1)[:, None]])
    return _pad_boxes(lo, hi, some, pad, packed.device)


def sweep_table(packed, bvh_nodes: int):
    """``TriSoup.sweep_boxes`` for a flattened table: ``sweep_boxes`` on the
    chunk sweep's route (no tree), a (0, 8) placeholder on a tree's."""
    if bvh_nodes > 0:
        return torch.zeros((0, 8), dtype=torch.float32, device=packed.device)
    return sweep_boxes(packed)


def subleaf_table(packed, tcl: int, bvh_nodes: int, instanced: bool):
    """``TriSoup``'s (subleaf_rows, subleaf_boxes) for a flattened table:
    on instanced tables a (1,) placeholder and ``make_subleaf_boxes``; on a
    baked tree ``make_baked_subleaf`` (leaf sizes beyond its reach keep
    placeholders, on which the kernels' wrappers raise); without a tree
    (the chunk sweep) placeholders."""
    dev = packed.device
    none_rows = torch.zeros(1, dtype=torch.uint8, device=dev)
    if instanced:
        return none_rows, make_subleaf_boxes(packed, tcl)
    if bvh_nodes > 0 and tcl % SUBLEAF_GROUPS == 0 and 0 < tcl <= 256:
        return make_baked_subleaf(packed, tcl)
    return none_rows, torch.zeros((1, 8), dtype=torch.float32, device=dev)


def _check_subleaf(name, tri, subleaf_boxes, tcl):
    want = (tri.shape[0] // tcl * SUBLEAF_GROUPS, 8)
    if (tcl % SUBLEAF_GROUPS or tri.shape[0] % tcl or subleaf_boxes.device != tri.device
            or subleaf_boxes.dtype != torch.float32 or tuple(subleaf_boxes.shape) != want
            or not subleaf_boxes.is_contiguous()):
        raise ValueError(f"{name}: subleaf_boxes must be contiguous float32 {want} on "
                         f"{tri.device} (make_subleaf_boxes of {tri.shape[0]} rows in leaves "
                         f"of {tcl}), got {subleaf_boxes.dtype} "
                         f"{tuple(subleaf_boxes.shape)} on {subleaf_boxes.device}")


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
                     bvh_boxes, leaf_start, leaf_inst, inst_w2o, subleaf_boxes,
                     tcl: int = 32, depth: int = 1):
    """Instanced closest-hit traversal; returns (t, unique row, world leaf)
    with (1e16, -1, -1) on a miss. ``leaf_inst[leaf]`` is the instance;
    ``subleaf_boxes`` is ``make_subleaf_boxes(tri, tcl)`` (the kernel tests
    only the rows of the groups whose boxes the object ray enters; the plain
    scan, which tests every row, does not read it)."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if tri.device.type == "cpu":
        return plain_closest_inst(*planes, tri, leaf_start, leaf_inst, inst_w2o, tcl=tcl)
    n, n_nodes = _check_args("bvh_closest_inst", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    n_leaves = _check_inst("bvh_closest_inst", tri, leaf_start, leaf_inst, inst_w2o)
    _check_subleaf("bvh_closest_inst", tri, subleaf_boxes, tcl)
    t_out = torch.empty(n, dtype=torch.float32, device=tri.device)
    i_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    l_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_closest_inst")
    kernels.LAUNCHES["bvh_closest_inst"] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), bvh_child.data_ptr(),
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), leaf_start.data_ptr(),
            leaf_inst.data_ptr(), inst_w2o.data_ptr(), subleaf_boxes.data_ptr(), n,
            tri.shape[0], tcl, n_nodes, n_leaves, t_out.data_ptr(), i_out.data_ptr(),
            l_out.data_ptr(), err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_closest_inst")
    _raise_on_flag("bvh_closest_inst", err)
    return t_out, i_out, l_out


def bvh_anyhit_inst(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, bvh_child, bvh_axis,
                    bvh_boxes, leaf_start, leaf_inst, inst_w2o, subleaf_boxes,
                    tcl: int = 32, depth: int = 1):
    """Instanced occlusion-only traversal; returns (N,) int32 (1 = occluded).
    ``subleaf_boxes`` as for ``bvh_closest_inst``."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if tri.device.type == "cpu":
        return plain_anyhit_inst(*planes, tri, leaf_start, leaf_inst, inst_w2o, tcl=tcl)
    n, n_nodes = _check_args("bvh_anyhit_inst", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    n_leaves = _check_inst("bvh_anyhit_inst", tri, leaf_start, leaf_inst, inst_w2o)
    _check_subleaf("bvh_anyhit_inst", tri, subleaf_boxes, tcl)
    occ = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_anyhit_inst")
    kernels.LAUNCHES["bvh_anyhit_inst"] += 1
    rc = fn(*(p.data_ptr() for p in planes), tri.data_ptr(), bvh_child.data_ptr(),
            bvh_axis.data_ptr(), bvh_boxes.data_ptr(), leaf_start.data_ptr(),
            leaf_inst.data_ptr(), inst_w2o.data_ptr(), subleaf_boxes.data_ptr(), n,
            tri.shape[0], tcl, n_nodes, n_leaves, occ.data_ptr(), err.data_ptr(),
            kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_anyhit_inst")
    _raise_on_flag("bvh_anyhit_inst", err)
    return occ


MT_TCL = 32  # rows per leaf of the linear-form table (one 128-lane slice on the TPU)


def _cross(a, b):
    """Component planes of a x b, each as a1*b2 - a2*b1."""
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _mt_linear(tri, center):
    """(T, 4, 10) linear-form rows [det | u*det | v*det | t*det] of every
    triangle, recentred on ``center`` (see ``mt_cols_table``)."""
    p0 = [tri[:, k] - center[k] for k in range(3)]
    e1 = [tri[:, 3 + k] for k in range(3)]
    e2 = [tri[:, 6 + k] for k in range(3)]
    n = _cross(e1, e2)
    zero = torch.zeros_like(p0[0])
    p0n = p0[0] * n[0] + p0[1] * n[1] + p0[2] * n[2]
    g_det = [-n[0], -n[1], -n[2]] + [zero] * 7
    g_u = list(_cross(p0, e2)) + e2 + [zero] * 4
    g_v = [-c for c in _cross(p0, e1)] + [-c for c in e1] + [zero] * 4
    g_t = [zero] * 6 + list(n) + [-p0n]
    return torch.stack([torch.stack(g, 1) for g in (g_det, g_u, g_v, g_t)], 1)


def mt_center(tri):
    """The recentring point of the linear form: the mean of the rows' p0."""
    return tri[:, 0:3].mean(dim=0)


def mt_cols_table(tri, center):
    """(T, 12) rows -> the reference's (10, 4T) linear-form table
    (``_mt_cols_table``, pallas_bvh.py:259-295). With the ray's feature
    f = [d, (o - c) x d, o - c, 1] and N = e1 x e2, p0c = p0 - c:
        det     = f . [-N, 0, 0, 0]
        u * det = f . [p0c x e2, e2, 0, 0]
        v * det = f . [-(p0c x e1), -e1, 0, 0]
        t * det = f . [0, 0, N, -(p0c . N)]
    Columns are leaf-grouped: leaf L's 128 columns are [det x 32 | u x 32 |
    v x 32 | t x 32]. T must be a multiple of 32."""
    t = tri.shape[0]
    g = _mt_linear(tri, center)  # (T, 4, 10)
    g = g.reshape(t // MT_TCL, MT_TCL, 4, 10).permute(0, 2, 1, 3)
    return g.reshape(4 * t, 10).t().contiguous()


def mt_rows_table(tri, center):
    """The same numbers by row: (T, 40), row j holding [det(10) | u(10) |
    v(10) | t(10)] of triangle j, 160 B per row (the plain version's;
    K10 reads ``mt_lean_table`` and ``mt_frag_table``)."""
    return _mt_linear(tri, center).reshape(tri.shape[0], 40).contiguous()


_MT_TABLES: dict[int, dict] = {}  # id(tri) -> its linear-form tables, while tri lives


def _mt_kept(tri) -> dict:
    """The linear-form tables of one triangle table: its center and rows,
    made at the table's first query, then K10's lean and frag at the
    kernel's (``mt_kernel_tables``), all kept beside it until it is freed.
    Tables are never written in place (a refit builds new ones:
    flatten/refit.py), so the tensor's identity names its contents."""
    key = id(tri)
    kept = _MT_TABLES.get(key)
    if kept is None:
        center = mt_center(tri)
        kept = {"center": center, "rows": mt_rows_table(tri, center)}
        _MT_TABLES[key] = kept
        weakref.finalize(tri, _MT_TABLES.pop, key, None)
    return kept


def mt_tables(tri):
    """(``mt_rows_table``, ``mt_center``) of one triangle table (the plain
    version's), kept beside it (``_mt_kept``)."""
    kept = _mt_kept(tri)
    return kept["rows"], kept["center"]


MT_LEAN_COLS = (0, 1, 2, 10, 11, 12, 13, 14, 15, 20, 21, 22, 23, 24, 25, 36, 37, 38, 39)
MT_TC_ERR = 1.25 * 2.0 ** -10  # the filter's margin per |f[0:6]| |g| (mt_frag_table)


def mt_lean_table(rows):
    """(T, 20): each row's 19 non-zero linear-form factors (``MT_LEAN_COLS``
    of ``mt_rows_table`` ``rows``: det 0-2, u 0-5, v 0-5, t 6-9) and a
    zero, 80 B a row; the 21 others are structural zeros of ``_mt_linear``."""
    out = torch.zeros((rows.shape[0], 20), dtype=torch.float32, device=rows.device)
    out[:, :19] = rows[:, list(MT_LEAN_COLS)]
    return out


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: the PTX ``cvt.rna.tf32.f32`` K10 applies to the rays'
    features. Finite inputs."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (bits & torch.tensor(-2 ** 31, dtype=torch.int32))).view(torch.float32)


def mt_filter_factors(tri, center):
    """(q, G): q (T, 3, 8) the TF32 factors of u*det, v*det and w*det =
    (det - u - v)*det over features 0-7 (w from det, u and v in float64,
    then rounded), and G (T,) each row's margin factor MT_TC_ERR * (|g_det|
    + |g_u| + |g_v|), norms over the non-zero features, rounded up to
    float32. With a ray's rn >= |f[0:6]|, rn * G bounds the distance
    between a TF32 tensor-core product of q and the FP32 dot K10's exact
    test computes, for u*det, v*det and w*det alike: the TF32 roundings
    of both factors (2^-11 each, relative), the products' FP32 sum (within
    2^-18 of the terms' magnitudes) and the exact test's own roundings
    (its 10-term dots and det - u - v, 2^-20) come to 2^-10 * 1.006 of
    sum |f_k| |g_k| <= |f| |g|; G keeps 25% over that."""
    g = _mt_linear(tri, center).double()  # (T, 4, 10)
    w = g[:, 0, :8] - g[:, 1, :8] - g[:, 2, :8]
    q = torch.stack([tf32_round(g[:, 1, :8].float()), tf32_round(g[:, 2, :8].float()),
                     tf32_round(w.float())], 1)
    norm = (g[:, 0, :3].norm(dim=1) + g[:, 1, :6].norm(dim=1) + g[:, 2, :6].norm(dim=1))
    g64 = MT_TC_ERR * norm
    g32 = g64.float()
    g32 = torch.where(g32.double() < g64, torch.nextafter(g32, torch.full_like(g32, 3e38)),
                      g32)
    return q, g32


def mt_frag_table(tri, center):
    """(T / 32 * 256, 4) float32: K10's tensor-core operand of each 32-row
    leaf in fragment order, one 16-byte load a lane per entry. For leaf L,
    block b (rows 8b .. 8b + 7) and lane (g, t) = (lane // 4, lane % 4):
    entry ((L * 4 + b) * 2 + 0) * 32 + lane = [u(8b + g)[t], u(8b + g)[t + 4],
    v(8b + g)[t], v(8b + g)[t + 4]] and entry (.. + 1) * 32 + lane =
    [w(8b + g)[t], w(8b + g)[t + 4], G(8b + 2t), G(8b + 2t + 1)] (q and G of
    ``mt_filter_factors``): an m16n8k8 B fragment (k = feature, n = row)
    for each of u, v, w, and the margin factors of the rows whose products
    lane (g, t) holds."""
    t_rows = tri.shape[0]
    q, big_g = mt_filter_factors(tri, center)
    dev = tri.device
    lane = torch.arange(32, device=dev)
    gid, tq = lane // 4, lane % 4
    leaf = torch.arange(t_rows // MT_TCL, device=dev)[:, None, None]
    blk = torch.arange(4, device=dev)[None, :, None]
    row_b = leaf * MT_TCL + 8 * blk + gid  # (L, 4, 32): the B column's row
    row_g = leaf * MT_TCL + 8 * blk + 2 * tq  # the first of the lane's two rows
    half0 = torch.stack([q[row_b, 0, tq], q[row_b, 0, tq + 4],
                         q[row_b, 1, tq], q[row_b, 1, tq + 4]], -1)
    half1 = torch.stack([q[row_b, 2, tq], q[row_b, 2, tq + 4],
                         big_g[row_g], big_g[row_g + 1]], -1)
    return torch.stack([half0, half1], 2).reshape(-1, 4).contiguous()


def mt_kernel_tables(tri):
    """(``mt_lean_table``, ``mt_frag_table``, ``mt_center``) of one triangle
    table: K10's three tables, kept beside it (``_mt_kept``)."""
    kept = _mt_kept(tri)
    if "lean" not in kept:
        kept["lean"] = mt_lean_table(kept["rows"])
        kept["frag"] = mt_frag_table(tri, kept["center"])
    return kept["lean"], kept["frag"], kept["center"]


def _mt_features(rox, roy, roz, rdx, rdy, rdz, center):
    """The ray's 10 features [d, (o - c) x d, o - c, 1] as planes."""
    rc = (rox - center[0], roy - center[1], roz - center[2])
    d = (rdx, rdy, rdz)
    return [*d, *_cross(rc, d), *rc, torch.ones_like(rox)]


def mt_linear_hit_t(f, tmn, tmx, g):
    """t where a ray hits a row through the linear form, 1e16 elsewhere, on
    broadcast-compatible planes: ``f`` the 10 ray features, ``g`` the 40
    row columns. Each dot is summed left to right over its 10 terms, and
    the test is the reference's (pallas_bvh.py:660-689) with IEEE
    t = (t*det) / det. K10 repeats these operations in this order."""
    def dot(base):
        acc = f[0] * g[base]
        for k in range(1, 10):
            acc = acc + f[k] * g[base + k]
        return acc

    det, up, vp, tp = dot(0), dot(10), dot(20), dot(30)
    t = tp / torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det)
    ok = ((torch.abs(det) >= _DET_EPS) & (up * det >= 0.0) & (vp * det >= 0.0)
          & ((det - up - vp) * det >= 0.0) & (t > tmn) & (t < tmx))
    return torch.where(ok, t, MAX_DISTANCE)


def mt_lean_hit_t(f, tmn, tmx, lean):
    """``mt_linear_hit_t`` through the 19 non-zero products, as K10 computes
    it (csrc/bvh_traverse.cu lean_form): ``lean`` the 19 row columns of
    ``mt_lean_table``, each dot summed left to right over its non-zero
    terms. Equal to ``mt_linear_hit_t`` on finite features: the terms
    left out are signed zeros, which change a sum only where it is zero,
    and then only its sign."""
    def dot(fi, ci):
        acc = f[fi[0]] * lean[ci[0]]
        for a, b in zip(fi[1:], ci[1:]):
            acc = acc + f[a] * lean[b]
        return acc

    det = dot((0, 1, 2), (0, 1, 2))
    up = dot(range(6), range(3, 9))
    vp = dot(range(6), range(9, 15))
    tp = dot(range(6, 10), range(15, 19))
    t = tp / torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det)
    ok = ((torch.abs(det) >= _DET_EPS) & (up * det >= 0.0) & (vp * det >= 0.0)
          & ((det - up - vp) * det >= 0.0) & (t > tmn) & (t < tmx))
    return torch.where(ok, t, MAX_DISTANCE)


def mt_filter_rejects(u, v, w, rn, big_g):
    """K10's tensor-core filter on broadcast-compatible planes: ``u``, ``v``,
    ``w`` the products of u*det, v*det and w*det (as the tensor cores give
    them), ``rn`` the ray's margin factor (|f[0:6]| * (1 + 2^-20) in float32),
    ``big_g`` the row's (``mt_filter_factors``). A pair is rejected where
    one value exceeds M and another lies below -M, M = rn * G + 2^-100: a
    hit needs all three to share det's sign (they sum to det)."""
    m = (rn.double() * big_g.double() + 2.0 ** -100).float()
    hi = torch.maximum(torch.maximum(u, v), w)
    lo = torch.minimum(torch.minimum(u, v), w)
    return (hi > m) & (lo < -m)


def plain_closest_mt(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri):
    """Plain version of K10: the closest linear-form hit (t, row) of every
    ray over every row of ``tri``, in chunks of at most ``_PAIR_BUDGET``
    pairs; ties at equal t go to the lowest row, a miss is (1e16, -1)."""
    n = rox.shape[0]
    dev = rox.device
    tbest = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    ibest = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(tmax > tmin).squeeze(1)
    n_tris = tri.shape[0]
    if live.numel() == 0 or n_tris == 0:
        return tbest, ibest
    rows, center = mt_tables(tri)
    cols = [rows[:, k] for k in range(40)]
    r_chunk = max(min(live.numel(), _PAIR_BUDGET // 64), 1)
    for rs in range(0, live.numel(), r_chunk):
        lanes = live[rs:rs + r_chunk]
        ray = [a[lanes][:, None] for a in (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)]
        f = _mt_features(*ray[:6], center)
        bt = torch.full((lanes.numel(),), MAX_DISTANCE, dtype=torch.float32, device=dev)
        bi = torch.full((lanes.numel(),), -1, dtype=torch.int32, device=dev)
        t_chunk = max(_PAIR_BUDGET // lanes.numel(), 8)
        for ts in range(0, n_tris, t_chunk):
            t = mt_linear_hit_t(f, ray[6], ray[7], [c[ts:ts + t_chunk][None, :] for c in cols])
            tj, j = torch.min(t, dim=1)  # first (lowest) index among ties
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bi = torch.where(better, (j + ts).to(torch.int32), bi)
        tbest[lanes] = bt
        ibest[lanes] = bi
    return tbest, ibest


def bvh_closest_mt(rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
                   tri, bvh_child, bvh_axis, bvh_boxes, tcl: int = MT_TCL, depth: int = 1):
    """Closest-hit traversal with the linear-form leaf test (the reference's
    ``bvh_closest(mxu=True)``); returns (t, idx) with (1e16, -1) on a miss.
    Needs 32-row leaves; K10's tables are built from ``tri`` at its first
    query and kept (``mt_kernel_tables``), where the reference builds its
    table on each call."""
    planes = (rox, roy, roz, rdx, rdy, rdz, tmin, tmax)
    if tcl != MT_TCL or tri.shape[0] % MT_TCL:
        raise ValueError(f"bvh_closest_mt: needs {MT_TCL}-row leaves over a multiple of "
                         f"{MT_TCL} rows, got tcl {tcl} over {tri.shape[0]} rows")
    if tri.device.type == "cpu":
        return plain_closest_mt(*planes, tri)
    n, n_nodes = _check_args("bvh_closest_mt", planes, tri, bvh_child, bvh_axis,
                             bvh_boxes, tcl, depth)
    lean, frag, center = mt_kernel_tables(tri)
    t_out = torch.empty(n, dtype=torch.float32, device=tri.device)
    i_out = torch.empty(n, dtype=torch.int32, device=tri.device)
    err = torch.zeros(1, dtype=torch.int32, device=tri.device)
    fn = kernels.launcher("bvh_closest_mt")
    kernels.LAUNCHES["bvh_closest_mt"] += 1
    rc = fn(*(p.data_ptr() for p in planes), lean.data_ptr(), frag.data_ptr(),
            center.data_ptr(), bvh_child.data_ptr(), bvh_axis.data_ptr(),
            bvh_boxes.data_ptr(), n, tri.shape[0], n_nodes, t_out.data_ptr(),
            i_out.data_ptr(), err.data_ptr(), kernels.stream_ptr(tri.device))
    kernels.check(rc, "bvh_closest_mt")
    _raise_on_flag("bvh_closest_mt", err)
    return t_out, i_out
