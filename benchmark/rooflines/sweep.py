"""K5 ``sweep_closest`` and K6 ``sweep_anyhit`` (accel/sweep.py): the chunk
sweep of scenes without a BVH. A call reads its 8 ray planes, the live
rows below ``rows`` and their boxes (a chunk box each 64 rows, and above 32
chunks a super-box each 32 chunks) once, and writes t and the row (K5) or
the flag (K6); it needs, at the least, the box tests of every live ray (one
a box group) and one triangle test a hit (K5: 18 + 55; K6: 50)."""

from benchmark.rooflines import _count as _c

MODULE = "pupiloptixlab_tpu_torch.accel.sweep"
CHUNK = 64   # rows a chunk
GROUP = 32   # chunks a super-box


def group_count(n_chunks: int) -> int:
    return (n_chunks + GROUP - 1) // GROUP if n_chunks > GROUP else 1


def _tables(args, kwargs):
    tri, boxes = args[8], args[9]
    rows = kwargs["rows"]
    n_chunks = tri.shape[0] // CHUNK
    live_chunks = -(-rows // CHUNK)
    live_groups = group_count(live_chunks) if live_chunks > GROUP else 0
    tabs = (tri[:rows], boxes[:live_chunks], boxes[n_chunks:n_chunks + live_groups])
    return tabs, group_count(n_chunks)


def closest(args, kwargs, out):
    t, idx = out
    tabs, groups = _tables(args, kwargs)
    flops = _c.live(args[6], args[7]) * (groups * _c.SLAB_FLOPS) \
        + (idx >= 0).sum() * (18 + _c.MT_FLOPS_CLOSEST)
    return _c.nbytes(*args[:8], *tabs, t, idx), flops


def anyhit(args, kwargs, out):
    tabs, groups = _tables(args, kwargs)
    flops = _c.live(args[6], args[7]) * (groups * _c.SLAB_FLOPS) \
        + (out != 0).sum() * _c.MT_FLOPS_ANY
    return _c.nbytes(*args[:8], *tabs, out), flops


CALLS = {"sweep_closest": closest, "sweep_anyhit": anyhit}
