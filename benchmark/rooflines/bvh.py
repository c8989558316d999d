"""K1 ``bvh_closest`` and K2 ``bvh_anyhit`` (accel/bvh_traverse.py): the
BVH route's closest-hit and any-hit traversal. A call reads its 8 ray
planes and its tables (triangles, nodes, boxes, the sub-leaf table) once
and writes t and the row (K1) or the flag (K2); it needs, at the least, the
8 root box tests of every live ray and one triangle test a hit (K1: 18 +
55 operations, the hit's barycentrics included; K2: 50)."""

from benchmark.rooflines import _count as _c

MODULE = "pupiloptixlab_tpu_torch.accel.bvh_traverse"


def _inputs(args):
    return args[:14]  # 8 ray planes, tri, child, axis, boxes, subleaf rows and boxes


def closest(args, kwargs, out):
    t, idx = out
    ins = _inputs(args)
    flops = _c.live(ins[6], ins[7]) * (8 * _c.SLAB_FLOPS) \
        + (idx >= 0).sum() * (18 + _c.MT_FLOPS_CLOSEST)
    return _c.nbytes(*ins, t, idx), flops


def anyhit(args, kwargs, out):
    ins = _inputs(args)
    flops = _c.live(ins[6], ins[7]) * (8 * _c.SLAB_FLOPS) + (out != 0).sum() * _c.MT_FLOPS_ANY
    return _c.nbytes(*ins, out), flops


CALLS = {"bvh_closest": closest, "bvh_anyhit": anyhit}
