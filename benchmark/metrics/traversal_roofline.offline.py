"""traversal_roofline.offline: the roofline share of K1 bvh_closest, K2
bvh_anyhit, K5 sweep_closest and K6 sweep_anyhit in the timed path: their
work of a sample (counted on the set-up render's eager sample) at the
H100's peaks over their device time a sample in the traced image's
replays, in percent."""

from benchmark.metrics import _roofline as _r

FAMILIES = ("bvh", "sweep")


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "offline" or t is None:
        return None
    return _r.share(t, FAMILIES)
