"""gather_roofline.offline: the roofline share of K3 gather_planes and K4
count_less in the timed path: their work of a sample (counted on the
set-up render's eager sample) at the H100's peaks over their device time a
sample in the traced image's replays, in percent."""

from benchmark.metrics import _roofline as _r

FAMILIES = ("gather", "count_less")


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "offline" or t is None:
        return None
    return _r.share(t, FAMILIES)
