"""gather_roofline.restir: the roofline share of K3 gather_planes and K4
count_less in the ReSTIR viewer's frame: their work of a frame (counted on
the calls part's frames) at the H100's peaks over their device time a frame
in the device part's frames, in percent. The calls part names a family's
kernels by when they start (harness/trace.py), so a skew of the two clocks
past half a millisecond lends another kernel's time to K3 or K4 and reads
low."""

from benchmark.metrics import _roofline as _r

FAMILIES = ("gather", "count_less")


def read(rec):
    t = rec.get("trace")
    if "restir_stage_ms" not in rec or t is None:
        return None
    return _r.share(t, FAMILIES)
