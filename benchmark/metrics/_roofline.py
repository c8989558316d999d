"""A roofline share over kernel families, as the timed path runs them: the
least time their work of a sample needs at the H100's peaks (the counted
calls of the calls part, rooflines/<family>.py, harness/peaks.py), times
the samples of the device part, over those families' device time in the
device part (graph replays included), in percent. Nothing to read (no
counted call, or no device time of the families) gives None."""

from benchmark.harness.peaks import bound_s


def share(trace, families):
    rows = [r for f, r in trace["families"].items()
            if f in families and r["work"] and r.get("device_s", 0.0) > 0]
    if not rows or not trace.get("calls_samples"):
        return None
    per_sample = sum(bound_s(b, x) for r in rows for b, x in r["work"]) / trace["calls_samples"]
    return 100.0 * per_sample * trace["samples"] / sum(r["device_s"] for r in rows)
