"""device_idle.offline: the share of an image's host time in which no device
operation runs, in percent: one less the device's busy time in the traced
image (the union of its operations' intervals) over the mean host time of
the run's images made before any profiler started in the process, since
CUPTI slows every launch once a profiler has started."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "offline" or t is None:
        return None
    host = [i["t1"] - i["t0"] for i in rec["images"] if i["phase"] == "clean"]
    if not host:
        return None
    return 100.0 * (1.0 - t["busy_s"] / (sum(host) / len(host)))
