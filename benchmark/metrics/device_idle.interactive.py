"""device_idle.interactive: the share of a frame's host time in which no
device operation runs, in percent: one less the device's busy time a frame
in the traced frames (the union of their operations' intervals) over the
mean host time of the run's frames made before any profiler started in the
process (and without the pump frames' synchronise), since CUPTI slows
every launch once a profiler has started."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "interactive" or t is None:
        return None
    host = [f["ms"] for f in rec["frames"] if f["phase"] == "clean"]
    if not host:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["frames"] / (sum(host) / len(host) / 1e3))
