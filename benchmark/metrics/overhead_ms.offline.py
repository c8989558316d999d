"""overhead_ms.offline: the host ms an offline image spends before its
replays (the eager warm-up sample, the graph's capture and instantiation),
as render_frame_batch records them (integrator.BATCH_STATS), averaged over
the traced run's images made before any profiler started in the process."""


def read(rec):
    if rec.get("kind") != "offline":
        return None
    rows = [i["batch"] for i in rec["images"] if i["phase"] == "clean" and "warmup_ms" in i["batch"]]
    if not rows:
        return None
    return sum(b["warmup_ms"] + b["capture_ms"] + b["instantiate_ms"] for b in rows) / len(rows)
