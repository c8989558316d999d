"""reuse_ms.restir: the ``restir.temporal`` and ``restir.spatial`` stages'
ms a frame together (the temporal merge and the spatial taps' merges), on
the stream's clock as the program's ``RESTIR_STATS`` records them, averaged
over the traced run's stats frames. A program without the counter gives
nothing to read."""


def read(rec):
    rows = [r["restir.temporal"] + r["restir.spatial"] for r in rec.get("restir_stage_ms", ())
            if "restir.temporal" in r and "restir.spatial" in r]
    return sum(rows) / len(rows) if rows else None
