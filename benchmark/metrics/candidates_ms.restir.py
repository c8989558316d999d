"""candidates_ms.restir: the ``restir.candidates`` stage's ms a frame (the M
candidates streamed through each pixel's reservoir), on the stream's clock
as the program's ``RESTIR_STATS`` records it, averaged over the traced run's
stats frames (before any profiler started). A program without the counter
gives nothing to read."""


def read(rec):
    rows = [r["restir.candidates"] for r in rec.get("restir_stage_ms", ())
            if "restir.candidates" in r]
    return sum(rows) / len(rows) if rows else None
