"""pump_ms.interactive: the display client's FRAME_FINISHED handler (tone
map, uint8 quantisation, flip, one fetch), host ms from a synchronise just
before it to the end of its fetch, averaged over the traced run's pump
frames (made before any profiler started in the process)."""


def read(rec):
    if rec.get("kind") != "interactive":
        return None
    rows = [f["pump_s"] for f in rec["frames"] if f["phase"] == "pump"]
    return sum(rows) * 1e3 / len(rows) if rows else None
