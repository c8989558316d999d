"""frame_ms: the window's host time over the frames shown in it."""


def read(rec):
    if rec.get("kind") != "interactive":
        return None
    return rec["window_s"] * 1e3 / len(rec["frames"])
