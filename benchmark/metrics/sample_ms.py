"""sample_ms: the window's host time over the samples it completed (images x
spp), every image's warm-up, capture, instantiation and host copy included."""


def read(rec):
    if rec.get("kind") != "offline":
        return None
    return rec["window_s"] * 1e3 / rec["samples"]
