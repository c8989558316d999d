"""ops_per_frame.interactive: device operations (kernels, copies, memsets) a
frame in the traced run's device part."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "interactive" or t is None:
        return None
    return t["device_ops"] / t["frames"]
