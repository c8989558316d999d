"""shading_ms.interactive: device ms a profiled frame of every operation not
launched inside a hand kernel's call: the plain PyTorch shading of
render/*, the blend, and the display pump's tone map and copies."""

from benchmark.metrics import _shading as _s


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "interactive" or t is None:
        return None
    return _s.shading_s(t) * 1e3 / t["frames"]
