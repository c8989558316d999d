"""shading_ms.offline: device ms a traced sample (the image's warm-up sample
and its replays) of every operation not launched inside a hand kernel's
call: the plain PyTorch shading of render/*, the blend and the copies."""

from benchmark.metrics import _shading as _s


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "offline" or t is None:
        return None
    return _s.shading_s(t) * 1e3 / t["samples"]
