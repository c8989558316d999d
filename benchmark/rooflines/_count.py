"""Shared counting rules of the kernel families: each input byte read once,
each output byte written once, and the float operations that this call's
rays cannot avoid (one box test a live ray, one row test a hit), as the
port's kernel checks count them."""

MT_FLOPS_CLOSEST = 55   # one closest-hit triangle test
MT_FLOPS_ANY = 50       # one any-hit triangle test
SLAB_FLOPS = 22         # one box test: 6 sub/mul pairs + 10 min/max


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live(tmin, tmax):
    """Rays with a non-empty interval (a device count, read later)."""
    return (tmax > tmin).sum()
