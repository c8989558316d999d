"""Peaks of one NVIDIA H100 SXM at its 700 W power limit, the yardstick of
every roofline share. A card set below 700 W runs slower under load: the
run prints the card's ``power.limit`` beside its numbers.

HBM and FP32 are NVIDIA's data sheet (dense). NVIDIA publishes no rate of
the L2 cache; ``L2_BYTES_PER_S`` is the highest rate measured on the card
for data that stays in it (PERF.md, section 3: a copy and a sum of
buffers of 4-32 MB, repeated), so that a share against it may come out
above its true figure, never far below.
"""

HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_FLOP_PER_S = 67e12     # FP32 outside the tensor cores
L2_BYTES = 50 << 20         # the L2 cache
L2_BYTES_PER_S = 8.59e12      # measured: see the docstring


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take for a call, whatever it finds in
    the L2 cache: every byte passes the L2 (bytes over its rate), at most
    one cache's worth of the inputs is found there and one of the outputs
    left there (the rest over the HBM rate), and its float operations take
    the FP32 rate."""
    return max(n_bytes / L2_BYTES_PER_S, max(n_bytes - 2 * L2_BYTES, 0) / HBM_BYTES_PER_S,
               n_flops / FP32_FLOP_PER_S)
