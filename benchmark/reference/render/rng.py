"""Counter-seeded per-lane RNG: TEA(4) scramble init + LCG stream.

Bit-exact port of pupiloptixlab_tpu/render/rng.py. The reference relies
on uint32 wraparound and a logical ``>> 5``; torch's int32 shifts are
arithmetic and its uint32 coverage is partial, so the state lives in
int64 lanes holding values in [0, 2^32), masked after every step. Every
intermediate stays below 2^53 (``state * 1664525 < 2^53``).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF  # seeds and states are uint32 words held in int64
_LCG_A = 1664525
_LCG_C = 1013904223


def tea_init(val0: torch.Tensor, val1: int | torch.Tensor, rounds: int = 4) -> torch.Tensor:
    """TEA scramble of two uint32 words -> per-lane LCG seed (int64 lanes
    holding uint32 values). Only the low 32 bits of each sum matter, so
    one mask per update reproduces uint32 wraparound exactly. ``val1`` is
    a Python int or a 0-dim integer tensor on ``val0``'s device (read by
    the kernels, not the host, so that a captured CUDA graph takes its
    value at each replay), masked to 32 bits alike."""
    v0 = val0.to(torch.int64) & M32
    if isinstance(val1, torch.Tensor):
        v1 = (val1.to(torch.int64) & M32).expand_as(v0)
    else:
        v1 = torch.full_like(v0, int(val1) & M32)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (
            v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4))
        ) & M32
        v1 = (
            v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761E))
        ) & M32
    return v0


def next_float(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LCG step; returns (new_state, uniform in [0,1)) where the
    uniform is exactly ``(state & 0xFFFFFF) / 2**24`` in float32."""
    state = (state * _LCG_A + _LCG_C) & M32
    u = (state & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)
    return state, u


def next_floats(state: torch.Tensor, n: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
    outs = []
    for _ in range(n):
        state, u = next_float(state)
        outs.append(u)
    return state, outs
