"""What the kinds of traffic share. A mix file
(``benchmark/traffic/<mix>.json``) names its ``kind`` and parameters; the
kind (``benchmark/kinds/<kind>.py``, found by that name) is the generator
that reads them. A kind defines

``Program(cell, mix, seed, device, tracer)``: its set-up builds the program
  and warms up the shapes its traffic uses; ``window(seconds)`` runs the
  timed loop and returns the run's record (with ``kind`` and
  ``attempted``); ``outputs()`` fetches, once the window has closed, what
  the check compares; ``release()`` frees the program's state.
``numbers(cell, seed, out, records, device, control)``: the numbers compared
  with the plain reference (see harness/check.py).

Every draw of a run comes from its seed through ``rng_of``, one stream a
kind of draw.
"""

from __future__ import annotations

import numpy as np
import torch

OPPOSITE = {"w": "s", "s": "w", "a": "d", "d": "a", "q": "e", "e": "q"}


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's draws (seeds of any size)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def sample_pixels(seed: int, width: int, height: int, count: int, even: bool) -> np.ndarray:
    """``count`` distinct pixel ids drawn from the seed; with ``even`` only
    pixels at even x and y (those the stride-2 preview shows too)."""
    g = rng_of(seed, 1)
    if even:
        w2, h2 = width // 2, height // 2
        k = g.choice(w2 * h2, size=count, replace=False)
        return ((k // w2) * 2 * width + (k % w2) * 2).astype(np.int64)
    return g.choice(width * height, size=count, replace=False).astype(np.int64)


def image_seeds(seed: int, count: int) -> list[int]:
    """The first sample seed of each offline image, in [0, 2^32)."""
    return [int(x) for x in rng_of(seed, 2).integers(0, 1 << 32, size=count)]


def key_sequence(seed: int, count: int) -> list[str]:
    """``count`` camera keys: a WASDQE key drawn from the seed, then its
    opposite, and so on."""
    there = rng_of(seed, 3).choice(sorted(OPPOSITE), size=(count + 1) // 2)
    return [k for t in there for k in (str(t), OPPOSITE[str(t)])][:count]


def check_config(conf: dict, config) -> None:
    """The flattened scene must be the configuration's file: its film, its
    depth, its intersection route (a BVH, or the chunk sweep) and any field
    of the flattened render settings that its ``flat`` names."""
    got = {"film": [config.width, config.height], "max_depth": config.max_depth,
           "route": "bvh" if config.bvh_nodes > 0 else "sweep"}
    got.update({k: getattr(config, k) for k in conf.get("flat", {})})
    want = {k: conf[k] for k in ("film", "max_depth", "route")}
    want.update(conf.get("flat", {}))
    if got != want:
        raise RuntimeError(f"the scene runs as {got}, its configuration says {want}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
