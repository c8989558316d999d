"""Whether what the timed path produced is right: the numbers compared with
the plain reference (``benchmark/reference``), each against its limit
(``benchmark/limits/<cell>.json``). Each kind of traffic
(``benchmark/kinds/<kind>.py``) says in its ``numbers`` what it compares;
this module holds what they share.

``control=True`` puts the reference computed with a bfloat16 film in the
program's place; the comparison must come out not correct for it.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import spec
from benchmark.harness.traffic import rng_of
from benchmark.reference import pixels as refpix


def rel_mse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = float((want * want).sum())
    num = float(((got - want) ** 2).sum())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def sample(seed: int, n: int, count: int) -> list[int]:
    """``count`` of ``range(n)`` drawn from the seed, in order."""
    return sorted(int(i) for i in rng_of(seed, 4).choice(n, size=min(count, n), replace=False))


def reference(cell, device):
    """The plain reference of the cell's scene."""
    return refpix.load(cell.root / cell.config["scene"], device)


def numbers(cell, seed: int, out: dict, records: dict, device, control: bool = False) -> dict:
    return spec.load_kind(cell).numbers(cell, seed, out, records, device, control)
