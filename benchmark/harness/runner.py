"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` is the whole run after the look for the cards (benchmark/run.py
makes that look and prints what this returns); the tests call it on the
CPU at small sizes.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark.harness import check, spec
from benchmark.harness.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "pupiloptixlab_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (``pupiloptixlab_tpu_torch`` is not ``pupiloptixlab_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _read(cell, metrics: list, rec: dict) -> dict:
    out = {}
    for m in metrics:
        value = spec.load_module(cell.root, "metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, control: bool = False) -> dict:
    """The run's result (the keys of the result line), with the numbers
    compared under ``checks``. ``t_process`` is when the process started.
    With ``control`` the same numbers with the control (the reference with a
    bfloat16 film) in the program's place go under ``control``."""
    cuda = torch.device(device).type == "cuda"
    families = spec.load_families(cell.root) if trace else {}
    tracer = Tracer(families, enabled=trace)
    prog = spec.load_kind(cell).Program(cell, cell.traffic, seed, device, tracer)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    rec = prog.window(seconds)
    rec["setup_s"] = setup_s
    if trace:
        rec["trace"] = tracer.result()
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if trace:
        device_info.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
    metrics = _read(cell, cell.per_layer if trace else cell.end_to_end, rec)
    out = prog.outputs()
    prog.release()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.numbers(cell, seed, out, rec, device)
    rec["check_s"] = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": rec["attempted"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = rec["trace"]["breakdown"]
    if control:
        result["control"] = check.numbers(cell, seed, out, rec, device, control=True)
    result["checks"] = checks
    result["_record"] = rec
    return result
