"""What a cell is, found by name from the files of the benchmark.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics. Everything else
belongs to one configuration, one mix, one metric or one kernel family and
sits in a file of its own, found by its name:

    benchmark/configs/<config>.json    the scene, film, depth and route as
                                       run, and the environment (``env``)
                                       the program runs under
    benchmark/traffic/<mix>.json       the mix's parameters; its ``kind``
                                       names the generator
    benchmark/kinds/<kind>.py          one kind of traffic: its program
                                       (set-up, window, outputs) and its
                                       comparison with the reference
    benchmark/limits/<cell>.json       the limit of each number compared
    benchmark/metrics/<metric>.py      the reader of one metric
    benchmark/rooflines/<family>.py    the work and bytes of one kernel family

so a new cell, mix, metric or family is new files and new entries, and no
file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = ROOT


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files read."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_file = root / configs[w["config"]]["file"]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_json(conf_file),
        traffic=_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "benchmark" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )


def load_module(root: Path, folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module (the name may hold dots)."""
    path = root / "benchmark" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(cell: Cell):
    """The module of the cell's kind of traffic, ``benchmark/kinds/<kind>.py``."""
    return load_module(cell.root, "kinds", cell.traffic["kind"])


PROGRAM = "pupiloptixlab_tpu_torch"


def apply_env(cell: Cell) -> None:
    """Set the configuration's ``env`` (the program's route switches) in this
    process. The program reads some of them when it is imported, so this
    comes first: where any of its modules is loaded already and a setting
    differs, it raises."""
    env = {k: str(v) for k, v in cell.config.get("env", {}).items()}
    loaded = any(m.split(".")[0] == PROGRAM for m in sys.modules)
    changed = sorted(k for k, v in env.items() if os.environ.get(k) != v)
    if loaded and changed:
        raise RuntimeError(f"{PROGRAM} was imported before its settings {changed}")
    os.environ.update(env)


def load_families(root: Path = ROOT) -> dict:
    """Every kernel family of ``benchmark/rooflines/``, by file name."""
    return {p.stem: load_module(root, "rooflines", p.stem)
            for p in sorted((root / "benchmark" / "rooflines").glob("*.py"))
            if not p.stem.startswith("_")}
