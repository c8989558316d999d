"""Fixtures of the benchmark's own tests (run with
``python -m pytest benchmark/tests`` from the root of the repository).

``tiny_root`` builds a throwaway checkout root in a temporary directory: the
repository's BENCHMARK.json and limits, its kinds, metrics and rooflines, and each
configuration's scene at a small film, so that a whole run of a cell goes
on the CPU in seconds. Tests that need a CUDA card carry the ``card``
marker and ask for the ``cuda_card`` fixture, which skips them elsewhere.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine: the run's timed path is the card's")
    return torch.device("cuda")


def make_root(tmp: Path, film=(16, 9), spp=2, check_pixels=24, check_frames=3) -> Path:
    """A checkout root holding the benchmark's cells at a small size."""
    b = tmp / "benchmark"
    for d in ("configs", "traffic", "limits", "scenes"):
        (b / d).mkdir(parents=True, exist_ok=True)
    for d in ("kinds", "metrics", "rooflines"):
        os.symlink(REPO / "benchmark" / d, b / d)
    for d in ("meshes", "env"):
        os.symlink(REPO / "benchmark" / "scenes" / d, b / "scenes" / d)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        xml = (REPO / conf["scene"]).read_text()
        xml = re.sub(r'(name="width" value=")\d+', rf"\g<1>{film[0]}", xml)
        xml = re.sub(r'(name="height" value=")\d+', rf"\g<1>{film[1]}", xml)
        (b / "scenes" / f"{c['name']}.xml").write_text(xml)
        conf["film"] = list(film)
        (b / "configs" / f"{c['name']}.json").write_text(json.dumps(conf))
    for w in bench["workloads"]:
        mix = json.loads((REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        mix.update({k: v for k, v in (("spp", spp), ("check_frames", check_frames)) if k in mix})
        mix["check_pixels"] = check_pixels
        (b / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        shutil.copy(REPO / "benchmark" / "limits" / f"{w['name']}.json",
                    b / "limits" / f"{w['name']}.json")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
