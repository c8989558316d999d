"""Whole runs of the harness on the CPU at a small size (the look for a card
skipped): a cell found from new files alone, the import check, the control
and the planted faults that ``correct`` must catch."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.runner import forbidden_modules, run_cell
from conftest import REPO

OFFLINE = "oracle_mat.offline64"
INTERACTIVE = "oracle_mat.interactive"


def run(root, cell, seed=2**31 + 7, seconds=0.5, trace=False, control=False):
    return run_cell(spec.load_cell(cell, root), seed, seconds, trace, "cpu",
                    time.perf_counter(), control=control)


def test_a_new_config_mix_and_metric_are_found_by_name(tiny_root):
    b = tiny_root / "benchmark"
    conf = json.loads((b / "configs" / "oracle_mat.json").read_text())
    (b / "configs" / "tiny.json").write_text(json.dumps(conf))
    (b / "traffic" / "quick.json").write_text(json.dumps(
        {"kind": "offline", "spp": 2, "warmup_spp": 1, "trace_image": 0,
         "check_images": 1, "check_pixels": 16}))
    # metrics/ is the repository's own folder (a link here): add the new
    # reader beside a copy of it
    real = b / "metrics"
    real.unlink()
    real.mkdir()
    for p in (REPO / "benchmark" / "metrics").glob("*.py"):
        (real / p.name).write_text(p.read_text())
    (real / "images_done.py").write_text(
        "def read(rec):\n    return float(len(rec['images']))\n")
    (b / "limits" / "tiny.quick.json").write_text(json.dumps({"image_rel_mse": 1e-9}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/tiny.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny.quick", "config": "tiny", "traffic": "quick",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "sample_ms":
            m["workloads"].append("tiny.quick")
    bench["end_to_end"].append({"name": "images_done", "unit": "images", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["tiny.quick"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(tiny_root, "tiny.quick")
    assert r["correct"] is True
    assert r["metrics"]["images_done"]["value"] == r["attempted"] >= 1
    assert set(r["metrics"]) == {"sample_ms", "setup_s", "images_done"}


STILLS = """
import time

from benchmark.harness import check
from benchmark.harness.traffic import check_config, sample_pixels
from benchmark.reference import pixels as refpix


class Program:
    def __init__(self, cell, mix, seed, device, tracer):
        from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
        from pupiloptixlab_tpu_torch.render.integrator import render
        from pupiloptixlab_tpu_torch.scene import load_scene

        scene = load_scene(cell.root / cell.config["scene"])
        self.data, self.config = flatten_scene(scene, device=device)
        check_config(cell.config, self.config)
        self.camera = camera_block_from_scene(scene, device=device)
        self.render, self.mix = render, mix
        self.pix = sample_pixels(seed, self.config.width, self.config.height,
                                 mix["check_pixels"], even=False)

    def window(self, seconds):
        t0 = time.perf_counter()
        img = self.render(self.data, self.camera, self.config, spp=self.mix["spp"], seed0=7)
        self.got = img.reshape(-1, 3)[self.pix].numpy()
        return {"kind": "stills", "attempted": 1, "window_s": time.perf_counter() - t0}

    def outputs(self):
        return {"pix": self.pix, "got": self.got}

    def release(self):
        del self.data, self.camera


def numbers(cell, seed, out, records, device, control=False):
    ref = check.reference(cell, device)
    seeds = [7 + i for i in range(cell.traffic["spp"])]
    want = refpix.accumulate(ref, out["pix"], seeds, lowp=control)["accum"]
    return {"still_rel_mse": check.rel_mse(out["got"], want)}
"""


def test_a_new_kind_and_route_switches_are_found_by_name(tiny_root):
    """A kind of traffic that no file of the benchmark knows, on a
    configuration whose ``env`` switches the program's route (mesh_env
    without its BVH, so that the run's check of the route fails unless the
    setting reached the program), from new files and entries alone."""
    b = tiny_root / "benchmark"
    real = b / "kinds"   # the repository's own folder (a link here): add beside a copy
    real.unlink()
    real.mkdir()
    for p in (REPO / "benchmark" / "kinds").glob("*.py"):
        (real / p.name).write_text(p.read_text())
    (real / "stills.py").write_text(STILLS)
    conf = json.loads((b / "configs" / "mesh_env.json").read_text())
    conf.update(name="mesh_env_sweep", route="sweep", env={"PUPIL_NO_BVH": "1"},
                flat={"bvh_nodes": 0})
    (b / "configs" / "mesh_env_sweep.json").write_text(json.dumps(conf))
    (b / "traffic" / "stills.json").write_text(json.dumps(
        {"kind": "stills", "spp": 2, "check_pixels": 16}))
    (b / "limits" / "mesh_env_sweep.stills.json").write_text(json.dumps({"still_rel_mse": 0.0}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mesh_env_sweep", "source": "https://example.org",
                             "reduced": [], "file": "benchmark/configs/mesh_env_sweep.json",
                             "why": "a test"})
    bench["workloads"].append({"name": "mesh_env_sweep.stills", "config": "mesh_env_sweep",
                               "traffic": "stills", "chips": 1, "why": "a test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, os, sys, time; sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "from benchmark.harness import spec\n"
            "cell = spec.load_cell('mesh_env_sweep.stills', Path(%r))\n"
            "spec.apply_env(cell)\n"
            "from benchmark.harness.runner import run_cell\n"
            "r = run_cell(cell, 11, 0.1, False, 'cpu', time.perf_counter(), control=True)\n"
            "print(json.dumps([r['correct'], r['attempted'], r['control'], sorted(r['metrics']),"
            " os.environ.get('PUPIL_NO_BVH')]))\n" % (str(REPO), str(tiny_root)))
    env = {k: v for k, v in os.environ.items() if k != "PUPIL_NO_BVH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, attempted, control, metrics, no_bvh = json.loads(out.stdout.splitlines()[-1])
    assert correct is True and attempted == 1 and no_bvh == "1"
    assert control["still_rel_mse"] > 0.0
    assert metrics == ["setup_s"]


def test_route_switches_cannot_follow_the_programs_import(monkeypatch):
    import pupiloptixlab_tpu_torch  # noqa: F401

    cell = spec.Cell(name="x", chips=1, config={"env": {"PUPIL_NO_BVH": "1"}}, traffic={},
                     limits={})
    monkeypatch.delenv("PUPIL_NO_BVH", raising=False)
    with pytest.raises(RuntimeError, match="PUPIL_NO_BVH"):
        spec.apply_env(cell)
    assert "PUPIL_NO_BVH" not in os.environ


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["pupiloptixlab_tpu_torch.render", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "pupiloptixlab_tpu.render", "flax"]) == [
        "flax", "jax", "pupiloptixlab_tpu"]


def test_a_cpu_run_loads_no_jax(tiny_root):
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from benchmark.harness import spec\n"
            "from benchmark.harness.runner import run_cell, forbidden_modules\n"
            "from pathlib import Path\n"
            "r = run_cell(spec.load_cell('oracle_mat.offline64', Path(%r)), 3, 0.2, False, 'cpu', "
            "time.perf_counter())\n"
            "print(r['correct'], forbidden_modules())\n" % (str(REPO), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_without_a_card_the_command_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
                          OFFLINE, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", [OFFLINE, INTERACTIVE, "mesh_env.offline64"])
def test_the_control_comes_out_not_correct(tiny_root, cell):
    r = run(tiny_root, cell, control=True)
    assert r["correct"] is True
    limits = spec.load_cell(cell, tiny_root).limits
    assert any(v > limits[k] for k, v in r["control"].items()), r["control"]


def _offline_fault(monkeypatch, fault):
    from pupiloptixlab_tpu_torch.render import integrator

    real = integrator.render_frame_batch

    def broken(scene, camera, seed0, sample_cnt, accum, config, spp):
        if fault == "unchanged":
            return accum, {"frame": accum}
        out = real(scene, camera, seed0, sample_cnt, accum, config, spp)
        n = accum.shape[0]
        if fault == "half":     # half of the pixels left out
            accum[n // 2:] = 0.0
        else:                   # an answer altered where it is produced
            accum[:, 0] *= 1.01
        return out

    monkeypatch.setattr(integrator, "render_frame_batch", broken)


def _interactive_fault(monkeypatch, fault):
    from pupiloptixlab_tpu_torch.passes import pt

    real = pt.render_frame

    def broken(scene, camera, seed, sample_cnt, accum, config, *a, **k):
        if fault == "unchanged":
            return accum, {"frame": accum, "albedo": torch.zeros_like(accum),
                           "normal": torch.zeros_like(accum),
                           "test": torch.zeros(accum.shape[0])}
        accum, bufs = real(scene, camera, seed, sample_cnt, accum, config, *a, **k)
        n = accum.shape[0]
        if fault == "half":
            accum[n // 2:] = 0.0
        else:
            accum[:, 0] *= 1.01
        return accum, bufs

    monkeypatch.setattr(pt, "render_frame", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", [OFFLINE, INTERACTIVE])
def test_a_broken_timed_path_comes_out_not_correct(tiny_root, monkeypatch, cell, fault):
    (_offline_fault if cell == OFFLINE else _interactive_fault)(monkeypatch, fault)
    r = run(tiny_root, cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(cuda_card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", OFFLINE, "--seed",
                          str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
