"""Port parity: profiling (utils/profiling.py), checkpoint / resume
(utils/checkpoint.py) and the compute pass (passes/compute.py) on the CPU.

* ``FrameStats`` and ``Stopwatch`` against the reference's on the same
  records: equal summaries; ``FrameStats.bind`` on both Systems' frames.
* ``trace`` / ``annotate``: a Chrome trace written on the CPU holds the
  annotation.
* Checkpoints, on data/oracle_mat.xml at its own 64x64 film, PTPass at
  depth 2, seeds from 0 in both packages:
  - the port's 3 frames + save + a fresh pass state + restore + 3 frames
    are bit-equal to its 6 uninterrupted frames;
  - those frames agree with the reference's 6 uninterrupted frames at the
    frame tolerances of tests/test_torch_system.py (relative MSE <= 1e-5,
    >= 99% of pixels within rtol 1e-4);
  - a checkpoint written by the reference's ``save_render_state`` (orbax)
    after its 3rd frame, read with its ``load_pytree``, handed over as
    numpy through the port's ``save_pytree`` and resumed by the port for 3
    frames, agrees with the reference's 6 frames at the same tolerances;
  - a film of another size raises ValueError.
* ``ComputePass`` with examples/compute_test_torch.py's ``animate`` against
  the reference's pass with examples/compute_test.py's, 3 frames at 32x32:
  every buffer within rtol 1e-6 / atol 1e-6.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.passes import ComputePass as JaxComputePass
from pupiloptixlab_tpu.passes import PTPass as JaxPTPass
from pupiloptixlab_tpu.system import System as JaxSystem
from pupiloptixlab_tpu.utils import checkpoint as jax_checkpoint
from pupiloptixlab_tpu.utils import profiling as jax_profiling
from pupiloptixlab_tpu_torch.passes import ComputePass, PTPass
from pupiloptixlab_tpu_torch.system import System
from pupiloptixlab_tpu_torch.utils import profiling
from pupiloptixlab_tpu_torch.utils.checkpoint import (
    TREE_FILE,
    load_pytree,
    restore_render_state,
    save_pytree,
    save_render_state,
)

REPO = Path(__file__).resolve().parent.parent
SCENE = REPO / "data" / "oracle_mat.xml"


def _close(a, b):
    """The frame tolerances of tests/test_torch_system.py."""
    rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
    frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
    assert np.isfinite(a).all() and rel <= 1e-5 and frac >= 0.99, (rel, frac)


@pytest.mark.parametrize("window,frames,passes", [
    (4, (10.0, 20.0, 30.0, 40.0, 50.0), {"pt": (9.0,)}),
    (120, (16.5, 17.25, 33.0), {"a": (1.0, 2.0, 4.0), "b": (0.5,)}),
    (8, (), {}),
])
def test_frame_stats_and_stopwatch_match_reference(window, frames, passes):
    stats = [profiling.FrameStats(window), jax_profiling.FrameStats(window)]
    for fs in stats:
        for ms in frames:
            fs.record_frame(ms)
        for name, times in passes.items():
            for ms in times:
                fs.record_pass(name, ms)
    assert stats[0].summary() == stats[1].summary()
    assert stats[0].fps == stats[1].fps
    watches = [profiling.Stopwatch(), jax_profiling.Stopwatch()]
    for sw in watches:
        for name in ("load", "flatten", "load"):
            with sw.lap(name):
                pass
    assert watches[0].laps.keys() == watches[1].laps.keys() == {"load", "flatten"}


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t", device="cpu") as logdir:
        with profiling.annotate("frame"):
            torch.ones(64).cumsum(0)
    assert logdir == str(tmp_path / "t")
    (path,) = (tmp_path / "t").glob("pupil_*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert [e.get("cat") for e in events if e.get("name") == "frame"] == ["user_annotation"]
    assert any(e.get("name") == "aten::cumsum" for e in events)
    if not torch.cuda.is_available():  # the card by default: none here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with profiling.trace(tmp_path / "u"):
                pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Frames of both packages on oracle_mat 64x64, PTPass(max_depth=2):
    the reference's 6 uninterrupted frames with its orbax checkpoint after
    the 3rd; the port's 6 uninterrupted frames, and its 3 + checkpoint + a
    fresh pass state + restore + 3."""
    tmp = tmp_path_factory.mktemp("ckpt")
    out = {"tmp": tmp}

    jsys = JaxSystem()
    jpt = JaxPTPass(max_depth=2)
    jsys.add_pass(jpt)
    assert jsys.set_scene(SCENE)
    jstats = jax_profiling.FrameStats()
    jstats.bind(jsys)
    jsys.run(max_frames=3)
    jax_checkpoint.save_render_state(tmp / "jax_ckpt", jpt)
    jsys.run(max_frames=3)
    out["jax"] = np.asarray(jpt._accum).copy()
    out["jax_state"] = (jpt.sample_cnt, jpt.seed)
    out["jax_stats"] = jstats.summary()

    system = System(device="cpu")
    pt = PTPass(max_depth=2)
    system.add_pass(pt)
    assert system.set_scene(SCENE)
    stats = profiling.FrameStats()
    stats.bind(system)
    system.run(max_frames=6)
    out["straight"] = pt._accum.clone()
    out["stats"] = stats.summary()

    pt._set_scene(system.world)  # reset accumulation
    pt.seed = 0
    system.run(max_frames=3)
    save_render_state(tmp / "ckpt", pt)
    pt._set_scene(system.world)  # a fresh pass state, as after a restart
    assert pt.sample_cnt == 0 and float(pt._accum.abs().sum()) == 0.0
    restore_render_state(tmp / "ckpt", pt)
    out["restored"] = (pt.sample_cnt, pt.seed, pt._accum.clone(),
                       {k: (system.buffers[k].array is pt._accum,
                            system.buffers[k].array.clone())
                        for k in ("pt frame", "pt accum", "final result")})
    system.run(max_frames=3)
    out["resumed"] = (pt.sample_cnt, pt.seed, pt._accum.clone())
    out["system"] = system
    return out


def test_frame_stats_bind_to_both_systems(runs):
    s, j = runs["stats"], runs["jax_stats"]
    assert s["frames"] == j["frames"] == 6
    assert s.keys() == j.keys() and s["passes"].keys() == j["passes"].keys() == {"Path Tracing"}
    assert s["fps"] > 0 and s["frame_ms"]["min"] <= s["frame_ms"]["mean"] <= s["frame_ms"]["max"]


def test_checkpoint_resume_is_bit_equal_to_the_uninterrupted_run(runs):
    cnt, seed, accum = runs["resumed"]
    assert (cnt, seed) == (6, 6)
    assert torch.equal(accum, runs["straight"])


def test_restore_repoints_the_aliasing_buffers(runs):
    """After a restore, before any frame, the buffers a frame publishes
    from the accum show the restored accum (no stale zeros)."""
    cnt, seed, accum, bufs = runs["restored"]
    assert (cnt, seed) == (3, 3) and float(accum.abs().sum()) > 0.0
    for name, (same, arr) in bufs.items():
        assert same and torch.equal(arr, accum), name


def test_checkpoint_resume_matches_the_reference_frames(runs):
    assert runs["jax_state"] == (6, 6)
    _close(runs["resumed"][2].numpy(), runs["jax"])
    _close(runs["straight"].numpy(), runs["jax"])


def test_a_reference_checkpoint_resumes_in_the_port(runs):
    tmp, system = runs["tmp"], runs["system"]
    pt = system.passes[0]
    state = jax_checkpoint.load_pytree(tmp / "jax_ckpt")
    save_pytree(tmp / "carried", {k: np.asarray(v) for k, v in state.items()})
    assert (tmp / "carried" / TREE_FILE).is_file()
    pt._set_scene(system.world)
    restore_render_state(tmp / "carried", pt)
    assert (pt.sample_cnt, pt.seed) == (3, 3)
    system.run(max_frames=3)
    assert (pt.sample_cnt, pt.seed) == runs["jax_state"]
    _close(pt._accum.numpy(), runs["jax"])


def test_a_film_of_another_size_is_refused(runs, tmp_path):
    tmp, system = runs["tmp"], runs["system"]
    pt = system.passes[0]
    keep = pt._accum
    pt._accum = torch.zeros((8 * 8, 3))
    try:
        with pytest.raises(ValueError, match="accum"):
            restore_render_state(tmp / "ckpt", pt)
    finally:
        pt._accum = keep
    save_pytree(tmp_path / "f64", {"accum": torch.zeros(keep.shape, dtype=torch.float64),
                                   "sample_cnt": torch.tensor(1, dtype=torch.int32),
                                   "seed": torch.tensor(1, dtype=torch.uint32)})
    with pytest.raises(ValueError, match="float64"):
        restore_render_state(tmp_path / "f64", pt)


def test_save_pytree_round_trips_nested_trees(tmp_path):
    r = np.random.default_rng(11)
    tree = {"a": torch.from_numpy(r.random((5, 3), dtype=np.float32)),
            "b": [np.arange(4, dtype=np.int64), {"c": np.uint32(7), "d": 2.5}],
            "e": torch.tensor(3, dtype=torch.int32)}
    save_pytree(tmp_path / "ck", tree)
    save_pytree(tmp_path / "ck", tree)  # a second save replaces the first
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [TREE_FILE]
    back = load_pytree(tmp_path / "ck")
    assert torch.equal(back["a"], tree["a"]) and back["b"][1]["d"] == 2.5
    assert torch.equal(back["b"][0], torch.arange(4)) and int(back["b"][1]["c"]) == 7
    like = {"a": torch.zeros(5, 3), "b": [torch.zeros(4, dtype=torch.int64),
                                          {"c": torch.tensor(0, dtype=torch.uint32), "d": 0.0}],
            "e": torch.tensor(0, dtype=torch.int32)}
    placed = load_pytree(tmp_path / "ck", like=like)
    assert placed["a"].device == like["a"].device and torch.equal(placed["a"], tree["a"])
    like["a"] = torch.zeros(5, 4)
    with pytest.raises(ValueError, match="/a"):
        load_pytree(tmp_path / "ck", like=like)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_compute_pass_matches_reference():
    animate = _load_example("compute_test_torch").animate
    jax_animate = _load_example("compute_test").animate
    systems = []
    for system, p in (
            (System(device="cpu"), ComputePass(lambda f, w, h: animate(f, w, h, "cpu"), 32, 32)),
            (JaxSystem(), JaxComputePass(lambda f, w, h: jax_animate(jnp.int32(f), w, h), 32, 32))):
        system.add_pass(p)
        system.run(max_frames=3)
        assert p.frame_index == 3
        systems.append(system)
    got, want = (s.buffers for s in systems)
    assert got.displayable_names() == want.displayable_names() == ["wave rgb", "wave x", "wave xy"]
    for name in want.displayable_names():
        g, w = got[name], want[name]
        assert (g.desc.width, g.desc.height, g.desc.channels) == (
            w.desc.width, w.desc.height, w.desc.channels) and g.desc.width == 32
        assert g.array.device.type == "cpu" and g.array.dtype == torch.float32
        np.testing.assert_allclose(g.array.numpy(), np.asarray(w.array), rtol=1e-6, atol=1e-6)
