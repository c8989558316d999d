"""Port parity: the runtime (System, World, PTPass, BufferManager, tonemap)
on the CPU.

``System`` + ``PTPass`` render data/oracle_mat.xml at its own 64x64 film for
three frames in the JAX package and in the port; every displayable buffer
is compared at the frame tolerances of tests/test_torch_frame.py. (At 32x32
one lane of frame 0 takes another branch after an ulp-level difference,
0.118 against 0.012 in one pixel; among 1,024 pixels that alone is a
relative MSE of 2.0e-5, so the film is not cut below the scene's own.)

* ``pt test`` (one RNG draw per pixel): bit-equal.
* ``pt albedo``: allclose rtol 1e-5 / atol 1e-5.
* ``pt normal``: within 1e-5 on >= 98% of pixels and 1e-3 on all (the jitted
  reference contracts a*b+c into FMAs; on the small spheres a last-ulp
  difference in the hit position grows to ~1e-4 in the normal).
* ``pt frame`` / ``pt accum`` / ``final result`` (the accumulated radiance):
  relative MSE <= 1e-5 and >= 99% of pixels within rtol 1e-4.

The pass's ``sample_cnt`` / ``seed`` bookkeeping, the accumulation restarts
on a camera event and on ``set_max_depth``, the instance-edit path (a device
refit in both), the display transfer and the display clients that each
``display=`` spelling builds are held too.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.display import tonemap as jax_tonemap
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.passes import PTPass as JaxPTPass
from pupiloptixlab_tpu.system import System as JaxSystem
from pupiloptixlab_tpu.utils.event import MOUSE_DRAGGING
from pupiloptixlab_tpu.utils.math import Transform as JaxTransform
from pupiloptixlab_tpu_torch.display import tonemap
from pupiloptixlab_tpu_torch.passes import PTPass
from pupiloptixlab_tpu_torch.system import System
from pupiloptixlab_tpu_torch.system.buffers import BufferDesc, BufferFlag, BufferManager
from pupiloptixlab_tpu_torch.utils.math import Transform
from pupiloptixlab_tpu_torch.world.world import World

DATA = Path(__file__).resolve().parent.parent / "data"
SCENE = DATA / "oracle_mat.xml"
BUFFERS = ("pt frame", "pt accum", "pt albedo", "pt normal", "pt test", "final result")


def _snapshot(system):
    return {k: np.asarray(system.buffers[k].array if isinstance(
        system.buffers[k].array, jnp.ndarray) else system.buffers[k].array.numpy()).copy()
            for k in BUFFERS}


@pytest.fixture(scope="module")
def pair():
    """Both systems after set_scene and three frames, with the buffers of
    each frame."""
    out = {}
    for name, system_cls, pass_cls, kw in (
        ("jax", JaxSystem, JaxPTPass, {}),
        ("torch", System, PTPass, {"device": "cpu"}),
    ):
        system = system_cls(**kw)
        pt = pass_cls()
        system.add_pass(pt)
        assert system.set_scene(SCENE)
        frames = []
        for _ in range(3):
            system.run(max_frames=1)
            frames.append(_snapshot(system))
        out[name] = (system, pt, frames)
    return out


def _radiance_close(a, b):
    rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
    frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
    assert np.isfinite(a).all() and rel <= 1e-5 and frac >= 0.99, (rel, frac)
    return rel, frac


@pytest.mark.parametrize("frame", range(3))
def test_buffers_match_reference(pair, frame):
    got, want = pair["torch"][2][frame], pair["jax"][2][frame]
    for k in BUFFERS:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["pt test"], want["pt test"])
    np.testing.assert_allclose(got["pt albedo"], want["pt albedo"], rtol=1e-5, atol=1e-5)
    near = np.isclose(got["pt normal"], want["pt normal"], rtol=1e-5, atol=1e-5).all(-1)
    assert near.mean() >= 0.98, near.mean()
    np.testing.assert_allclose(got["pt normal"], want["pt normal"], rtol=1e-3, atol=1e-3)
    for k in ("pt frame", "pt accum", "final result"):
        rel, frac = _radiance_close(got[k], want[k])
        print(f"frame {frame} {k}: rel MSE {rel:.3e}, within rtol 1e-4 {frac:.4f}")
    assert got["pt frame"].mean() > 0.0
    np.testing.assert_array_equal(got["pt frame"], got["pt accum"])


def test_pass_state_and_buffer_names_match(pair):
    (js, jpt, _), (ts, tpt, _) = pair["jax"], pair["torch"]
    assert (tpt.sample_cnt, tpt.seed) == (jpt.sample_cnt, jpt.seed) == (3, 3)
    assert ts.buffers.displayable_names() == js.buffers.displayable_names()
    for k in BUFFERS:
        tb, jb = ts.buffers[k], js.buffers[k]
        assert (tb.desc.width, tb.desc.height, tb.desc.flag) == (
            jb.desc.width, jb.desc.height, jb.desc.flag), k
        assert tb.array.device.type == "cpu"
    assert tpt.inspector().keys() == jpt.inspector().keys()
    assert {k: v for k, v in tpt.inspector().items() if k != "time_ms"} == {
        k: v for k, v in jpt.inspector().items() if k != "time_ms"}


def test_events_restart_accumulation_in_both(pair):
    """A camera drag, then set_max_depth, each restart accumulation: the
    next frame is frame 0 of a new sequence at the next seed; the two
    packages stay in step and their frames still agree."""
    for trigger in ("drag", "max_depth"):
        shots = {}
        for name in ("jax", "torch"):
            system, pt, _ = pair[name]
            seed_before = pt.seed
            if trigger == "drag":
                system.events.dispatch(MOUSE_DRAGGING, (12.0, -5.0))
            else:
                pt.set_max_depth(2)
            assert pt._dirty
            system.run(max_frames=1)
            assert pt.sample_cnt == 1 and pt.seed == seed_before + 1
            system.run(max_frames=1)
            assert pt.sample_cnt == 2
            shots[name] = _snapshot(system)
        assert pair["torch"][1]._config.max_depth == pair["jax"][1]._config.max_depth
        np.testing.assert_allclose(pair["torch"][0].world.camera.to_world,
                                   pair["jax"][0].world.camera.to_world, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(shots["torch"]["pt test"], shots["jax"]["pt test"])
        _radiance_close(shots["torch"]["pt frame"], shots["jax"]["pt frame"])
    assert pair["torch"][1].seed == pair["jax"][1].seed


def test_instance_edit_refits_to_the_reference_tables(pair):
    """Moving the light and hiding the floor: both worlds refit on the
    device (flatten/refit.py) without a re-flatten. The port's tables keep
    their shapes, equal the reference's refit tables bit for bit, and agree
    with a full flatten of the edited scene on every live triangle (the
    refit keeps a hidden triangle's p0 and zeroes its edges; the flatten
    zeroes the whole row: both never hit)."""
    tables = {}
    for name, transform_cls in (("jax", JaxTransform), ("torch", Transform)):
        system, pt, _ = pair[name]
        before, _ = system.world.get_scene_data()
        ro = system.world.get_render_object("Light")
        assert ro is not None
        pt._dirty = False
        ro.apply_transform(transform_cls().translate(0.25, 0.0, -0.1))
        assert pt._dirty
        system.world.get_render_object("Floor").set_visible(False)
        data, config = system.world.get_scene_data()
        assert type(system.world._refit).__name__ == "RefitData"
        assert np.asarray(data.tris.packed).shape == np.asarray(before.tris.packed).shape
        assert config.tri_count == 4
        tables[name] = [np.asarray(t) for t in (
            data.tris.packed, data.tris.chunk_boxes, data.emitters.packed,
            data.emitters.select_cdf, data.spheres.attrs)]
    for got, want in zip(tables["torch"], tables["jax"]):
        np.testing.assert_array_equal(got, want)
    full, _ = jax_flatten(pair["jax"][0].world.scene)
    got = tables["torch"][0]
    live = np.abs(got[:, 3:9]).sum(axis=1) >= 1e-6
    assert live.sum() == 2  # the light; the floor's two triangles are degenerate
    np.testing.assert_allclose(got[live], np.asarray(full.tris.packed)[live],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tables["torch"][2], np.asarray(full.emitters.packed),
                               rtol=1e-6, atol=1e-6)
    for name in ("jax", "torch"):
        pair[name][0].world.get_render_object("Floor").set_visible(True)


@pytest.mark.parametrize("tone_mapping,gamma,stride", [
    (True, True, 1), (False, True, 1), (True, False, 1), (False, False, 1), (True, True, 2)])
def test_to_display_u8_matches_reference(tone_mapping, gamma, stride):
    """The display transfer on seeded radiance: uint8 within 1 level of
    the reference (pow and the ACES quotient round differently)."""
    r = np.random.default_rng(3)
    rgb = (r.random((16, 24, 3), dtype=np.float32) ** 3 * 8.0).astype(np.float32)
    rgb[0, 0] = [-0.5, 0.0, 100.0]
    want = np.asarray(jax_tonemap.to_display_u8(jnp.asarray(rgb), tone_mapping, gamma, stride))
    got = tonemap.to_display_u8(torch.from_numpy(rgb), tone_mapping, gamma, stride)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1
    lin = tonemap.aces_gamma_to_display(torch.from_numpy(rgb), tone_mapping, gamma).numpy()
    np.testing.assert_allclose(
        lin, np.asarray(jax_tonemap.aces_gamma_to_display(jnp.asarray(rgb), tone_mapping, gamma)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_expand_to_rgba_matches_reference(channels):
    r = np.random.default_rng(channels)
    arr = r.random((6 * 4, channels), dtype=np.float32)
    if channels == 1:
        arr = arr[:, 0]
    want = np.asarray(jax_tonemap.expand_to_rgba(jnp.asarray(arr), 6, 4))
    got = tonemap.expand_to_rgba(torch.from_numpy(arr), 6, 4).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{"display": "web"}, {"display": "window"},
                                {"has_display": True}])
def test_display_clients_are_refused(kw):
    """The name is older than the clients: each spelling now builds its
    client (the reference's System does the same) and starts no thread;
    the web server starts with ``run(threaded=True)`` or ``start()``."""
    import threading

    from pupiloptixlab_tpu_torch.display import DisplayClient
    from pupiloptixlab_tpu_torch.display.web import WebDisplay

    before = threading.active_count()
    system = System(device="cpu", web_port=0, **kw)
    want = WebDisplay if kw.get("display") == "web" else DisplayClient
    assert type(system.display) is want
    assert type(JaxSystem(web_port=0, **kw).display).__name__ == want.__name__
    assert threading.active_count() == before
    assert getattr(system.display, "_server", None) is None
    assert System(device="cpu").display is None


def test_unported_modes_raise_and_are_not_swallowed(monkeypatch):
    """spectral=True and PUPIL_SANITIZE reach the integrator: the spectral
    frame draws its wavelengths (so its test AOV is another draw than the
    RGB frame's), and under PUPIL_SANITIZE the pass raises SanitizerError
    on a frame with bad values instead of swallowing it."""
    import dataclasses

    from pupiloptixlab_tpu_torch.flatten.types import TEX_RGB
    from pupiloptixlab_tpu_torch.utils.debug import SanitizerError

    tests = []
    for spectral in (True, False):
        system = System(device="cpu")
        pt = PTPass(spectral=spectral, max_depth=2)
        system.add_pass(pt)
        assert system.set_scene(SCENE)
        system.run(max_frames=1)
        assert pt._config.spectral is spectral
        assert bool(torch.isfinite(system.buffers["pt frame"].array).all())
        tests.append(system.buffers["pt test"].array.clone())
    assert not torch.equal(*tests)
    monkeypatch.setenv("PUPIL_SANITIZE", "1")
    system = System(device="cpu")
    pt = PTPass(max_depth=2)
    system.add_pass(pt)
    assert system.set_scene(SCENE)
    system.run(max_frames=1)
    assert pt._config.debug_checks
    tex = pt._scene_data.textures.packed.clone()
    tex[:, TEX_RGB] = float("nan")
    pt._scene_data = dataclasses.replace(pt._scene_data, textures=dataclasses.replace(
        pt._scene_data.textures, packed=tex))
    with pytest.raises(SanitizerError, match="radiance"):
        system.run(max_frames=1)


def test_entry_points_default_to_the_card():
    """Without a CUDA device the runtime raises; it never drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    for make in (System, World, BufferManager):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_profile_frame_busy_share_and_card_only():
    """The frame profiler's busy time is the union of device intervals, and
    without a CUDA device it raises instead of profiling the CPU."""
    from pupiloptixlab_tpu_torch import profile_frame

    assert profile_frame._busy_us([(10, 12), (0, 5), (3, 8)]) == 10.0
    assert profile_frame._busy_us([]) == 0.0
    assert profile_frame._short("void k<(4)>(float const*, int)") == "void k<(4)>"
    assert profile_frame._short("(anonymous namespace)::g(int)") == "(anonymous namespace)::g"
    assert profile_frame._short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD "
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        profile_frame.main(["scene.xml"])


def test_buffer_manager_registry():
    bm = BufferManager(device="cpu")
    buf = bm.alloc(BufferDesc(name="a", flag=BufferFlag.ALLOW_DISPLAY, width=3, height=2))
    assert tuple(buf.array.shape) == (6, 4) and float(buf.array.abs().sum()) == 0.0
    bm.alloc(BufferDesc(name="b", width=3, height=2, channels=1), zero=False)
    assert bm["b"].array is None and "b" in bm and bm.get("c") is None
    bm.add("c", torch.ones(6), width=3, height=2)
    assert bm["c"].desc.channels == 1 and bm.displayable_names() == ["a"]
    bm.set_array("b", torch.zeros(6))
    assert tuple(bm["b"].array.shape) == (6,)
    bm.clear()
    assert "a" not in bm


def test_failed_scene_load_keeps_the_system_running(tmp_path):
    system = System(device="cpu")
    system.add_pass(PTPass())
    assert not system.set_scene(tmp_path / "missing.xml")
    system.run(max_frames=1)  # no scene: the pass has nothing to do
    assert system.passes[0].sample_cnt == 0
