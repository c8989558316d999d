"""Port parity: whole progressive frames (render_frame) on the CPU.

Four progressive frames at seeds 0-3 of

* data/mesh_env.xml at 128x8: one 8x128 pixel block, the BVH route and
  the block lane order, the envmap;
* data/oracle_mat.xml at 64x64: row-major lanes, spheres, all seven
  BSDFs, an area light and the constant env;

rendered by the JAX package and by the port from identical tables (the JAX
flatten's arrays through ``flatten/convert.py``), and once more from the
port's own flatten.

Tolerances:
* ``test`` AOV (one RNG draw per pixel): bit-equal.
* albedo and normal: allclose rtol 1e-5 / atol 1e-5.
* radiance (the accumulated frame): relative MSE <= 1e-5 and >= 99% of
  pixels within rtol 1e-4. A rare lane may take another branch after an
  ulp-level difference, which changes that pixel's path.

The JAX frame runs under ``jit``, where XLA's CPU backend fuses the
elementwise graph and contracts a*b+c into FMAs; PyTorch rounds every op.
On oracle_mat's small spheres a last-ulp difference in the hit position
grows to ~1e-4 in the sphere normal, so the jitted frames' normals are held
to 1e-5 on 98% of pixels and 1e-3 on all, and frame 0 is rendered once more
by the JAX package op by op (``jax.disable_jit``), where the normal must
meet 1e-5 everywhere.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.flatten import camera_block_from_scene as jax_camera
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.render.integrator import render_frame as jax_render_frame
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.flatten.convert import (
    camera_from_arrays,
    config_from_fields,
    scene_from_arrays,
)
from pupiloptixlab_tpu_torch.render.integrator import render, render_frame

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "data"
GROUPS = ("tris", "spheres", "curves", "materials", "textures", "emitters")
SEEDS = range(4)


def _load(name, w, h):
    scene = load_scene(DATA / name)
    scene.sensor.film.w, scene.sensor.film.h = w, h
    return scene


def _jax_tables(scene):
    jd, jc = jax_flatten(scene)
    jcam = jax_camera(scene)
    tree = {g: {f.name: np.asarray(getattr(getattr(jd, g), f.name))
                for f in dataclasses.fields(getattr(jd, g))} for g in GROUPS}
    config = config_from_fields(dataclasses.asdict(jc))
    cam = camera_from_arrays({f.name: np.asarray(getattr(jcam, f.name))
                              for f in dataclasses.fields(jcam)}, device="cpu")
    return (jd, jc, jcam), (scene_from_arrays(tree, config, device="cpu"), config, cam)


def _jax_frames(jd, jc, jcam, seeds):
    n = jc.width * jc.height
    acc = jnp.zeros((n, 3), jnp.float32)
    out = []
    for i in seeds:
        acc, bufs = jax_render_frame(jd, jcam, jnp.uint32(i), jnp.int32(i), acc, jc)
        out.append({k: np.asarray(v).copy() for k, v in bufs.items()})
    return out


def _torch_frames(data, config, cam, seeds):
    n = config.width * config.height
    acc = torch.zeros((n, 3), dtype=torch.float32)
    out = []
    for i in seeds:
        acc, bufs = render_frame(data, cam, i, i, acc, config)
        out.append({k: v.numpy().copy() for k, v in bufs.items()})
    return out


def _radiance_close(a, b):
    rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
    frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
    assert np.isfinite(a).all()
    assert rel <= 1e-5 and frac >= 0.99, (rel, frac)
    return rel, frac


def _check(got, want, normal_frac=1.0):
    for i, (g, w) in enumerate(zip(got, want)):
        rel, frac = _radiance_close(g["frame"], w["frame"])
        np.testing.assert_array_equal(g["test"], w["test"])
        np.testing.assert_allclose(g["albedo"], w["albedo"], rtol=1e-5, atol=1e-5)
        near = np.isclose(g["normal"], w["normal"], rtol=1e-5, atol=1e-5).all(-1)
        dn = float(np.abs(g["normal"] - w["normal"]).max())
        print(f"seed {i}: rel MSE {rel:.3e}, within rtol 1e-4 {frac:.4f}, "
              f"normal within 1e-5 {near.mean():.4f} (max |d| {dn:.2e})")
        assert near.mean() >= normal_frac
        np.testing.assert_allclose(g["normal"], w["normal"], rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def mesh_env():
    scene = _load("mesh_env.xml", 128, 8)
    (jd, jc, jcam), (data, config, cam) = _jax_tables(scene)
    assert config.bvh_nodes > 0 and config.has_env
    return scene, _jax_frames(jd, jc, jcam, SEEDS), _torch_frames(data, config, cam, SEEDS)


def test_mesh_env_frames_match_reference(mesh_env):
    _, want, got = mesh_env
    _check(got, want)
    np.testing.assert_allclose(got[0]["normal"], want[0]["normal"], rtol=1e-5, atol=1e-5)
    assert got[-1]["frame"].mean() > 0.0


def test_mesh_env_own_flatten_renders_the_same_frame(mesh_env):
    """The port's flatten gives the JAX flatten's tables, so its first
    frame is bit-identical to the one from the converted tables."""
    scene, _, converted = mesh_env
    data, config = flatten_scene(scene, device="cpu")
    got = _torch_frames(data, config, camera_block_from_scene(scene, device="cpu"), [0])
    for k in converted[0]:
        np.testing.assert_array_equal(got[0][k], converted[0][k], err_msg=k)


def test_oracle_mat_frames_match_reference():
    scene = _load("oracle_mat.xml", 64, 64)
    (jd, jc, jcam), (data, config, cam) = _jax_tables(scene)
    assert config.bvh_nodes == 0 and config.sphere_count == 7 and config.emitter_count == 2
    assert set(config.mat_types) == set(range(1, 8))
    got = _torch_frames(data, config, cam, SEEDS)
    _check(got, _jax_frames(jd, jc, jcam, SEEDS), normal_frac=0.98)

    with jax.disable_jit():
        eager = _jax_frames(jd, jc, jcam, [0])
    _check(got[:1], eager)
    np.testing.assert_allclose(got[0]["normal"], eager[0]["normal"], rtol=1e-5, atol=1e-5)

    own = _torch_frames(*flatten_scene(scene, device="cpu"), camera_block_from_scene(scene, device="cpu"), [0])
    np.testing.assert_array_equal(own[0]["frame"], got[0]["frame"])


def test_render_is_a_loop_of_frames():
    scene = _load("oracle_mat.xml", 16, 16)
    data, config = flatten_scene(scene, device="cpu")
    cam = camera_block_from_scene(scene, device="cpu")
    img = render(data, cam, config, spp=3, seed0=5)
    assert tuple(img.shape) == (16, 16, 3)
    acc = torch.zeros((256, 3))
    for i in range(3):
        render_frame(data, cam, 5 + i, i, acc, config)
    assert torch.equal(img.reshape(256, 3), acc)


@pytest.mark.parametrize("change", ["spectral", "debug_checks", "tile_perm"])
def test_unported_options_raise(change):
    """Options that raised before their slice was ported now render:
    spectral transport gives a finite frame of the usual buffers, the
    sanitizer adds its report (all zeros on oracle_mat), and ``tile_perm``
    on a chunk-sweep scene keeps its row-major lanes and is ignored, as the
    reference does, so the frame is the same."""
    scene = _load("oracle_mat.xml", 8, 8)
    data, config = flatten_scene(scene, device="cpu")
    cam = camera_block_from_scene(scene, device="cpu")
    _, plain = render_frame(data, cam, 0, 0, torch.zeros((64, 3)), config)
    plain = {k: v.clone() for k, v in plain.items()}
    if change == "tile_perm":
        _, got = render_frame(data, cam, 0, 0, torch.zeros((64, 3)), config,
                              tile_perm=torch.arange(1))
        assert all(torch.equal(got[k], plain[k]) for k in plain)
        return
    config = dataclasses.replace(config, **{change: True})
    _, got = render_frame(data, cam, 0, 0, torch.zeros((64, 3)), config)
    assert set(got) == set(plain) | ({"sanitizer"} if change == "debug_checks" else set())
    assert bool(torch.isfinite(got["frame"]).all())
    if change == "debug_checks":
        assert all(torch.equal(got[k], plain[k]) for k in plain)
        assert {k: int(v) for k, v in got["sanitizer"].items()} == dict.fromkeys(
            ("radiance", "albedo", "normal", "primary_t", "throughput"), 0)
    else:
        assert not torch.equal(got["test"], plain["test"])  # u_lam comes before it


def test_port_never_imports_jax():
    """In a fresh interpreter the port loads mesh_env with its own scene
    layer, flattens it, renders one 128x8 frame, and steps a System with a
    PTPass and a DenoisePass on oracle_mat (the denoiser and the matmul-form
    leaf test's modules come in through them), imports the offline batch
    (``render_frame_batch``, with its CUDA graph capture), and imports the multi-device
    modules (parallel/ with its dry run), spectral transport, the
    sanitizer, ReSTIR, the wavefront engine, checkpointing, profiling and
    the display clients, and steps a ComputePass under the web client, all
    on the CPU, importing neither jax nor any module of the JAX package. It runs with
    JAX_PLATFORMS=cpu set, which
    makes the JAX package's __init__ import jax: the stricter of the two
    environments."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
        from pupiloptixlab_tpu_torch.passes import DenoisePass, PTPass
        from pupiloptixlab_tpu_torch.render.integrator import render_frame, render_frame_batch
        from pupiloptixlab_tpu_torch.scene import load_scene
        from pupiloptixlab_tpu_torch.system import System
        scene = load_scene({str(DATA / "mesh_env.xml")!r})
        scene.sensor.film.w, scene.sensor.film.h = 128, 8
        data, config = flatten_scene(scene, device="cpu")
        acc, bufs = render_frame(data, camera_block_from_scene(scene, device="cpu"), 0, 0,
                                 torch.zeros((1024, 3)), config)
        assert bool(torch.isfinite(acc).all()) and float(acc.mean()) > 0
        system = System(device="cpu")
        system.add_pass(PTPass())
        system.add_pass(DenoisePass())
        assert system.set_scene({str(DATA / "oracle_mat.xml")!r})
        system.run(max_frames=2)
        frame = system.buffers["pt frame"].array
        assert system.passes[0].sample_cnt == 2 and float(frame.mean()) > 0
        assert bool(torch.isfinite(system.buffers["pt denoised"].array).all())
        import pupiloptixlab_tpu_torch.parallel
        import pupiloptixlab_tpu_torch.parallel.balance
        import pupiloptixlab_tpu_torch.parallel.dryrun
        import pupiloptixlab_tpu_torch.parallel.ring_sweep
        import pupiloptixlab_tpu_torch.parallel.sharding
        import pupiloptixlab_tpu_torch.scene.deep_soup
        import pupiloptixlab_tpu_torch.render.spectral
        import pupiloptixlab_tpu_torch.render.restir_gi
        import pupiloptixlab_tpu_torch.utils.debug
        from pupiloptixlab_tpu_torch.passes import ReSTIRPass
        from pupiloptixlab_tpu_torch.wavefront import render_wavefront
        import pupiloptixlab_tpu_torch.utils.checkpoint
        import pupiloptixlab_tpu_torch.utils.profiling
        import pupiloptixlab_tpu_torch.display.client
        import pupiloptixlab_tpu_torch.display.web
        from pupiloptixlab_tpu_torch.passes import ComputePass
        shell = System(display="web", web_port=0, device="cpu")
        shell.add_pass(ComputePass(lambda f, w, h: {{"ramp": torch.arange(w * h) * (f + 1.0)}},
                                   8, 4))
        shell.run(max_frames=2)
        assert shell.passes[0].frame_index == 2
        assert float(shell.buffers["ramp"].array[-1]) == 62.0
        assert shell.display.latest_image().shape == (4, 8, 3)
        foreign = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                         or m == "pupiloptixlab_tpu" or m.startswith("pupiloptixlab_tpu."))
        assert not foreign, foreign
        print("stands alone")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "stands alone" in out.stdout
