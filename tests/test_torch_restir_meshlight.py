"""ReSTIR DI under a mesh light of 20,480 emissive triangles
(``data/meshlight_env.xml``: mesh_env plus a second icosphere made an area
emitter, 40,962 triangles on the BVH route), at a small film on the CPU, at
the benchmark's settings (M = 32, 5 spatial taps within 30 pixels, the
temporal cap's default of 20 M).

* The port's ``restir_frame`` over 4 frames, the history reset before the
  third, against the benchmark's plain reference
  (``benchmark/reference/render/restir.py``: its own loader, flatten and
  brute sweep) chained on its own rows over the whole film: the frames'
  radiance and the accumulation equal bit for bit, and the packed rows too
  at every pixel with a primary hit. A pixel without one stores the normal
  of the primitive its ray missed last, which the BVH and the brute sweep
  report differently (``test_torch_restir.py``), and that normal's candidate
  weights in w_sum: columns 10 and 16-18 may differ there, every other
  column is equal, and no merge or shading reads such a row (each is gated
  by the pixel's hit and by similarity).
* The reference's one-frame recomputation at a few pixels, from the port's
  own input rows, equals the port's frame at those pixels.
* ``RESTIR_STATS`` switched on changes no number of a frame, and counts
  its work and times its seven stages.
* The emitter table's rows, which ``flatten_scene`` now builds for all the
  faces of a mesh light at once, equal a per-face loop's bit for bit.
* On the card (``card`` marker; skips without CUDA), the unbiasedness check
  of the JAX package's ``tests/test_restir.py::test_restir_di_matches_pt_direct``
  restated on this scene with its statistical tolerance: ReSTIR DI's mean
  over frames against the path tracer's direct light (depth 2), on the whole
  scene, and under the mesh light alone (the envmap taken out: that test's
  scene has area lights only) with RIS alone, each merge alone and both.
  Its settings (96x54, M = 4, 2 taps within 8 pixels) are that test's; its
  sample counts are not: the rough-conductor ball's glints of the small
  light and of the envmap, which the estimators sample differently, keep
  the image's mean at 48 PT samples and 24 frames several percent from its
  expectation, so the card takes 1,024 of each, hours on a CPU.

  Two biases show, neither of them RIS's (whose mean under the mesh light
  alone reads 0.9997 of PT's):

  - the envmap's NEE sample (``emitter._env_sample_direct``, as upstream
    ``env.h``) takes the corner direction of the texel its CDFs pick and
    divides by the density at that corner, which reads the map's light
    1.5-2.7% low at the floor's and the ball's normals. ReSTIR adds that
    sample with no MIS and carries all of it; the path tracer weights it
    against its BSDF sample and carries less;
  - the merges combine reservoirs with the biased 1/M weights, which lose
    the light of samples a merged reservoir's target cannot reach here: on
    the glossy ball (alpha 0.15) about half a percent a frame with the
    spatial merge alone, but the temporal merge carries each frame's output
    into the next at up to 20 M, so with both merges the loss compounds:
    the mesh light alone reads 0.848, the ball 0.78.

  The whole scene's ratio reads 0.9806 (margin 0.0006); the mesh light
  alone with both merges fails, a defect of the biased combination left
  open (an unbiased one evaluates the winner's target at every merged
  reservoir's pixel, as the paper's unbiased variant does).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.flatten.flatten import camera_block as ref_camera_block
from benchmark.reference.flatten.flatten import flatten_scene as ref_flatten
from benchmark.reference.pixels import Reference
from benchmark.reference.render import restir as ref_restir
from benchmark.reference.scene.scene import load_scene as ref_load_scene
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.flatten.flatten import transform_points
from pupiloptixlab_tpu_torch.flatten.types import EM_AREA, EM_V0P, EM_V1P, EM_V2P
from pupiloptixlab_tpu_torch.render import restir as pre
from pupiloptixlab_tpu_torch.render.integrator import render
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.scene.emitters import EmitterType

SCENE = Path(__file__).resolve().parents[1] / "data" / "meshlight_env.xml"
FILM = (32, 18)
M, TAPS, RADIUS = 32, 5, 30
SEEDS = (7, 8, 9, 10)
RESET_AT = 2
MISS_COLS = [10, 16, 17, 18]


@pytest.fixture(scope="module")
def port():
    scene = load_scene(SCENE)
    scene.sensor.film.w, scene.sensor.film.h = FILM
    # the viewer's flatten (World: with the refit records, which keeps an
    # emissive scene on the baked BVH route)
    data, config, _ = flatten_scene(scene, return_refit=True, device="cpu")
    assert config.bvh_nodes > 0 and not config.instanced
    assert config.tri_count == 40962 and config.emitter_count == 20480 and config.has_env
    return data, config, camera_block_from_scene(scene, device="cpu")


@pytest.fixture(scope="module")
def ref():
    scene = ref_load_scene(SCENE)
    scene.sensor.film.w, scene.sensor.film.h = FILM
    data, config = ref_flatten(scene, device="cpu")
    r = Reference(scene, data, config, torch.device("cpu"))
    return r, ref_camera_block(r.camera(), "cpu")


def _frame(port, seed, inp, accum, cnt):
    data, config, camera = port
    return pre.restir_frame(data, camera, seed, inp, accum, cnt, config, m_candidates=M,
                            spatial_taps=TAPS, spatial_radius=RADIUS)


@pytest.fixture(scope="module")
def frames(port):
    """The port's 4 frames: each one's seed, count, input rows (None after a
    reset: zeros), output rows, radiance and accumulation after it."""
    _, config, _ = port
    n = config.width * config.height
    out, accum, rows, cnt = [], None, None, 0
    for i, seed in enumerate(SEEDS):
        if i in (0, RESET_AT):
            accum, rows, cnt = torch.zeros((n, 3)), torch.zeros((n, pre.N_PACK)), 0
            inp = None
        else:
            inp = rows
        accum, rows, rad = _frame(port, seed, rows, accum, cnt)
        out.append({"seed": seed, "cnt": cnt, "inp": inp, "out": rows, "rad": rad,
                    "accum": accum.clone()})
        cnt += 1
    return out


def _ref_frame(ref, seed, prev, pix):
    r, cam = ref
    return ref_restir.restir_pixels(r.data, r.config, cam, seed, prev, pix, M, TAPS, RADIUS)


def test_four_frames_equal_the_reference(port, ref, frames):
    _, config, _ = port
    n = config.width * config.height
    prev, since_reset = None, []
    for i, f in enumerate(frames):
        if i == RESET_AT:
            prev, since_reset = None, []
        want = _ref_frame(ref, f["seed"], prev, np.arange(n))
        prev = want["rows"]
        since_reset.append(want["radiance"])
        hit = want["hit"]
        assert 0 < int(hit.sum()) < n
        assert torch.equal(f["rad"], want["radiance"]), i
        assert torch.equal(f["out"][hit], want["rows"][hit]), i
        same = [c for c in range(pre.N_PACK) if c not in MISS_COLS]
        assert torch.equal(f["out"][~hit][:, same], want["rows"][~hit][:, same]), i
        assert torch.equal(f["accum"], ref_restir.blend_frames(since_reset)), i
    # the reservoirs took light, the temporal history built up and the
    # reset cleared it (a frame without history merges at most 1 + TAPS
    # reservoirs of M candidates each)
    assert float(frames[0]["out"][:, 10].max()) > 0.0
    m = [float(f["out"][:, 11].max()) for f in frames]
    assert m[1] > M * (1 + TAPS) >= max(m[0], m[2])


def test_the_reference_at_a_few_pixels_from_the_ports_rows(port, ref, frames):
    _, config, _ = port
    pix = np.array([0, 37, 101, 250, 333, 402, 511, config.width * config.height - 1])
    for f in frames[1], frames[3]:
        want = _ref_frame(ref, f["seed"], f["inp"], pix)
        assert torch.equal(f["rad"][pix], want["radiance"])
        hit = want["hit"]
        assert bool(hit.any())
        assert torch.equal(f["out"][pix][hit], want["rows"][hit])


def test_stats_switched_on_change_no_number(port, frames):
    _, config, _ = port
    n = config.width * config.height
    f = frames[1]
    accum = frames[0]["accum"].clone()
    pre.RESTIR_STATS["enabled"] = True
    try:
        accum, rows, rad = _frame(port, f["seed"], f["inp"], accum, f["cnt"])
    finally:
        pre.RESTIR_STATS["enabled"] = False
    stats = dict(pre.RESTIR_STATS)
    assert torch.equal(rad, f["rad"]) and torch.equal(rows, f["out"])
    assert torch.equal(accum, f["accum"])
    assert stats["candidates"] == n * M and stats["merges"] == n * (1 + TAPS)
    assert 0 < stats["shadow_rays"] <= n and 0 < stats["env_rays"] <= n
    assert list(stats["stage_ms"]) == list(pre.STAGES)
    assert all(v >= 0.0 for v in stats["stage_ms"].values())
    # switched off again: the next frame leaves the counter as it was
    _frame(port, f["seed"], f["inp"], frames[0]["accum"].clone(), f["cnt"])
    assert pre.RESTIR_STATS == {**stats, "enabled": False}


def test_mesh_light_rows_equal_a_per_face_loop(port):
    data, _, _ = port
    scene = load_scene(SCENE)
    light = next(ins for ins in scene.shape_instances if ins.is_emitter)
    world_p = transform_points(light.shape.mesh.positions, light.transform.matrix)
    world_p = world_p.astype(np.float32)
    idx = light.shape.mesh.indices.astype(np.int64)
    area = np.array([0.5 * float(np.linalg.norm(np.cross(world_p[b] - world_p[a],
                                                            world_p[c] - world_p[a])))
                     for a, b, c in idx], np.float32)
    em = data.emitters.packed.numpy()
    assert em.shape[0] == idx.shape[0]
    assert np.array_equal(em[:, EM_AREA], area)
    for col, k in ((EM_V0P, 0), (EM_V1P, 1), (EM_V2P, 2)):
        assert np.array_equal(em[:, col], world_p[idx[:, k]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA): the check takes a card's sample counts")
    return torch.device("cuda")


def _downsample(img, f=8):
    h, w = img.shape[:2]
    return img[: h // f * f, : w // f * f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def direct_light_ratio(device, frames: int = 1024, env: bool = True, temporal: bool = True,
                       spatial: bool = True) -> tuple[float, float]:
    """ReSTIR DI's mean over ``frames`` frames against PT's direct light at
    as many samples (96x54; M = 4, 2 taps within 8 pixels): the ratio of the
    images' means and the median relative error of their 8x8 buckets.
    Without ``env`` the scene's envmap is taken out; without ``temporal``
    each frame starts from empty reservoirs, and without ``spatial`` it
    taps no neighbour."""
    scene = load_scene(SCENE)
    scene.sensor.film.w, scene.sensor.film.h = 96, 54
    if not env:
        scene.emitters = [e for e in scene.emitters if e.type != EmitterType.ENV_MAP]
    data, config, _ = flatten_scene(scene, return_refit=True, device=device)
    camera = camera_block_from_scene(scene, device=device)
    assert config.has_env == env and config.emitter_count == 20480
    n = config.width * config.height
    cfg2 = dataclasses.replace(config, max_depth=2, accumulate=True)
    # reference: PT at depth 2 = emission + direct light (NEE + MIS)
    ref = render(data, camera, cfg2, spp=frames).cpu().numpy()

    accum = torch.zeros((n, 3), device=device)
    zeros = torch.zeros((n, pre.N_PACK), device=device)
    packed = zeros
    for s in range(frames):
        accum, out, _ = pre.restir_frame(data, camera, 1000 + s, packed, accum, s, cfg2,
                                         m_candidates=4, spatial_taps=2 if spatial else 0,
                                         spatial_radius=8)
        packed = out if temporal else zeros
    img = accum.cpu().numpy().reshape(config.height, config.width, 3)
    a, b = _downsample(img), _downsample(ref.reshape(img.shape))
    mask = b.mean(axis=-1) > 1e-3
    rel = np.abs(a - b).sum(axis=-1)[mask] / (b.sum(axis=-1)[mask] + 1e-3)
    return float(img.mean() / ref.mean()), float(np.median(rel))


@pytest.mark.card
def test_restir_di_matches_pt_direct(card):
    # ratio 0.9806 at 1,024 frames (margin 0.0006): the envmap's NEE bias and
    # the merges' under the mesh light (the module's docstring)
    ratio, median_rel = direct_light_ratio(card)
    assert abs(ratio - 1.0) < 0.02, ratio
    assert median_rel < 0.25, median_rel


@pytest.mark.card
@pytest.mark.parametrize("temporal,spatial", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_restir_di_matches_pt_direct_under_the_mesh_light_alone(card, temporal, spatial):
    # (True, True) reads 0.848: the biased combination's loss compounded by
    # the temporal history (the module's docstring), left open
    ratio, median_rel = direct_light_ratio(card, env=False, temporal=temporal, spatial=spatial)
    assert abs(ratio - 1.0) < 0.02, ratio
    assert median_rel < 0.25, median_rel
