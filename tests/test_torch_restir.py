"""Port parity: ReSTIR DI and GI (render/restir.py, render/restir_gi.py)
and ReSTIRPass (passes/restir.py).

* Reservoir streaming converges to w_i / sum(w) (the reference's
  tests/test_restir.py:27, restated on the port).
* ``_pack`` / ``_unpack``: the (N, 19) column layout equals the
  reference's, value for value.
* Two DI frames and two GI frames on ``oracle_mat.xml`` at its own 64x64
  (an area light and a constant env: reservoirs, the env's extra NEE
  sample, delta and rough receivers), the second GI frame after a camera
  move with ``prev_camera`` (the motion warp), against the reference run op
  by op (``jax.disable_jit``) at equal seeds, each frame continuing from
  its own package's previous reservoirs and accumulation:
  - the RNG state after each frame equal, and the draws a pixel equal;
  - frame and accumulation: rel MSE <= 1e-5 and >= 99% of pixels within
    rtol 1e-4 (tests/test_torch_frame.py's gate);
  - packed reservoirs: >= 99.9% of the values within rtol 1e-4 + atol 1e-5
    and every column's rel MSE <= 1e-5 (a reservoir that takes another
    candidate after an ulp-level difference in a weight differs whole).
* Two DI frames on ``meshlight_env.xml`` at 32x18 (20,480 emissive
  triangles, the envmap, the BVH route of the viewer's tables: the JAX
  flatten with its refit records) at the benchmark's M = 32, 5 taps within
  30 pixels, the reference jitted, with the same gates.
* ``ReSTIRPass`` through ``System(device="cpu")`` equals the bare frame
  loop (DI, and GI across a camera edit), bit for bit.
* The BVH route: mesh_env plus one area-lit rectangle (a test scene built
  through the port's scene layer) takes K1/K2's route with reservoirs; its
  DI and GI frames and reservoirs equal those of the same scene flattened
  under ``PUPIL_NO_BVH`` (the brute sweep) at equal seeds (reservoirs on
  the pixels with a primary hit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pupiloptixlab_tpu.render.rng as jax_rng
import pupiloptixlab_tpu_torch.render.rng as torch_rng
from pupiloptixlab_tpu.flatten import camera_block_from_scene as jax_camera
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.render import restir as jre
from pupiloptixlab_tpu.render.restir_gi import restir_gi_frame as jax_gi_frame
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu.utils.math import Transform as JTransform
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.flatten.convert import (
    camera_from_arrays,
    config_from_fields,
    scene_from_arrays,
)
from pupiloptixlab_tpu_torch.passes import ReSTIRPass
from pupiloptixlab_tpu_torch.render import restir as pre
from pupiloptixlab_tpu_torch.render.restir_gi import restir_gi_frame
from pupiloptixlab_tpu_torch.render.vec import Vec3
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.scene.emitters import Emitter, EmitterType
from pupiloptixlab_tpu_torch.scene.materials import Material, MatType
from pupiloptixlab_tpu_torch.scene.shapes import ShapeInstance
from pupiloptixlab_tpu_torch.scene.textures import rgb_texture
from pupiloptixlab_tpu_torch.system import System
from pupiloptixlab_tpu_torch.utils.event import CAMERA_MOVE
from pupiloptixlab_tpu_torch.utils.math import Transform
from test_torch_frame import DATA, _jax_tables, _load


def test_reservoir_selection_frequencies():
    rs = np.random.RandomState(7)
    n = 4096
    weights = np.array([0.1, 1.0, 2.5, 0.4], np.float32)
    r = pre.Reservoir.zeros(n)
    for i, w in enumerate(weights):
        u = torch.from_numpy(rs.rand(n).astype(np.float32))
        r = r.update(u, Vec3.broadcast(torch.tensor([float(i), 0.0, 0.0]), n), Vec3.zeros(n),
                     Vec3.zeros(n), torch.ones(n), torch.full((n,), float(w)),
                     torch.full((n,), float(w)), torch.ones(n))
    sel = r.y_pos.x.numpy()
    freq = np.array([(sel == i).mean() for i in range(len(weights))])
    expect = weights / weights.sum()
    assert np.abs(freq - expect).max() < 0.03, (freq, expect)
    assert np.allclose(r.w_sum.numpy(), weights.sum())
    assert np.allclose(r.m.numpy(), len(weights))


def test_pack_layout_equals_reference():
    rs = np.random.RandomState(5)
    n = 33
    planes = rs.randn(19, n).astype(np.float32)

    def build(mod, vec, cast):
        p = [cast(x) for x in planes]
        r = mod.Reservoir(y_pos=vec(*p[0:3]), y_nrm=vec(*p[3:6]), y_rad=vec(*p[6:9]),
                          y_parea=p[9], w_sum=p[10], m=p[11], phat=p[12])
        gb = mod._GBuf(position=vec(*p[13:16]), normal=vec(*p[16:19]), wo_world=vec(*p[0:3]))
        return mod._pack(r, gb)

    got = build(pre, Vec3, torch.from_numpy)
    want = build(jre, JVec3, jnp.asarray)
    assert pre.N_PACK == jre.N_PACK == 19 and tuple(got.shape) == (n, 19)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), planes.T)
    r, pos, nrm = pre._unpack(got)
    jr, jpos, jnrm = jre._unpack(want)
    for a, b in zip((*r.y_pos, *r.y_nrm, *r.y_rad, r.y_parea, r.w_sum, r.m, r.phat, *pos, *nrm),
                    (*jr.y_pos, *jr.y_nrm, *jr.y_rad, jr.y_parea, jr.w_sum, jr.m, jr.phat,
                     *jpos, *jnrm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class _Draws:
    """Wraps a package's ``rng.next_floats`` to count the draws a lane
    and keep the last state it returned."""

    def __init__(self, mod, monkeypatch):
        self.count, self.state = 0, None
        inner = mod.next_floats

        def wrapped(state, n):
            state, us = inner(state, n)
            self.count += n
            self.state = state
            return state, us

        monkeypatch.setattr(mod, "next_floats", wrapped)

    def take(self):
        out = (self.count, np.asarray(self.state).astype(np.uint64) & 0xFFFFFFFF)
        self.count, self.state = 0, None
        return out


def _image_close(got, want):
    rel = float(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-30))
    frac = float(np.isclose(got, want, rtol=1e-4, atol=0.0).all(-1).mean())
    assert np.isfinite(got).all() and rel <= 1e-5 and frac >= 0.99, (rel, frac)
    return rel, frac


def _packed_close(got, want):
    near = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    col_rel = np.mean((got - want) ** 2, 0) / np.maximum(np.mean(want ** 2, 0), 1e-30)
    assert near.mean() >= 0.999 and col_rel.max() <= 1e-5, (near.mean(), col_rel.max())
    return near.mean()


def _moved_camera(scene, dx):
    """The reference scene's camera trucked along its right axis, as the
    reference's camera block and the port's."""
    m = scene.sensor.transform.matrix.copy()
    m[:3, 3] += m[:3, 0] * dx
    old = scene.sensor.transform
    scene.sensor.transform = JTransform(m.astype(np.float32))
    jcam = jax_camera(scene)
    scene.sensor.transform = old
    cam = camera_from_arrays({f.name: np.asarray(getattr(jcam, f.name))
                              for f in dataclasses.fields(jcam)}, device="cpu")
    return jcam, cam


@pytest.fixture(scope="module")
def oracle_mat():
    scene = _load("oracle_mat.xml", 64, 64)
    return scene, _jax_tables(scene)


def _run_pair(monkeypatch, frames):
    """frames: [(jax call, port call)], each taking and returning
    (accum, packed); returns per frame the two packages' outputs and RNG
    draws."""
    jd, td = _Draws(jax_rng, monkeypatch), _Draws(torch_rng, monkeypatch)
    out = []
    for jcall, tcall in frames:
        with jax.disable_jit():
            jout = jcall()
        jdraws = jd.take()
        tout = tcall()
        tdraws = td.take()
        out.append((jout, tout, jdraws, tdraws))
    return out


def _check_frames(out, n):
    for i, (jout, tout, (jc, js), (tc, ts)) in enumerate(out):
        assert jc == tc and js.shape == (n,), (jc, tc)
        np.testing.assert_array_equal(ts, js)
        ja, jp, jr = (np.asarray(x) for x in jout)
        ta, tp, tr = (x.numpy() for x in tout)
        rel, frac = _image_close(tr, jr)
        _image_close(ta, ja)
        near = _packed_close(tp, jp)
        print(f"frame {i}: {tc} draws a pixel, rel MSE {rel:.3e}, within rtol 1e-4 "
              f"{frac:.4f}, packed values near {near:.5f}")


def test_di_frames_match_reference(oracle_mat, monkeypatch):
    _, ((jd, jc, jcam), (data, config, cam)) = oracle_mat
    assert config.emitter_count == 2 and config.has_env and config.bvh_nodes == 0
    n = config.width * config.height
    state = {"j": (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, pre.N_PACK), jnp.float32)),
             "t": (torch.zeros((n, 3)), torch.zeros((n, pre.N_PACK)))}

    def frame(s):
        def jcall():
            acc, packed = state["j"]
            out = jre.restir_frame(jd, jcam, jnp.uint32(11 + s), packed, acc, jnp.int32(s), jc,
                                   m_candidates=4, spatial_taps=2, spatial_radius=8)
            state["j"] = (out[0], out[1])
            return out

        def tcall():
            acc, packed = state["t"]
            out = pre.restir_frame(data, cam, 11 + s, packed, acc, s, config, m_candidates=4,
                                   spatial_taps=2, spatial_radius=8)
            state["t"] = (out[0], out[1])
            return tuple(x.clone() for x in out)

        return jcall, tcall

    out = _run_pair(monkeypatch, [frame(0), frame(1)])
    _check_frames(out, n)
    assert out[0][2][0] == 2 + 4 * 4 + 1 + 3 * 2 + 2
    assert float(out[1][1][1][:, 11].max()) > 4.0  # history merged in frame 2


def test_di_frames_on_the_mesh_light_scene_match_reference():
    scene = _load("meshlight_env.xml", 32, 18)
    jd, jc, _ = jax_flatten(scene, return_refit=True)
    jcam = jax_camera(scene)
    groups = ("tris", "spheres", "curves", "materials", "textures", "emitters")
    tree = {g: {f.name: np.asarray(getattr(getattr(jd, g), f.name))
                for f in dataclasses.fields(getattr(jd, g))} for g in groups}
    config = config_from_fields(dataclasses.asdict(jc))
    data = scene_from_arrays(tree, config, device="cpu")
    cam = camera_from_arrays({f.name: np.asarray(getattr(jcam, f.name))
                              for f in dataclasses.fields(jcam)}, device="cpu")
    assert config.bvh_nodes > 0 and not config.instanced and config.emitter_count == 20480
    n = config.width * config.height
    j = (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, pre.N_PACK), jnp.float32))
    t = (torch.zeros((n, 3)), torch.zeros((n, pre.N_PACK)))
    for s in range(2):
        ja, jp, jr = jre.restir_frame(jd, jcam, jnp.uint32(21 + s), j[1], j[0], jnp.int32(s), jc,
                                      m_candidates=32, spatial_taps=5, spatial_radius=30)
        ta, tp, tr = pre.restir_frame(data, cam, 21 + s, t[1], t[0], s, config,
                                      m_candidates=32, spatial_taps=5, spatial_radius=30)
        j, t = (ja, jp), (ta.clone(), tp)
        _image_close(tr.numpy(), np.asarray(jr))
        _image_close(ta.numpy(), np.asarray(ja))
        _packed_close(tp.numpy(), np.asarray(jp))
    assert float(tp[:, 11].max()) > 32 * (1 + 5)  # the second frame merged a history


def test_gi_frames_match_reference(oracle_mat, monkeypatch):
    scene, ((jd, jc, jcam), (data, config, cam)) = oracle_mat
    n = config.width * config.height
    jcam1, cam1 = _moved_camera(scene, 0.15)
    state = {"j": (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, pre.N_PACK), jnp.float32)),
             "t": (torch.zeros((n, 3)), torch.zeros((n, pre.N_PACK)))}

    def frame(s, cams, prev):
        def jcall():
            acc, packed = state["j"]
            out = jax_gi_frame(jd, cams[0], jnp.uint32(21 + s), packed, acc, jnp.int32(s), jc,
                               spatial_radius=8, prev_camera=prev and prev[0])
            state["j"] = (out[0], out[1])
            return out

        def tcall():
            acc, packed = state["t"]
            out = restir_gi_frame(data, cams[1], 21 + s, packed, acc, s, config,
                                  spatial_radius=8, prev_camera=prev and prev[1])
            state["t"] = (out[0], out[1])
            return tuple(x.clone() for x in out)

        return jcall, tcall

    out = _run_pair(monkeypatch, [frame(0, (jcam, cam), None),
                                  frame(1, (jcam1, cam1), (jcam, cam))])
    _check_frames(out, n)


def _system_frames(make_pass, frames, move_before=None):
    """Frames of a pass through System(device="cpu") on oracle_mat, with a
    camera move (CAMERA_MOVE, as the canvas sends it) before frame
    ``move_before``; returns each frame's buffers, reservoirs and camera."""
    system = System(device="cpu")
    p = make_pass()
    system.add_pass(p)
    assert system.set_scene(DATA / "oracle_mat.xml")
    out = []
    for i in range(frames):
        if i == move_before:
            system.events.dispatch(CAMERA_MOVE, (3.0, 0.0, 0.0))
        cam = system.world.get_camera_block()
        system.run(max_frames=1)
        out.append((system.buffers["restir frame"].array.clone(),
                    system.buffers["restir accum"].array.clone(), p._reservoirs.clone(), cam))
    system.destroy()
    return out


def test_restir_pass_equals_frame_loop():
    """DI: 2 frames. GI: 3 frames with a camera move before the third,
    which keeps the reservoirs (motion warp) and restarts the blend."""
    scene = load_scene(DATA / "oracle_mat.xml")
    data, config = flatten_scene(scene, device="cpu")
    config = dataclasses.replace(config, accumulate=True)
    n = config.width * config.height

    got = _system_frames(lambda: ReSTIRPass(m_candidates=4), 2)
    acc, packed = torch.zeros((n, 3)), torch.zeros((n, pre.N_PACK))
    for s in range(2):
        acc, packed, frame = pre.restir_frame(data, got[s][3], s, packed, acc, s, config,
                                              m_candidates=4)
        for a, b in zip(got[s][:3], (frame, acc, packed)):
            assert torch.equal(a, b)

    got = _system_frames(lambda: ReSTIRPass(gi=True), 3, move_before=2)
    assert not torch.equal(got[2][3].camera_to_world, got[1][3].camera_to_world)
    acc, packed, prev = torch.zeros((n, 3)), torch.zeros((n, pre.N_PACK)), None
    for s, cnt in ((0, 0), (1, 1), (2, 0)):
        if s == 2:
            acc = torch.zeros((n, 3))
        # the pass's spatial_taps (3) reach the GI frame too, as the reference's do
        acc, packed, frame = restir_gi_frame(data, got[s][3], s, packed, acc, cnt, config,
                                             spatial_taps=3, prev_camera=prev)
        prev = got[s][3]
        for a, b in zip(got[s][:3], (frame, acc, packed)):
            assert torch.equal(a, b)


def lit_mesh_env(width: int, height: int):
    """data/mesh_env.xml plus one area-lit rectangle above its floor (an
    envmap alone gives ReSTIR no area light to resample)."""
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = width, height
    scene.shape_instances.append(ShapeInstance(
        shape=scene.shape_manager.load_rectangle(),
        material=Material(type=MatType.DIFFUSE),
        transform=Transform().scale(0.8, 0.8, 1).rotate(1, 0, 0, 90).translate(0.0, 3.0, 0.0),
        emitter=Emitter(type=EmitterType.AREA, radiance=rgb_texture(8.0, 8.0, 8.0)),
        is_emitter=True,
    ))
    return scene


def test_bvh_route_with_area_light_equals_sweep(monkeypatch):
    scene = lit_mesh_env(32, 16)
    data, config = flatten_scene(scene, device="cpu")
    assert config.bvh_nodes > 0 and config.emitter_count == 2 and config.tri_count > 1024
    monkeypatch.setenv("PUPIL_NO_BVH", "1")
    data_s, config_s = flatten_scene(scene, device="cpu")
    assert config_s.bvh_nodes == 0
    cam = camera_block_from_scene(scene, device="cpu")
    n = config.width * config.height
    for fn, kw in ((pre.restir_frame, {"m_candidates": 4}), (restir_gi_frame, {})):
        outs = []
        for d, c in ((data, config), (data_s, config_s)):
            acc, packed = torch.zeros((n, 3)), torch.zeros((n, pre.N_PACK))
            for s in range(2):
                acc, packed, frame = fn(d, cam, s, packed, acc, s, c, **kw)
            outs.append((acc, packed))
        (a, p), (b, q) = outs
        assert float(p[:, 10].max()) > 0.0  # reservoirs took light samples
        assert torch.isfinite(a).all() and float(a.mean()) > 0.0
        # a miss pixel (its G-buffer at MAX_DISTANCE) takes the missed
        # primitive's normal, which the two routes report differently; its
        # reservoir is never merged or shaded (gated by the pixel's hit)
        hit = p[:, 13:16].abs().amax(1) < 1e10
        assert torch.equal(a, b) and bool(hit.any()) and torch.equal(p[hit], q[hit])
