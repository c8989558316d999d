"""Port parity: RNG streams, sampling helpers and camera rays.

The same inputs, made with numpy from a seed, go through the JAX package
and its PyTorch port on the CPU.

Tolerances: the TEA/LCG streams are integer arithmetic and must match bit
for bit. Camera rays allclose 1e-6: XLA's CPU backend contracts a*b+c
into fused multiply-adds (measured on this suite's inputs: about 1 lane
in 300 differs by one ulp), PyTorch rounds every op.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.render import camera as jcam
from pupiloptixlab_tpu.render import integrator as jint
from pupiloptixlab_tpu.render import rng as jrng
from pupiloptixlab_tpu.render import sampling as jsmp
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.flatten.flatten import camera_block_from_scene
from pupiloptixlab_tpu_torch.render import camera as tcam
from pupiloptixlab_tpu_torch.render import integrator as tint
from pupiloptixlab_tpu_torch.render import rng as trng
from pupiloptixlab_tpu_torch.render import sampling as tsmp
from pupiloptixlab_tpu_torch.render.vec import Vec3 as TVec3

from pathlib import Path

DATA = Path(__file__).resolve().parent.parent / "data"


@pytest.mark.parametrize("seed", [0, 1, 7, 0xFFFFFFFF, 123456789])
def test_tea_lcg_streams_bit_equal(seed):
    r = np.random.default_rng(seed % 1000)
    ids = r.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    ids[:8] = [0, 1, 2, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1, 12345]
    js = jrng.tea_init(jnp.asarray(ids), jnp.uint32(seed))
    ts = trng.tea_init(torch.from_numpy(ids.astype(np.int64)), seed)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    js, jus = jrng.next_floats(js, 9)
    ts, tus = trng.next_floats(ts, 9)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    for a, b in zip(jus, tus):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_next_float_is_24_bit_fraction():
    state = torch.tensor([0, 1, 0xFFFFFF, 0xFFFFFFFF], dtype=torch.int64)
    new, u = trng.next_float(state)
    want = ((state * 1664525 + 1013904223) & 0xFFFFFFFF)
    assert torch.equal(new, want)
    assert torch.equal(u, (want & 0xFFFFFF).to(torch.float32) / 2**24)
    assert float(u.max()) < 1.0


@pytest.mark.parametrize("w,h", [(128, 8), (256, 16), (1920, 1080)])
def test_block_order_helpers(w, h):
    want = np.asarray(jint._block_pix(w, h))
    got = tint._block_pix(w, h, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    v = np.random.default_rng(w).standard_normal((w * h, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tint._block_decode(torch.from_numpy(v), w, h).numpy(),
        np.asarray(jint._block_decode(jnp.asarray(v), w, h)),
    )
    # decode inverts the block order
    dec = tint._block_decode(torch.from_numpy(want.astype(np.int64)), w, h)
    assert torch.equal(dec, torch.arange(w * h))


@pytest.mark.parametrize("scene_file,w,h", [
    ("mesh_env.xml", 128, 8), ("oracle_mat.xml", 64, 64), ("mesh_env.xml", 96, 40),
])
def test_camera_rays_match(scene_file, w, h):
    from pupiloptixlab_tpu.flatten import camera_block_from_scene as jcam_block

    scene = load_scene(DATA / scene_file)
    scene.sensor.film.w, scene.sensor.film.h = w, h
    jcb = jcam_block(scene)
    tcb = camera_block_from_scene(scene, device="cpu")
    for f in dataclasses.fields(jcb):
        a, b = np.asarray(getattr(jcb, f.name)), getattr(tcb, f.name)
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a)
    r = np.random.default_rng(w * h)
    jx, jy = (r.random(w * h, dtype=np.float32) for _ in range(2))
    jo, jd = jcam.generate_rays(jcb, w, h, jnp.asarray(jx), jnp.asarray(jy))
    to, td = tcam.generate_rays(tcb, w, h, torch.from_numpy(jx), torch.from_numpy(jy))
    for a, b in zip(list(jo) + list(jd), list(to) + list(td)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def _planes(r, n, unit=False):
    v = r.standard_normal((3, n)).astype(np.float32)
    if unit:
        v /= np.linalg.norm(v, axis=0, keepdims=True)
    return v


@pytest.mark.parametrize("fn", [
    "uniform_sample_triangle", "uniform_sample_sphere", "cosine_sample_hemisphere",
    "uniform_sample_hemisphere",
])
def test_sampling_warps_match(fn):
    r = np.random.default_rng(3)
    u1, u2 = r.random(5000, dtype=np.float32), r.random(5000, dtype=np.float32)
    a = getattr(jsmp, fn)(jnp.asarray(u1), jnp.asarray(u2))
    b = getattr(tsmp, fn)(torch.from_numpy(u1), torch.from_numpy(u2))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["to_local", "to_world", "reflect", "sphere_texcoord"])
def test_frame_helpers_match(fn):
    r = np.random.default_rng(4)
    v, nrm = _planes(r, 5000, True), _planes(r, 5000, True)
    jv, jn = JVec3(*map(jnp.asarray, v)), JVec3(*map(jnp.asarray, nrm))
    tv, tn = TVec3(*map(torch.from_numpy, v)), TVec3(*map(torch.from_numpy, nrm))
    if fn == "sphere_texcoord":
        a, b = jsmp.sphere_texcoord(jv), tsmp.sphere_texcoord(tv)
    else:
        a, b = getattr(jsmp, fn)(jv, jn), getattr(tsmp, fn)(tv, tn)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-6)
