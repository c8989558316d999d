"""Port parity: ``render_frame_batch`` and the offline ``render`` on the CPU.

On data/oracle_mat.xml at its own 64x64 film (row-major lanes, the chunk
sweep, spheres, all seven BSDFs), 3 samples a batch:

* the port's ``render_frame_batch`` against the port's eager loop of
  ``render_frame`` at the same seeds and counts: accum and the last
  sample's frame, albedo, normal and test bit-equal;
* the port's batch against the JAX package's jitted ``render_frame_batch``
  (one compile, shared by every call below, as tests/test_batch_spp.py runs
  it), from seed 5, count 2, and across the 2^32 seed wraparound (seed0 =
  2^32 - 2), and the port's ``render`` against the reference's ``render``,
  at the frame gate of tests/test_torch_frame.py: relative MSE <= 1e-5 and
  >= 99% of pixels within rtol 1e-4 on the frame, the ``test`` AOV (one RNG
  draw a pixel) bit-equal, albedo within rtol 1e-5 / atol 1e-5, and the
  normal within 1e-5 on >= 97% of pixels and 1e-3 on all: XLA contracts
  a*b+c into FMAs under jit, which moves oracle_mat's small spheres'
  normals by up to ~5e-4 (tests/test_torch_frame.py); the last sample's
  normal here has 97.97% (seed 7) and 98.80% (seed 1) of its pixels within
  1e-5, 3.7e-4 at most off;
* ``config.accumulate = False``: the accum is the last sample's radiance.
  The reference's batch takes a sample as it is wherever its count is <= 0,
  so its accumulating batch from count -2 gives that same last radiance
  after 3 samples, with no second compile; the port is held to it at the
  frame gate, and the port's accumulating batch from count -2 to its own
  ``accumulate = False`` batch bit for bit.

And, bit-equal to their host forms: ``rng.tea_init`` with a 0-dim tensor
seed over 4,096 seeded lanes at seeds that include 2^32 - 1 and values
past 32 bits, and the device-form blend weight (``blend_weight``) for every
count in 0..10^6 in one vectorised comparison. The capture into a CUDA
graph and the deferred fault flags run only on the card (chip_smoke.py
phase 23).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.flatten import camera_block_from_scene as jax_camera
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.render.integrator import render as jax_render
from pupiloptixlab_tpu.render.integrator import render_frame_batch as jax_batch
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.render import rng
from pupiloptixlab_tpu_torch.render.integrator import (
    blend,
    blend_weight,
    render,
    render_frame,
    render_frame_batch,
)

DATA = Path(__file__).resolve().parent.parent / "data"
SPP = 3
KEYS = ("frame", "albedo", "normal", "test")


@pytest.fixture(scope="module")
def oracle():
    scene = load_scene(DATA / "oracle_mat.xml")
    assert (scene.sensor.film.w, scene.sensor.film.h) == (64, 64)
    jd, jc = jax_flatten(scene)
    data, config = flatten_scene(scene, device="cpu")
    assert config.bvh_nodes == 0 and config.accumulate
    return (jd, jc, jax_camera(scene)), (data, config, camera_block_from_scene(scene, device="cpu"))


def _jax_batch(ref, seed0, cnt):
    jd, jc, jcam = ref
    acc = jnp.zeros((jc.width * jc.height, 3), jnp.float32)
    _, bufs = jax_batch(jd, jcam, jnp.uint32(seed0), jnp.int32(cnt), acc, jc, SPP)
    return {k: np.asarray(v) for k, v in bufs.items()}


def _batch(port, seed0, cnt, config=None):
    data, cfg, cam = port
    cfg = config or cfg
    accum = torch.zeros((cfg.width * cfg.height, 3))
    acc, bufs = render_frame_batch(data, cam, seed0, cnt, accum, cfg, SPP)
    assert acc is accum and bufs["frame"] is accum  # updated in place, as donated
    assert set(bufs) == set(KEYS)
    return {k: v.numpy() for k, v in bufs.items()}


def _loop(port, seed0, cnt, config=None):
    data, cfg, cam = port
    cfg = config or cfg
    accum = torch.zeros((cfg.width * cfg.height, 3))
    for i in range(SPP):
        _, bufs = render_frame(data, cam, (seed0 + i) & rng.M32, cnt + i, accum, cfg)
    return {k: v.numpy() for k, v in bufs.items()}


def _bit_equal(got, want):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _frame_close(a, b):
    assert np.isfinite(a).all() and a.mean() > 0.0
    rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
    frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
    assert rel <= 1e-5 and frac >= 0.99, (rel, frac)


def _frame_gate(got, want):
    _frame_close(got["frame"], want["frame"])
    np.testing.assert_array_equal(got["test"], want["test"])
    np.testing.assert_allclose(got["albedo"], want["albedo"], rtol=1e-5, atol=1e-5)
    near = np.isclose(got["normal"], want["normal"], rtol=1e-5, atol=1e-5).all(-1)
    assert near.mean() >= 0.97, near.mean()
    np.testing.assert_allclose(got["normal"], want["normal"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed0,cnt", [(5, 2), (2**32 - 2, 0)])
def test_batch_matches_loop_and_reference(oracle, seed0, cnt):
    """From seed 5, count 2, and across the 2^32 wraparound (seeds 2^32 -
    2, 2^32 - 1, 0 at counts 0, 1, 2)."""
    ref, port = oracle
    got = _batch(port, seed0, cnt)
    _bit_equal(got, _loop(port, seed0, cnt))
    _frame_gate(got, _jax_batch(ref, seed0, cnt))


def test_render_matches_reference(oracle):
    (jd, jc, jcam), (data, config, cam) = oracle
    got = render(data, cam, config, spp=SPP, seed0=7).numpy()
    want = np.asarray(jax_render(jd, jcam, jc, SPP, seed0=7))
    assert got.shape == want.shape == (64, 64, 3)
    _frame_close(got, want)


def test_batch_without_accumulation(oracle):
    ref, port = oracle
    noacc = dataclasses.replace(port[1], accumulate=False)
    got = _batch(port, 5, 2, noacc)
    _bit_equal(got, _loop(port, 5, 2, noacc))
    _bit_equal(_batch(port, 5, -2), got)
    _frame_gate(got, _jax_batch(ref, 5, -2))


def test_tea_init_takes_a_tensor_seed():
    lanes = torch.from_numpy(
        np.random.default_rng(11).integers(0, 2**32, 4096, dtype=np.int64))
    for seed in (0, 1, 5, 2**31, 2**32 - 3, 2**32 - 1, 2**32, 2**32 + 7, 2**40 + 3):
        want = rng.tea_init(lanes, seed)
        got = rng.tea_init(lanes, torch.tensor(seed, dtype=torch.int64))
        assert got.dtype == want.dtype and torch.equal(got, want), seed


def test_device_blend_weight_equals_the_host_form():
    n = np.arange(10**6 + 1)
    host = np.float32(1.0) / (n.astype(np.float32) + np.float32(1.0))
    dev = blend_weight(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(dev.view(np.int32), host.view(np.int32))
    # blend's own scalar path at a few counts
    x = torch.tensor([[0.3, 2.0, 7.5]]), torch.tensor([[1.7, 0.1, 3.25]])
    for c in (1, 2, 3, 7, 999_999, 10**6):
        acc = x[0].clone()
        blend(acc, x[1], c, True)
        t = torch.from_numpy(host[c:c + 1])
        assert torch.equal(acc, x[0] + (x[1] - x[0]) * t), c
