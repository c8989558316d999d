"""Port parity: the last host helpers of the JAX package, on the CPU.

* ``render/fresnel.py::diffuse_reflectance`` against the reference's over
  a seeded grid of eta in [0.2, 4] that holds 1.0 (both branches of the
  fit): within rtol 1e-6 (float32 polynomials whose powers the two
  libraries may evaluate in another order).
* ``accel/bvh.py::max_stack_depth`` against the reference's: equal on
  mesh_env's tree and on the depth-11 tree of ``scene/deep_soup.py``.
* ``render/sampling.py::aces_tonemap`` / ``gamma_correct`` against the
  reference's on seeded radiance (negatives and values above 1 among it):
  within rtol 1e-6 / atol 1e-7; ``display/tonemap.py`` uses these same
  functions, so the display's bytes are unchanged (its own tests hold
  them).
* ``lane_pixels`` takes its device from the caller: called without one it
  raises.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.bvh import max_stack_depth as jax_max_stack_depth
from pupiloptixlab_tpu.render import sampling as jax_sampling
from pupiloptixlab_tpu.render.fresnel import diffuse_reflectance as jax_diffuse_reflectance
from pupiloptixlab_tpu_torch.accel.bvh import bvh_depth, max_stack_depth
from pupiloptixlab_tpu_torch.display import tonemap
from pupiloptixlab_tpu_torch.flatten import flatten_scene
from pupiloptixlab_tpu_torch.render import sampling
from pupiloptixlab_tpu_torch.render.fresnel import diffuse_reflectance
from pupiloptixlab_tpu_torch.render.integrator import lane_pixels
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.scene.deep_soup import soup_tables

DATA = Path(__file__).resolve().parent.parent / "data"


def test_diffuse_reflectance_matches_reference():
    rng = np.random.default_rng(3)
    eta = np.concatenate([rng.uniform(0.2, 4.0, 4093), [0.2, 1.0, 4.0]]).astype(np.float32)
    got = diffuse_reflectance(torch.from_numpy(eta)).numpy()
    want = np.asarray(jax_diffuse_reflectance(jnp.asarray(eta)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("tree", ["mesh_env", "deep_soup"])
def test_max_stack_depth_matches_reference(tree):
    if tree == "mesh_env":
        scene = load_scene(DATA / "mesh_env.xml")
        scene.sensor.film.w, scene.sensor.film.h = 128, 8
        data, config = flatten_scene(scene, device="cpu")
        assert config.bvh_nodes > 0
        child = data.tris.bvh_child.numpy()
    else:
        child = soup_tables()["child"].numpy()
        assert bvh_depth(child) == 11
    got = max_stack_depth(child)
    assert got == jax_max_stack_depth(child)
    assert got == 7 * (bvh_depth(child) - 1) + 8


def test_tonemap_helpers_match_reference():
    rgb = np.random.default_rng(5).normal(0.5, 2.0, (4096, 3)).astype(np.float32)
    x = torch.from_numpy(rgb)
    for lum in (1.0, 0.37):
        np.testing.assert_allclose(
            sampling.aces_tonemap(x, lum).numpy(),
            np.asarray(jax_sampling.aces_tonemap(jnp.asarray(rgb), lum)), rtol=1e-6, atol=1e-7)
    for gamma in (2.2, 1.8):
        np.testing.assert_allclose(
            sampling.gamma_correct(x, gamma).numpy(),
            np.asarray(jax_sampling.gamma_correct(jnp.asarray(rgb), gamma)), rtol=1e-6,
            atol=1e-7)
    assert tonemap.aces_tonemap is sampling.aces_tonemap
    assert tonemap.gamma_correct is sampling.gamma_correct


def test_lane_pixels_wants_a_device():
    scene = load_scene(DATA / "oracle_mat.xml")
    scene.sensor.film.w, scene.sensor.film.h = 8, 8
    _, config = flatten_scene(scene, device="cpu")
    with pytest.raises(TypeError):
        lane_pixels(config)
    assert torch.equal(lane_pixels(config, device="cpu"), torch.arange(64))
