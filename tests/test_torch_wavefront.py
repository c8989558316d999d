"""Port parity: the wavefront engine (wavefront/engine.py) and its queue
primitives (wavefront/queues.py).

* ``compact_queue`` and ``sort_by_key`` (the reference's
  tests/test_wavefront.py:53-70) against the reference on equal inputs.
* ``render_wavefront`` on ``oracle_mat.xml`` (16x16, spp 2: a pixel's two
  paths share the pool, so the film scatter meets duplicate pixels)
  against the reference run op by op (``jax.disable_jit``) at equal seed:
  film rel MSE <= 1e-5 and >= 99% of pixels within rtol 1e-4, albedo and
  normal within 1e-5. The loop reads one count from the device an
  iteration: syncs = iterations + 1.
* The film scatter adds a pixel's lanes in lane order: equal, bit for bit,
  to a sequential float32 sum on seeded values with many duplicates.
* The wavefront frame's mean against the port's ``render`` on oracle_mat
  (the reference's cornell check, tests/test_wavefront.py:22, on an
  in-repo scene): mean within 5%, per-pixel correlation > 0.95.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.wavefront import compact_queue as jax_compact
from pupiloptixlab_tpu.wavefront import render_wavefront as jax_render_wavefront
from pupiloptixlab_tpu.wavefront import sort_by_key as jax_sort
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.render.integrator import render
from pupiloptixlab_tpu_torch.render.vec import Vec3
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.wavefront import compact_queue, render_wavefront, sort_by_key
from pupiloptixlab_tpu_torch.wavefront.engine import _pixel_ranks, _scatter_rgb
from pupiloptixlab_tpu_torch.wavefront.queues import compaction_permutation
from test_torch_frame import DATA, _jax_tables, _load


def test_compact_queue_packs_alive_first():
    alive = [False, True, False, True, True, False]
    q = {"a": torch.arange(6), "b": torch.arange(6) * 10.0}
    packed, count = compact_queue(q, torch.tensor(alive))
    assert int(count) == 3
    np.testing.assert_array_equal(packed["a"][:3].numpy(), [1, 3, 4])
    np.testing.assert_array_equal(packed["b"][:3].numpy(), [10.0, 30.0, 40.0])
    rs = np.random.RandomState(2)
    mask = rs.rand(257) < 0.4
    vals = rs.randn(257).astype(np.float32)
    got, gc = compact_queue({"v": torch.from_numpy(vals)}, torch.from_numpy(mask))
    want, wc = jax_compact({"v": jnp.asarray(vals)}, jnp.asarray(mask))
    assert int(gc) == int(wc) == mask.sum()
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))
    perm, _ = compaction_permutation(torch.from_numpy(mask))
    assert perm.dtype == torch.int32


def test_sort_by_key_coherence():
    key = torch.tensor([3, 1, 2, 1, 3, 0])
    sorted_q, perm = sort_by_key({"v": torch.arange(6)}, key)
    np.testing.assert_array_equal(key[perm.long()].numpy(), [0, 1, 1, 2, 3, 3])
    rs = np.random.RandomState(4)
    k = rs.randint(0, 7, 300).astype(np.int32)
    got, gp = sort_by_key({"v": torch.arange(300)}, torch.from_numpy(k))
    want, wp = jax_sort({"v": jnp.arange(300)}, jnp.asarray(k))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))


def test_scatter_adds_duplicates_in_lane_order():
    rs = np.random.RandomState(9)
    n, lanes, spp = 13, 52, 4
    pixel = torch.from_numpy(rs.permutation(np.repeat(np.arange(n), spp)))
    vals = (rs.randn(lanes, 3) * 1e3 ** rs.randint(0, 3, (lanes, 1))).astype(np.float32)
    mask = torch.from_numpy(rs.rand(lanes) < 0.8)
    film = torch.from_numpy(rs.randn(n + 1, 3).astype(np.float32))
    want = film.numpy().copy()
    for i in range(lanes):  # sequential float32 sums in lane order
        if mask[i]:
            want[pixel[i]] = want[pixel[i]] + vals[i]
    ranks = _pixel_ranks(pixel)
    assert int(ranks.max()) == spp - 1
    _scatter_rgb(film, pixel, Vec3.from_array(torch.from_numpy(vals)), mask, ranks, spp)
    np.testing.assert_array_equal(film[:n].numpy(), want[:n])


def test_wavefront_matches_reference():
    (jd, jc, jcam), (data, config, cam) = _jax_tables(_load("oracle_mat.xml", 16, 16))
    with jax.disable_jit():
        want = jax_render_wavefront(jd, jcam, jnp.uint32(3), jc, spp=2)
    got = render_wavefront(data, cam, 3, config, spp=2)
    a, g = np.asarray(want["film"]), got["film"].numpy()
    rel = float(np.mean((g - a) ** 2) / max(np.mean(a ** 2), 1e-30))
    frac = float(np.isclose(g, a, rtol=1e-4, atol=0.0).all(-1).mean())
    print(f"rel MSE {rel:.3e}, within rtol 1e-4 {frac:.4f}, iterations {got['iterations']}")
    assert np.isfinite(g).all() and rel <= 1e-5 and frac >= 0.99
    for k in ("albedo", "normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)
    assert got["syncs"] == got["iterations"] + 1 and got["iterations"] > config.max_depth


def test_wavefront_matches_render_mean():
    scene = load_scene(DATA / "oracle_mat.xml")
    scene.sensor.film.w = scene.sensor.film.h = 24
    data, config = flatten_scene(scene, device="cpu")
    camera = camera_block_from_scene(scene, device="cpu")
    spp = 48
    mega = render(data, camera, config, spp=spp).numpy()
    out = render_wavefront(data, camera, 0, config, spp=spp)
    wave = out["film"].numpy().reshape(config.height, config.width, 3)
    assert np.isfinite(wave).all()
    assert wave.mean() == pytest.approx(mega.mean(), rel=0.05)
    assert np.corrcoef(mega.reshape(-1), wave.reshape(-1))[0, 1] > 0.95
