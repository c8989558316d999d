"""Port parity: the traversal counter K11's plain version and the cost model.

``tree_walk`` is K1's walk in PyTorch (the plain version of K11, which
counts what the walk does); on the CPU ``bvh_closest(count_iters=True)``
runs it. Held here:

* its (t, row) against the brute sweep (K1's plain version): mesh_env's
  primary rays at 256x128 (the walk at every lane, the sweep on a seeded
  4,096-lane subset, which keeps the test to seconds) and the seeded deep
  soup of ``scene/deep_soup.py`` (a depth-11 tree, whose walk may need 78
  stack entries, more than the 64 the kernels held before) at 1,024 rays:
  rows equal, t bit-equal;
* ``tile_costs`` by its use: the port's ``balanced_tile_perm(costs, 4)``,
  scored by the reference's Pallas counter (interpret mode) on the same
  film, spreads the cost no worse than the contiguous split. The two
  counters count different things (the TPU's lockstep loop iterations of a
  tile, the sum of each ray's pops here), so the counts are not compared;
* ``balanced_tile_perm``: the reference's own test on the port's copy.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.flatten import camera_block_from_scene as jax_camera
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.parallel.balance import tile_costs as jax_tile_costs
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.parallel.balance import balanced_tile_perm, tile_costs
from pupiloptixlab_tpu_torch.render.integrator import lane_pixels, primary_rays
from pupiloptixlab_tpu_torch.scene.deep_soup import soup_rays, soup_tables

DATA = Path(__file__).resolve().parent.parent / "data"
W, H = 256, 128  # 32 tiles of 1024 pixels


@pytest.fixture(scope="module")
def mesh_env():
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = W, H
    data, config = flatten_scene(scene, device="cpu")
    cam = camera_block_from_scene(scene, device="cpu")
    n = W * H
    _, (ro, rd, tmin, tmax) = primary_rays(cam, config, 0, lane_pixels(config, device="cpu"))
    planes = [p.expand(n).contiguous() for p in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
    planes += [tmin, tmax]
    tris = data.tris
    tabs = (tris.packed, tris.bvh_child, tris.bvh_axis, tris.bvh_boxes, tris.subleaf_rows,
            tris.subleaf_boxes)
    return scene, data, config, cam, planes, tabs


@pytest.fixture(scope="module")
def brute(mesh_env):
    """A seeded 4,096-lane subset of mesh_env's rays and the brute sweep's
    (t, row) on it."""
    _, data, _, _, planes, _ = mesh_env
    n = planes[0].shape[0]
    lanes = torch.from_numpy(np.sort(np.random.default_rng(0).choice(n, 4096, replace=False)))
    return lanes, bt.plain_closest(*[p[lanes] for p in planes], data.tris.packed)


def test_tree_walk_matches_brute_sweep_on_mesh_env(mesh_env, brute):
    _, data, config, _, planes, tabs = mesh_env
    w = bt.tree_walk(*planes, *tabs, config.bvh_tcl)
    t, idx, pops, leaves, deepest = w["t"], w["idx"], w["pops"], w["leaves"], w["deepest"]
    lanes, (t_b, i_b) = brute
    assert torch.equal(idx[lanes], i_b)
    assert torch.equal(t[lanes], t_b)
    assert int((i_b >= 0).sum()) > 1000
    # every live ray pops the root; a hit ray tests at least one leaf
    assert bool((pops >= 1).all()) and bool((leaves[idx >= 0] >= 1).all())
    assert deepest <= 7 * data.tris.bvh_depth + 1


def test_tree_walk_on_the_deep_soup():
    soup = soup_tables()
    assert soup["depth"] == 11
    need = 7 * soup["depth"] + 1
    assert need > 64 and bt.stack_fits(soup["depth"])
    planes = soup_rays(soup["tri"], 1024)
    tabs = (soup["tri"], soup["child"], soup["axis"], soup["boxes"], soup["subleaf_rows"],
            soup["subleaf_boxes"])
    w = bt.tree_walk(*planes, *tabs, soup["tcl"])
    t, idx, deepest = w["t"], w["idx"], w["deepest"]
    t_b, i_b = bt.plain_closest(*planes, soup["tri"])
    print(f"deep soup: {soup['n_nodes']} nodes, depth {soup['depth']}, stack bound {need}, "
          f"deepest stack reached {deepest}, {int((i_b >= 0).sum())}/1024 hits")
    assert torch.equal(idx, i_b) and torch.equal(t, t_b)
    assert int((i_b >= 0).sum()) > 900
    assert 1 <= deepest <= need


def test_count_iters_on_cpu_tensors(mesh_env, brute):
    """The CPU route of K11: K1's t and idx (the brute sweep's, which
    ``bvh_closest`` returns on CPU tensors) plus the walk's per-tile sums."""
    _, data, config, _, planes, tabs = mesh_env
    lanes, (t1, i1) = brute
    sub = [p[lanes] for p in planes]
    kw = dict(tcl=config.bvh_tcl, depth=data.tris.bvh_depth)
    t, idx, counts = bt.bvh_closest(*sub, *tabs, **kw, count_iters=True)
    assert torch.equal(t, t1) and torch.equal(idx, i1)
    w = bt.tree_walk(*sub, *tabs, config.bvh_tcl)
    assert counts.dtype == torch.int32 and counts.shape == (4, 2)
    want = torch.stack([w["pops"], w["leaves"]], 1).reshape(4, 1024, 2).sum(1).to(torch.int32)
    assert torch.equal(counts, want)
    with pytest.raises(ValueError, match="multiple"):
        bt.bvh_closest(*[p[:1000] for p in sub], *tabs, **kw, count_iters=True)


def test_tile_costs_balance_by_the_references_costs(mesh_env):
    scene, data, config, cam, _, _ = mesh_env
    jd, jc = jax_flatten(scene)
    ref = np.asarray(jax_tile_costs(jd, jax_camera(scene), jc))
    costs = tile_costs(data, cam, config)
    assert costs.shape == ref.shape == (W * H // 1024,) and (costs > 0).all()
    d = 4
    balanced = ref[balanced_tile_perm(costs, d)].reshape(d, -1).sum(1)
    contiguous = ref.reshape(d, -1).sum(1)
    ratio_b = balanced.max() / balanced.mean()
    ratio_c = contiguous.max() / contiguous.mean()
    print(f"heaviest/mean by the reference's costs: balanced {ratio_b:.5f}, "
          f"contiguous {ratio_c:.5f}")
    assert ratio_b <= ratio_c


def test_balanced_tile_perm_equalizes_cost():
    """tests/test_sharding.py::test_balanced_tile_perm_equalizes_cost on the
    port's copy, same seed."""
    rng_np = np.random.default_rng(0)
    costs = (rng_np.pareto(2.0, size=2048) * 100 + 5).astype(np.int64)
    perm = balanced_tile_perm(costs, 8)
    assert sorted(perm) == list(range(2048))
    sums = costs[perm].reshape(8, -1).sum(axis=1)
    assert sums.max() / sums.mean() < 1.02, sums


def test_balanced_tile_perm_needs_equal_slabs():
    """1080p has 2,025 tiles: 3 ranks divide them, 4 do not (no padding)."""
    costs = np.arange(2025, dtype=np.int64)
    assert sorted(balanced_tile_perm(costs, 3)) == list(range(2025))
    with pytest.raises(ValueError, match="equal slabs"):
        balanced_tile_perm(costs, 4)
