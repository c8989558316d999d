"""Port parity: the multi-device path (parallel/) on the CPU.

* The tile permutation and the lane slab of ``render_frame``
  (render/integrator.py): mesh_env at 128x64 (8 tiles of the block lane
  order) with a seeded permutation is bit-equal to the frame without one,
  and a slab of the lanes equals the same lanes of the whole frame, on the
  block route and (oracle_mat) on the row-major route.
* K1's walk (``tree_walk``, the plain version of K11) equals the brute
  sweep on the ring's unjittered rays, 32 of which run along box faces.
* ``build_ring_bvh``'s shard tables equal the reference's at D = 4 (the
  reference on 4 devices of the 8-device CPU mesh of tests/conftest.py),
  bit for bit.
* One start of 4 gloo ranks (``parallel/dryrun.py``'s worker, forked from
  a fork server, a file store in a temporary directory) runs
  ``render_frame_sharded``, ``render_frame_balanced``, ``render_samples_sharded``, ``ring_closest``
  and ``ring_closest_bvh``, and writes what it got; the parent holds it
  against the single-process port and the reference's ring sweeps at D = 4
  on the same rays and table:
  - frames bit-equal; each rank's accumulation slab equal to its lanes of
    the single-process frame; the sample mean within atol 1e-6 (the
    all-reduce sums in another order);
  - ``ring_closest`` (plain inner) against the reference's (jnp inner):
    rows equal, t within rtol 1e-6 (XLA may contract the reference's
    arithmetic into FMAs);
  - ``ring_closest_bvh`` against the reference's (Pallas, interpret mode):
    t within rtol 3e-5 (the reference's leaf test takes an approximate
    reciprocal); rows equal except where the reference's row hits the
    same ray within that rtol of the port's t (an exact or near tie), on at
    most 0.2% of mutual hits;
  - both ring sweeps against the brute sweep over the single table: t
    bit-equal, rows off only on exact ties of t across shards.
Frames run at path depth 1 (primary rays only): the plain brute sweep over
mesh_env's 20,544 rows costs ~25 ns a ray and row on one core, and the
permutation and the slab act on lanes, whatever the depth.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.parallel.ring_sweep import build_ring_bvh as jax_build_ring_bvh
from pupiloptixlab_tpu.parallel.ring_sweep import ring_closest as jax_ring_closest
from pupiloptixlab_tpu.parallel.ring_sweep import ring_closest_bvh as jax_ring_closest_bvh
from pupiloptixlab_tpu.parallel.ring_sweep import shard_tris as jax_shard_tris
from pupiloptixlab_tpu.parallel.sharding import make_mesh as jax_make_mesh
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.parallel import dryrun
from pupiloptixlab_tpu_torch.parallel.ring_sweep import build_ring_bvh
from pupiloptixlab_tpu_torch.render.integrator import lane_pixels, render_frame

DATA = Path(__file__).resolve().parent.parent / "data"
RANKS = 4
DEPTH = 1


@pytest.fixture(scope="module")
def single():
    """The single-process port at the dry run's sizes."""
    return dryrun.single_process(RANKS, "cpu", depth=DEPTH)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """What 4 spawned gloo ranks got."""
    return dryrun.run(RANKS, "cpu", tmp_path_factory.mktemp("ranks"), depth=DEPTH)


@pytest.fixture(scope="module")
def frame_tables():
    return dryrun.load(*dryrun.FILM, "cpu", DEPTH)


def _frame(data, config, cam, **kw):
    n = config.width * config.height // kw.get("slab", (0, 1))[1]
    _, bufs = render_frame(data, cam, dryrun.SEED, 0, torch.zeros((n, 3)), config, **kw)
    return {k: v.numpy() for k, v in bufs.items()}


def test_tile_perm_frame_is_bit_equal(frame_tables, single):
    data, config, cam = frame_tables
    perm = np.random.default_rng(6).permutation(8)
    assert (perm != np.arange(8)).any()
    got = _frame(data, config, cam, tile_perm=perm)
    for k in dryrun.FRAME_KEYS:
        np.testing.assert_array_equal(got[k], single[f"frame_{k}"])


@pytest.mark.parametrize("route", ["block", "row_major"])
def test_lane_slab_equals_the_frames_lanes(route, frame_tables, single):
    if route == "block":
        data, config, cam = frame_tables
        perm = np.random.default_rng(6).permutation(8)
        whole = {k: single[f"frame_{k}"] for k in dryrun.FRAME_KEYS}
    else:  # oracle_mat: the chunk sweep keeps row-major lanes, whole pixel rows
        scene = load_scene(DATA / "oracle_mat.xml")
        scene.sensor.film.w, scene.sensor.film.h = 16, 16
        data, config = flatten_scene(scene, device="cpu")
        cam = camera_block_from_scene(scene, device="cpu")
        perm = None
        whole = _frame(data, config, cam)
    slab = (1, 4)
    got = _frame(data, config, cam, tile_perm=perm, slab=slab)
    pix = lane_pixels(config, perm, slab, device="cpu").numpy()
    if route == "row_major":
        assert np.array_equal(pix, np.arange(64, 128))
    for k in dryrun.FRAME_KEYS:
        np.testing.assert_array_equal(got[k], whole[k][pix])


def test_slab_and_tile_perm_are_checked(frame_tables):
    _, config, _ = frame_tables
    with pytest.raises(ValueError, match="tile indices"):
        lane_pixels(config, np.arange(4), device="cpu")
    with pytest.raises(ValueError, match="equal slabs"):
        lane_pixels(config, None, (0, 3), device="cpu")


def test_tree_walk_matches_brute_sweep_on_rays_along_box_faces(frame_tables, single):
    """The ring's unjittered rays: 32 of them have an x direction of exactly
    0 and run in the plane x = 0, in which boxes of the tree have a face.
    K1's walk (``tree_walk``) must not drop those boxes: t and rows equal
    to the brute sweep's."""
    data, config, _ = frame_tables
    rays = torch.from_numpy(single["rays"])
    n = rays.shape[1]
    planes = [*rays, torch.full((n,), 1e-3), torch.full((n,), 1e16)]
    along = (rays[3] == 0) & (rays[0] == 0)
    tris = data.tris
    on_face = (tris.bvh_boxes[:, 0] == 0) | (tris.bvh_boxes[:, 3] == 0)
    assert int(along.sum()) == 32 and bool(on_face.any())
    w = bt.tree_walk(*planes, tris.packed, tris.bvh_child, tris.bvh_axis, tris.bvh_boxes,
                     tris.subleaf_rows, tris.subleaf_boxes, config.bvh_tcl)
    t, idx = w["t"], w["idx"]
    assert (single["closest_i"][along.numpy()] >= 0).any()
    np.testing.assert_array_equal(idx.numpy(), single["closest_i"])
    np.testing.assert_array_equal(t.numpy(), single["closest_t"])


def test_ring_bvh_tables_equal_the_references():
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 64, 32
    jd, _ = jax_flatten(scene)
    packed = np.asarray(jd.tris.packed)
    ref = jax_build_ring_bvh(jd.tris.packed, jax_make_mesh(RANKS, axis="shards"))
    got = build_ring_bvh(torch.from_numpy(packed.copy()), RANKS)
    assert (got.shard_rows, got.tcl) == (ref.shard_rows, ref.tcl)
    for name in ("rows", "child", "axis", "boxes", "remap"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert len(got.depth) == RANKS and all(1 <= d <= 18 for d in got.depth)


def test_spawned_sharded_and_balanced_frames_are_bit_equal(spawned, single):
    for mode in ("sharded", "balanced"):
        for k in dryrun.FRAME_KEYS:
            np.testing.assert_array_equal(spawned[f"{mode}_{k}"], single[f"frame_{k}"],
                                          err_msg=f"{mode} {k}")
    perm = spawned["perm"]
    assert sorted(perm) == list(range(8))
    assert spawned["costs"].shape == (8,) and (spawned["costs"] > 0).all()


def test_spawned_accumulation_stays_on_its_rank(spawned, single, frame_tables):
    """Each rank's accumulation slab holds exactly its lanes of the frame."""
    _, config, _ = frame_tables
    for mode, perm in (("sharded", None), ("balanced", spawned["perm"])):
        for r, acc in enumerate(spawned[f"{mode}_accum"]):
            pix = lane_pixels(config, perm, (r, RANKS), device="cpu").numpy()
            np.testing.assert_array_equal(acc, single["frame_frame"][pix],
                                          err_msg=f"{mode} rank {r}")


def test_spawned_samples_are_the_mean_of_the_ranks_seeds(spawned, single):
    err = np.abs(spawned["samples"] - single["samples_mean"]).max()
    assert err <= 1e-6, err


def _reference_ring_inputs(single):
    rays = single["rays"]
    n = rays.shape[1]
    return (jnp.asarray(rays[0:3]), jnp.asarray(rays[3:6]), jnp.full(n, 1e-3, jnp.float32),
            jnp.full(n, 1e16, jnp.float32), jnp.asarray(single["tri"]))


def test_spawned_ring_closest_matches_the_reference(spawned, single):
    ro, rd, tmin, tmax, tri = _reference_ring_inputs(single)
    mesh = jax_make_mesh(RANKS, axis="shards")
    table, shard_rows = jax_shard_tris(tri, mesh)
    t_ref, i_ref = (np.asarray(a) for a in jax_ring_closest(mesh, ro, rd, tmin, tmax, table,
                                                           shard_rows))
    t, i = np.concatenate(spawned["ring_t"]), np.concatenate(spawned["ring_i"])
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(t, t_ref, rtol=1e-6)


def test_spawned_ring_closest_bvh_matches_the_reference(spawned, single):
    ro, rd, tmin, tmax, tri = _reference_ring_inputs(single)
    mesh = jax_make_mesh(RANKS, axis="shards")
    ring = jax_build_ring_bvh(tri, mesh)
    t_ref, i_ref = (np.asarray(a) for a in jax_ring_closest_bvh(mesh, ro, rd, tmin, tmax, ring,
                                                               interpret=True))
    t, i = np.concatenate(spawned["ring_bvh_t"]), np.concatenate(spawned["ring_bvh_i"])
    np.testing.assert_array_equal(i >= 0, i_ref >= 0)
    both = (i >= 0) & (i_ref >= 0)
    assert both.sum() > 1000
    np.testing.assert_allclose(t[both], t_ref[both], rtol=3e-5)
    # where the rows differ, the reference's row must hit that ray, in the
    # port's arithmetic, within the reciprocal's rtol 3e-5 of the port's t:
    # an exact or near tie that the reference's visit order or approximate
    # reciprocal decided (2 of 1,755 mutual hits here: 0.11%)
    off = np.nonzero(both & (i != i_ref))[0]
    t_other = dryrun.hits_at(single["rays"], single["tri"], off, i_ref[off])
    np.testing.assert_allclose(t_other, t[off], rtol=3e-5)
    assert off.size <= 2e-3 * both.sum(), off.size


def test_spawned_ring_sweeps_match_the_single_table(spawned, single):
    summary = dryrun.compare(spawned, single)
    print(summary["ring"])
    for r in summary["ring"].values():
        assert r["t_equal"] and r["rows_off"] == r["ties"]
