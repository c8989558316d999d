"""Port parity on the CPU for the matmul-form leaf test of the BVH route.

The reference runs closest-hit queries through ``_make_closest_kernel_mxu``
when ``PUPIL_MXU_MT`` is set, the leaves have 32 rows (``PUPIL_TCL=32`` at
flatten time), the tables are baked and resident. The port's counterpart is
``bvh_closest_mt`` (K10), whose CPU route is the brute linear-form sweep
``plain_closest_mt``. Held here:

* ``PUPIL_TCL=32``: both packages' ``pick_leaf_size(20544)`` give 32, and
  both flattens of data/mesh_env.xml give the same config and equal tables;
* ``mt_cols_table`` against the reference's ``_mt_cols_table`` on the same
  rows and centre: rtol 1e-6 plus atol 1e-6 (a cross product's two
  products may round differently where XLA contracts them into one FMA;
  entries are sums of products of coordinates of order 1);
* ``plain_closest_mt`` against ``bvh_closest(mxu=True, interpret=True)`` on
  the soup of tests/test_bvh.py:143-170 (2,100 triangles, 32-row leaves,
  1,024 rays): rows equal, t within rtol 3e-5 (the TPU kernel's approximate
  reciprocal plus one Newton step; the port divides in IEEE), and against
  the port's classic brute sweep: rows equal;
* ``intersect_closest`` with ``MXU_MT`` monkeypatched on mesh_env flattened
  at 32-row leaves: it goes through the linear form, and gives the rows of
  the unflagged route, t within rtol 3e-5.
"""

import dataclasses
import gc
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel import bvh as jax_bvh
from pupiloptixlab_tpu.accel.bvh import build_bvh
from pupiloptixlab_tpu.accel.pallas_bvh import _mt_cols_table
from pupiloptixlab_tpu.accel.pallas_bvh import bvh_closest as pallas_closest
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.scene import load_scene as jax_load_scene
from pupiloptixlab_tpu_torch.accel import bvh as port_bvh
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.accel import intersect as port_intersect
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.render.camera import generate_rays
from pupiloptixlab_tpu_torch.render.vec import Vec3 as TVec3
from pupiloptixlab_tpu_torch.scene import load_scene

DATA = Path(__file__).resolve().parent.parent / "data"
MAX_DISTANCE = 1e16


def _soup(r, t, tcl):
    """tests/test_bvh.py::_random_soup."""
    t_pad = ((t + tcl - 1) // tcl) * tcl
    p0 = np.zeros((t_pad, 3), np.float32)
    p1 = np.zeros_like(p0)
    p2 = np.zeros_like(p0)
    p0[:t] = r.rand(t, 3).astype(np.float32) * 4 - 2
    p1[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    p2[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    return p0, p1, p2, t_pad


def _rays(r, n):
    """tests/test_bvh.py::_rays."""
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = -4.0
    ro += (r.rand(n, 3).astype(np.float32) - 0.5)
    rd = r.rand(n, 3).astype(np.float32) - 0.5
    rd[:, 2] += 1.2
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd, np.full(n, 1e-3, np.float32), np.full(n, MAX_DISTANCE, np.float32)


@pytest.fixture(scope="module")
def soup():
    r = np.random.RandomState(77)
    p0, p1, p2, t_pad = _soup(r, 2100, 32)
    tree = build_bvh(p0, p1, p2, 2100, 32)
    o = tree.order
    packed = np.concatenate([p0[o], p1[o] - p0[o], p2[o] - p0[o],
                             np.zeros((t_pad, 3), np.float32)], 1)
    ro, rd, tmin, tmax = _rays(r, 1024)
    planes = [np.ascontiguousarray(a) for a in
              (ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2], tmin, tmax)]
    return packed, tree, planes


@pytest.fixture(scope="module")
def mesh_env_tcl32():
    """mesh_env flattened by both packages under PUPIL_TCL=32."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PUPIL_TCL", "32")
    try:
        tcls = (port_bvh.pick_leaf_size(20544), jax_bvh.pick_leaf_size(20544))
        scene = load_scene(DATA / "mesh_env.xml")
        scene.sensor.film.w, scene.sensor.film.h = 16, 16
        td, tc = flatten_scene(scene, device="cpu")
        jd, jc = jax_flatten(jax_load_scene(DATA / "mesh_env.xml"))
    finally:
        mp.undo()
    return tcls, (td, tc, camera_block_from_scene(scene, device="cpu")), (jd, jc)


def test_pupil_tcl_gives_both_packages_one_tree(mesh_env_tcl32):
    tcls, (td, tc, _), (jd, jc) = mesh_env_tcl32
    assert tcls == (32, 32)  # 16 in the port before it read PUPIL_TCL
    assert tc.bvh_tcl == jc.bvh_tcl == 32 and tc.bvh_nodes > 0 and not tc.instanced
    port_cfg = dataclasses.asdict(tc)
    ref_cfg = dataclasses.asdict(jc)
    for key in ("width", "height"):  # the port's film was cut for the next test
        port_cfg.pop(key), ref_cfg.pop(key)
    assert port_cfg == ref_cfg
    for f in dataclasses.fields(jd.tris):
        np.testing.assert_array_equal(getattr(td.tris, f.name).numpy(),
                                      np.asarray(getattr(jd.tris, f.name)), err_msg=f.name)
    assert bt.stack_fits(td.tris.bvh_depth)


def test_mt_cols_table_matches_reference(soup):
    packed = soup[0]
    tri = torch.from_numpy(packed)
    center = bt.mt_center(tri)
    got = bt.mt_cols_table(tri, center).numpy()
    want = np.asarray(_mt_cols_table(jnp.asarray(packed), jnp.asarray(center.numpy())))
    assert got.shape == want.shape == (10, 4 * packed.shape[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the centre: the mean of the rows' p0 in both packages
    np.testing.assert_allclose(center.numpy(), np.asarray(jnp.mean(packed[:, 0:3], axis=0)),
                               rtol=1e-6, atol=1e-7)
    # K10's layout holds the same numbers, row by row
    rows = bt.mt_rows_table(tri, center).numpy().reshape(-1, 4, 10)
    leaf_grouped = got.T.reshape(-1, 4, 32, 10).transpose(0, 2, 1, 3).reshape(-1, 4, 10)
    np.testing.assert_array_equal(rows, leaf_grouped)



def test_mt_tables_built_once_per_table(soup):
    tri = torch.from_numpy(soup[0].copy())
    rows, center = bt.mt_tables(tri)
    assert bt.mt_tables(tri)[0] is rows  # kept beside the table
    assert torch.equal(center, bt.mt_center(tri))
    assert torch.equal(rows, bt.mt_rows_table(tri, center))
    other = tri.clone()  # a refit's new table gets its own
    assert bt.mt_tables(other)[0] is not rows
    key = id(other)
    del other
    gc.collect()
    assert key not in bt._MT_TABLES and id(tri) in bt._MT_TABLES


def test_plain_closest_mt_matches_matmul_kernel(soup):
    packed, tree, planes = soup
    p = [torch.from_numpy(a) for a in planes]
    tabs = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (packed, tree.child, tree.axis, tree.boxes)]
    t_m, i_m = bt.bvh_closest_mt(*p, *tabs, tcl=32)  # CPU: the plain version
    t_m, i_m = t_m.numpy(), i_m.numpy()
    args = [jnp.asarray(a) for a in planes]
    bargs = (jnp.asarray(packed), jnp.asarray(tree.child), jnp.asarray(tree.axis),
             jnp.asarray(tree.boxes))
    t_r, i_r = pallas_closest(*args, *bargs, rb=4, tcl=32, interpret=True, mxu=True)
    t_r, i_r = np.asarray(t_r), np.asarray(i_r)
    hit = i_r >= 0
    assert 0.2 < hit.mean() < 0.9, hit.mean()
    np.testing.assert_array_equal(i_m, i_r)
    np.testing.assert_allclose(t_m[hit], t_r[hit], rtol=3e-5, atol=1e-5)
    assert np.all(t_m[~hit] == MAX_DISTANCE)
    # the same closest rows as the classic Moller-Trumbore sweep
    _, i_c = bt.plain_closest(*p, tabs[0])
    np.testing.assert_array_equal(i_m, i_c.numpy())



def _ref_linear_t(tri, center, o, d):
    """t of each lane against its own row through the reference's linear
    form: ``_mt_cols_table``'s columns dotted with the features the TPU
    kernel builds (pallas_bvh.py:626-650) at Precision.HIGHEST, and 1/det
    as one Newton step from an exact reciprocal (:673-675); nan where the
    lane misses its row."""
    n = tri.shape[0]
    pad = np.zeros((((n + 31) // 32) * 32, 12), np.float32)
    pad[:n] = tri
    cols = _mt_cols_table(jnp.asarray(pad), jnp.asarray(center))
    rc = o - center
    cc = np.stack([rc[:, 1] * d[:, 2] - rc[:, 2] * d[:, 1],
                   rc[:, 2] * d[:, 0] - rc[:, 0] * d[:, 2],
                   rc[:, 0] * d[:, 1] - rc[:, 1] * d[:, 0]], 1)
    f = np.concatenate([d, cc, rc, np.ones((n, 1), np.float32)], 1).T
    out = np.asarray(jax.lax.dot_general(
        cols, jnp.asarray(f), (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32))
    j = np.arange(n)
    det, up, vp, tp = (out[128 * (j // 32) + 32 * q + j % 32, j] for q in range(4))
    r = np.float32(1.0) / det
    t = tp * (r * (np.float32(2.0) - det * r))
    ok = ((np.abs(det) >= 1e-12) & (up * det >= 0) & (vp * det >= 0)
          & ((det - up - vp) * det >= 0))
    return np.where(ok, t, np.nan)


def test_linear_form_t_on_the_cards_near_hits():
    """The 32 bounce lanes of mesh_env at 1920x1080 (PUPIL_TCL=32) on which
    the card's K10 and K1 agreed on the row but not on t within rtol 3e-5 +
    atol 1e-5 (tests/data/mt32_near_hits.json, written by chip_smoke.py's
    compare_mt_k1 on an H100). K10's t is the port's plain linear form bit
    for bit; K1's is within the reference's limits of Moller-Trumbore in
    float64; the reference's own linear form, evaluated here, misses the
    float64 t by as much as K10 does, and both stay inside the
    cancellation limit u (|o-c| + |p0-c| + t|d|) |e1||e2| / |det| times 16
    that chip_smoke.py holds K10 to."""
    fx = json.loads((Path(__file__).parent / "data" / "mt32_near_hits.json").read_text())
    lanes = fx["lanes"]
    center = np.asarray(fx["center"], np.float32)
    o, d = (np.asarray([ln[k] for ln in lanes], np.float32) for k in ("o", "d"))
    tri = np.zeros((len(lanes), 12), np.float32)
    tri[:, :9] = [ln["tri"] for ln in lanes]
    t_k10, t_k1 = (np.asarray([ln[k] for ln in lanes], np.float32) for k in ("t_k10", "t_k1"))
    tmn, tmx = (torch.tensor([ln[k] for ln in lanes], dtype=torch.float32)
                for k in ("tmin", "tmax"))
    assert len(lanes) == 32

    # the card's t is the port's plain linear form, bit for bit
    c = torch.from_numpy(center)
    rows = bt.mt_rows_table(torch.from_numpy(tri), c)
    f = bt._mt_features(*torch.from_numpy(o).unbind(1), *torch.from_numpy(d).unbind(1), c)
    t_plain = bt.mt_linear_hit_t(f, tmn, tmx, list(rows.unbind(1)))
    np.testing.assert_array_equal(t_plain.numpy(), t_k10)

    # Moller-Trumbore in float64 on the same float32 inputs, and the limit
    o6, d6, c6 = o.astype(np.float64), d.astype(np.float64), center.astype(np.float64)
    p0, e1, e2 = (tri[:, k:k + 3].astype(np.float64) for k in (0, 3, 6))
    det = (e1 * np.cross(d6, e2)).sum(1)
    t64 = (e2 * np.cross(o6 - p0, e1)).sum(1) / det
    # the card's float64 t, summed in its own order (the cancellation costs
    # float64 some digits too)
    np.testing.assert_allclose(t64, [ln["t_f64"] for ln in lanes], rtol=1e-9)
    norm = np.linalg.norm
    scale = ((norm(o6 - c6, axis=1) + norm(p0 - c6, axis=1) + np.abs(t64) * norm(d6, axis=1))
             * norm(e1, axis=1) * norm(e2, axis=1) / np.abs(det))
    limit = 1e-5 + 3e-5 * np.abs(t64) + 16 * 2.0 ** -24 * scale
    ref_lim = 1e-5 + 3e-5 * np.abs(t64)

    assert np.all(np.abs(t_k1 - t64) <= ref_lim)
    assert np.all(np.abs(t_k10 - t64) > ref_lim)  # why these lanes were kept
    assert np.all(np.abs(t_k10 - t64) <= limit)
    t_ref = _ref_linear_t(tri, center, o, d)
    assert np.isfinite(t_ref).all()  # the reference hits each lane's row too
    assert np.all(np.abs(t_ref - t64) <= limit)
    # and misses the float64 t beyond the reference's own limits on most of them
    assert np.mean(np.abs(t_ref - t64) > ref_lim) >= 0.75


def test_intersect_closest_takes_the_linear_form(mesh_env_tcl32, monkeypatch):
    _, (data, config, cam), _ = mesh_env_tcl32
    # the 16x16 film's camera rays, and as many rays in random directions
    # from random points above the floor (some miss)
    w, h = config.width, config.height
    g = np.random.default_rng(9)
    jx, jy = (torch.from_numpy(g.random(w * h, dtype=np.float32)) for _ in range(2))
    ro_c, rd_c = generate_rays(cam, w, h, jx, jy)
    ro_r = (g.standard_normal((3, w * h)) * 2.0).astype(np.float32)
    ro_r[1] = np.abs(ro_r[1]) + 0.5
    rd_r = g.standard_normal((3, w * h)).astype(np.float32)
    rd_r /= np.linalg.norm(rd_r, axis=0, keepdims=True)
    ro = TVec3(*(torch.cat([c, torch.from_numpy(r)]) for c, r in
                 zip((ro_c.x, ro_c.y, ro_c.z), ro_r)))
    rd = TVec3(*(torch.cat([c, torch.from_numpy(r)]) for c, r in
                 zip((rd_c.x, rd_c.y, rd_c.z), rd_r)))
    n = 2 * w * h
    tmin = torch.full((n,), 1e-4)
    tmax = torch.full((n,), MAX_DISTANCE)
    calls = []
    real = bt.plain_closest_mt

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(bt, "plain_closest_mt", counting)
    base = port_intersect.intersect_closest(ro, rd, tmin, tmax, data, config)
    assert not calls and not port_intersect.uses_mt(data.tris, config)
    monkeypatch.setattr(port_intersect, "MXU_MT", True)
    assert port_intersect.uses_mt(data.tris, config)
    assert not port_intersect.uses_mt(data.tris, dataclasses.replace(config, bvh_tcl=16))
    mt = port_intersect.intersect_closest(ro, rd, tmin, tmax, data, config)
    assert len(calls) == 1
    hit = base.kind.numpy() >= 0
    assert 0.5 < hit.mean() < 0.95, hit.mean()
    np.testing.assert_array_equal(mt.kind.numpy(), base.kind.numpy())
    np.testing.assert_array_equal(mt.prim.numpy(), base.prim.numpy())
    np.testing.assert_allclose(mt.t.numpy()[hit], base.t.numpy()[hit], rtol=3e-5)
    # a table above STREAM_TRI_BYTES keeps K1, as the reference keeps its
    # streamed kernel there
    monkeypatch.setattr(port_bvh, "STREAM_TRI_BYTES", 1024)
    assert not port_intersect.uses_mt(data.tris, config)
