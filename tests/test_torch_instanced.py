"""Port parity: device-side instancing on the CPU.

The scene (``pupiloptixlab_tpu_torch.scene.instanced_grid``): 16 instances of
one 128-triangle displaced grid, a floor and an area-light rectangle (the
reference's instanced test scene, tests/test_instanced.py, at 16 instances),
at a 32x32 film, depth 3. Both packages flatten it into instanced tables:
unique object-space rows, a world tree over per-instance leaf boxes, leaf
(start, instance) tables and per-instance matrices.

* tables, config and the ``inst_refit_ok`` choice (with and without
  ``return_refit``): bit-equal to the JAX flatten;
* the plain K7/K8 (``plain_closest_inst`` / ``plain_anyhit_inst``) against
  the reference's leaf scan ``_sweep_tris_xla_instanced``: the same lanes
  hit, (row, instance) equal, t within rtol 1e-6 plus atol 3e-6 (XLA's CPU
  backend may contract a*b+c into FMAs inside its scan, PyTorch rounds every
  op; the ray transform and the dot products behind t cancel in scene units,
  so the error is a few ulps of 1, not of t). Both break ties at equal t
  to the lowest world leaf, then the lowest row, so no tie is allowed;
* against the reference's instanced Pallas kernel in interpret mode (1,024
  rays): rows and leaves equal except at exact-t ties (which that kernel
  breaks by visit order; counted and bounded), t rtol 2e-4 as the reference's
  own test allows (the TPU kernel takes an approximate reciprocal);
* ``intersect_closest`` / ``intersect_any`` and ``get_local_geometry`` on the
  same rays against the reference's: kind, instance, material and emitter
  ids equal, positions and normals within 1e-5;
* one whole frame (1 spp, seed 0) against the reference's ``render_frame``
  at the tolerances of tests/test_torch_frame.py.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.intersect import _sweep_tris_xla_instanced
from pupiloptixlab_tpu.accel.intersect import intersect_any as jax_intersect_any
from pupiloptixlab_tpu.accel.intersect import intersect_closest as jax_intersect_closest
from pupiloptixlab_tpu.accel.pallas_bvh import bvh_closest as pallas_closest
from pupiloptixlab_tpu.flatten import camera_block_from_scene as jax_camera
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.render.geometry import get_local_geometry as jax_geometry
from pupiloptixlab_tpu.render.integrator import render_frame as jax_render_frame
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu.scene import load_scene as jax_load_scene
from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.accel.intersect import intersect_any, intersect_closest
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
from pupiloptixlab_tpu_torch.render.integrator import render_frame
from pupiloptixlab_tpu_torch.render.vec import Vec3 as TVec3
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.scene.instanced_grid import write_instanced_scene

DATA = Path(__file__).resolve().parent.parent / "data"
SKY = DATA / "env" / "sky.exr"
MAX_DISTANCE = 1e16
TRI_FIELDS = ("packed", "attrs", "chunk_boxes", "mat_id", "emitter_id", "bvh_child",
              "bvh_axis", "bvh_boxes", "leaf_start", "leaf_inst", "inst_w2o", "inst_packed")


@pytest.fixture(scope="module")
def scene_xml(tmp_path_factory):
    return write_instanced_scene(tmp_path_factory.mktemp("inst"), SKY, n_inst=16, grid=8,
                                 width=32, height=32, max_depth=3, area_light=True)


@pytest.fixture(scope="module")
def pair(scene_xml):
    """(reference tables, config, camera), (port tables, config, camera)."""
    scene = jax_load_scene(scene_xml)
    jd, jc = jax_flatten(scene)
    port_scene = load_scene(scene_xml)
    td, tc = flatten_scene(port_scene, device="cpu")
    return (jd, jc, jax_camera(scene)), (td, tc, camera_block_from_scene(port_scene, device="cpu"))


def test_scene_is_instanced(pair):
    (_, jc, _), (td, tc, _) = pair
    assert tc.instanced and jc.instanced and tc.bvh_tcl == 32
    # the bump's 128 rows once + the rectangle shared by the floor and the
    # light (padded to one 32-row leaf); every instance has its own leaves
    assert tuple(td.tris.packed.shape) == (128 + 32, 12)
    assert tuple(td.tris.inst_w2o.shape) == (18, 12)
    assert tuple(td.tris.leaf_start.shape) == (16 * 4 + 2,)
    assert bt.stack_fits(td.tris.bvh_depth)


@pytest.mark.parametrize("field", TRI_FIELDS)
def test_instanced_tables_equal_reference(pair, field):
    (jd, _, _), (td, _, _) = pair
    want = np.asarray(getattr(jd.tris, field))
    got = getattr(td.tris, field).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, field
    np.testing.assert_array_equal(got, want)


def test_instanced_config_equal_reference(pair):
    (_, jc, _), (td, tc, _) = pair
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert td.tris.bvh_depth > 0


@pytest.mark.parametrize("return_refit", [False, True])
def test_inst_refit_ok_choice_matches_reference(scene_xml, return_refit):
    """The light rectangle is emissive: a plain flatten instances the scene,
    a flatten for the device refit keeps the baked tables (inst_refit_ok),
    in both packages, with equal tables and refit records."""
    jout = jax_flatten(jax_load_scene(scene_xml), return_refit=return_refit)
    tout = flatten_scene(load_scene(scene_xml), return_refit=return_refit, device="cpu")
    assert tout[1].instanced == jout[1].instanced == (not return_refit)
    assert dataclasses.asdict(tout[1]) == dataclasses.asdict(jout[1])
    for f in dataclasses.fields(jout[0].tris):
        np.testing.assert_array_equal(getattr(tout[0].tris, f.name).numpy(),
                                      np.asarray(getattr(jout[0].tris, f.name)), err_msg=f.name)
    if return_refit:
        assert type(tout[2]).__name__ == type(jout[2]).__name__ == "RefitData"
        for f in dataclasses.fields(jout[2]):
            a, b = getattr(jout[2], f.name), getattr(tout[2], f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f.name)
            else:
                assert a == b, f.name


def _rays(n, seed):
    """Half the rays from above aimed at the instances, half random."""
    r = np.random.default_rng(seed)
    ro = (r.standard_normal((n, 3)) * 3.0 + [0, 3, 0]).astype(np.float32)
    rd = r.standard_normal((n, 3)).astype(np.float32)
    h = n // 2
    ro[:h] = np.array([0, 6, 0], np.float32) + r.standard_normal((h, 3)).astype(np.float32) * [3, .5, 3]
    tgt = r.uniform(-3, 3, (h, 3)).astype(np.float32)
    tgt[:, 1] = 0.15
    rd[:h] = tgt - ro[:h]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, MAX_DISTANCE, np.float32)
    tmax[::9] = -1.0  # culled lanes
    return [np.ascontiguousarray(a) for a in (*ro.T, *rd.T, tmin, tmax)]


def _port_plain(td, tc, planes):
    p = [torch.from_numpy(a) for a in planes]
    tr = td.tris
    args = (tr.packed, tr.leaf_start, tr.leaf_inst, tr.inst_w2o)
    t, i, leaf = bt.plain_closest_inst(*p, *args, tcl=tc.bvh_tcl)
    occ = bt.plain_anyhit_inst(*p, *args, tcl=tc.bvh_tcl)
    # the wrappers take the plain versions for tables on the CPU
    tabs = (tr.packed, tr.bvh_child, tr.bvh_axis, tr.bvh_boxes, *args[1:], tr.subleaf_boxes)
    kw = dict(tcl=tc.bvh_tcl, depth=tr.bvh_depth)
    assert all(torch.equal(a, b) for a, b in zip(bt.bvh_closest_inst(*p, *tabs, **kw), (t, i, leaf)))
    assert torch.equal(bt.bvh_anyhit_inst(*p, *tabs, **kw), occ)
    return t.numpy(), i.numpy(), leaf.numpy(), occ.numpy()


def test_plain_k7_k8_match_the_reference_leaf_scan(pair):
    (jd, jc, _), (td, tc, _) = pair
    planes = _rays(2048, 11)
    t, i, leaf, occ = _port_plain(td, tc, planes)
    j = [jnp.asarray(a) for a in planes]
    jt, jp, jk, ji = map(np.asarray, _sweep_tris_xla_instanced(
        JVec3(*j[0:3]), JVec3(*j[3:6]), j[6], j[7], jd, jc))
    hit = jk == 0
    assert 0.2 < hit.mean() < 0.9, hit.mean()
    np.testing.assert_array_equal(i >= 0, hit)
    np.testing.assert_array_equal(occ, hit.astype(np.int32))
    np.testing.assert_array_equal(i[hit], jp[hit])
    inst = td.tris.leaf_inst.numpy()[np.maximum(leaf, 0)]
    np.testing.assert_array_equal(inst[hit], ji[hit])
    assert (leaf[~hit] == -1).all() and (t[~hit] == MAX_DISTANCE).all()
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6, atol=3e-6)


def test_plain_k7_matches_the_pallas_kernel(pair):
    """The reference's instanced Pallas traversal in interpret mode: it
    breaks exact-t ties by visit order, the port by (leaf, row)."""
    (jd, jc, _), (td, tc, _) = pair
    planes = _rays(1024, 12)
    t, i, leaf, _ = _port_plain(td, tc, planes)
    jtr = jd.tris
    pt, pi, pleaf = map(np.asarray, pallas_closest(
        *map(jnp.asarray, planes), jtr.packed, jtr.bvh_child, jtr.bvh_axis, jtr.bvh_boxes,
        rb=4, tcl=jc.bvh_tcl, interpret=True, instanced=True, leaf_start=jtr.leaf_start,
        leaf_inst=jtr.leaf_inst, inst_w2o=jtr.inst_w2o))
    hit = pi >= 0
    np.testing.assert_array_equal(i >= 0, hit)
    ties = np.nonzero((i != pi) | (leaf != pleaf))[0]
    assert ties.size <= 2, ties.size
    if ties.size:  # a tie: the Pallas kernel's pick gives the port's own best t
        np.testing.assert_allclose(t[ties], pt[ties], rtol=2e-4)
    np.testing.assert_allclose(t[hit], pt[hit], rtol=2e-4, atol=0)


def test_front_end_and_geometry_match_reference(pair):
    (jd, jc, _), (td, tc, _) = pair
    planes = _rays(2048, 13)
    j = [jnp.asarray(a) for a in planes]
    p = [torch.from_numpy(a) for a in planes]
    jro, jrd, tro, trd = JVec3(*j[0:3]), JVec3(*j[3:6]), TVec3(*p[0:3]), TVec3(*p[3:6])
    jh = jax_intersect_closest(jro, jrd, j[6], j[7], jd, jc)
    th = intersect_closest(tro, trd, p[6], p[7], td, tc)
    kind = th.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(jh.kind))
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_array_equal(th.inst.numpy(), np.asarray(jh.inst))
    assert len(np.unique(th.inst.numpy()[kind == 0])) > 8
    np.testing.assert_array_equal(
        intersect_any(tro, trd, p[6], p[7], td, tc).numpy(),
        np.asarray(jax_intersect_any(jro, jrd, j[6], j[7], jd, jc)))
    jg = jax_geometry(jd, jh, jro, jrd, jc.sphere_count, jc.instanced, jc.curve_count)
    tg = get_local_geometry(td, th, tro, trd, tc.sphere_count, tc.instanced, tc.curve_count)
    for f in ("mat_id", "emitter_id", "front"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)), f)
    assert (tg.emitter_id.numpy() >= 0).any()  # the light rectangle is hit
    for f in ("position", "normal"):
        for c in "xyz":
            np.testing.assert_allclose(getattr(getattr(tg, f), c).numpy(),
                                       np.asarray(getattr(getattr(jg, f), c)),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{f}.{c}")
    for c in "xy":
        np.testing.assert_allclose(getattr(tg.uv, c).numpy(), np.asarray(getattr(jg.uv, c)),
                                   rtol=1e-5, atol=1e-5)


def test_frame_matches_reference(pair):
    """One progressive frame at seed 0 (1 spp): radiance rel MSE <= 1e-5
    with >= 99% of pixels within rtol 1e-4, the RNG test AOV bit-equal,
    albedo within 1e-5, normal within 1e-5 on >= 98% of pixels and 1e-3
    on all (the jitted reference contracts FMAs)."""
    (jd, jc, jcam), (td, tc, tcam) = pair
    n = tc.width * tc.height
    _, jb = jax_render_frame(jd, jcam, jnp.uint32(0), jnp.int32(0),
                             jnp.zeros((n, 3), jnp.float32), jc)
    _, tb = render_frame(td, tcam, 0, 0, torch.zeros((n, 3)), tc)
    want = {k: np.asarray(v) for k, v in jb.items()}
    got = {k: v.numpy() for k, v in tb.items()}
    a, b = got["frame"], want["frame"]
    rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
    frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
    print(f"instanced frame: rel MSE {rel:.3e}, within rtol 1e-4 {frac:.4f}")
    assert np.isfinite(a).all() and a.mean() > 0.0
    assert rel <= 1e-5 and frac >= 0.99, (rel, frac)
    np.testing.assert_array_equal(got["test"], want["test"])
    np.testing.assert_allclose(got["albedo"], want["albedo"], rtol=1e-5, atol=1e-5)
    near = np.isclose(got["normal"], want["normal"], rtol=1e-5, atol=1e-5).all(-1)
    assert near.mean() >= 0.98, near.mean()
    np.testing.assert_allclose(got["normal"], want["normal"], rtol=1e-3, atol=1e-3)


def test_instanced_tables_off_the_cpu_reach_the_kernels(monkeypatch):
    """A tensor off the CPU goes to the K7/K8 launchers (which raise here: no
    nvcc, no card); the wrappers never fall back to the plain scan, and
    raise on a sub-leaf table of the wrong shape, type, layout or device."""
    def no_launcher(name):
        raise RuntimeError(f"launch {name}")

    monkeypatch.setattr(kernels, "launcher", no_launcher)
    kernels.reset_launches()
    p = [torch.zeros(4, device="meta") for _ in range(8)]
    tabs = (torch.zeros((64, 12), device="meta"), torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"), torch.zeros((8, 8), device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"), torch.zeros((1, 12), device="meta"))
    sub = torch.zeros((16, 8), device="meta")  # 64 rows in leaves of 32: 2 x 8 groups
    bad = (torch.zeros((1, 8), device="meta"), torch.zeros((16, 8)),
           torch.zeros((16, 8), dtype=torch.float64, device="meta"),
           torch.zeros((8, 16), device="meta").t())
    for fn, name in ((bt.bvh_closest_inst, "bvh_closest_inst"),
                     (bt.bvh_anyhit_inst, "bvh_anyhit_inst")):
        with pytest.raises(RuntimeError, match=f"launch {name}"):
            fn(*p, *tabs, sub, tcl=32, depth=2)
        with pytest.raises(ValueError, match="stack"):
            fn(*p, *tabs, sub, tcl=32, depth=19)
        for b in bad:
            with pytest.raises(ValueError, match="subleaf_boxes"):
                fn(*p, *tabs, b, tcl=32, depth=2)
        with pytest.raises(TypeError, match="subleaf_boxes"):
            fn(*p, *tabs, tcl=32, depth=2)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
