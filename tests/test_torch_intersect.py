"""Port parity: BVH traversal (K1 closest hit, K2 any hit) and the
intersection front end, on the CPU.

The chunk-sweep route's front end (``bvh_nodes == 0``) is held here too, on
oracle_mat and on mesh_env under PUPIL_NO_BVH, against the reference with
its Pallas sweep kernels in interpret mode; the sweep wrappers themselves
are in test_torch_sweep.py.

On CPU tensors ``bvh_closest`` / ``bvh_anyhit`` run their plain versions
(a brute-force sweep in ``_mt_planes``'s arithmetic, ties at equal t going
to the lowest row). They are held against:

* the reference's Pallas kernels in interpret mode (rb 4, 1,024 rays) on a
  random 5,000-triangle soup and on the mesh_env tables. Indices equal;
  t rtol 3e-5, because the TPU kernel takes an approximate reciprocal plus
  one Newton step for 1/det.
* the reference's XLA sweep ``_sweep_tris_xla`` on 4,096 rays: t rtol 1e-6
  plus atol 1e-6. XLA's CPU backend may contract a*b+c into one FMA where
  PyTorch rounds each op; the dot products behind t cancel in scene units
  (coordinates of order 1), so the error is a few ulps of 1, not of t
  (measured: 1.6e-7 absolute at t = 1e-3, 2.9e-6 at t = 2.8).

A differing index is allowed only where both rows give the port exactly
the same t (a tie, which the port breaks to the lowest row and the
reference by visit order); the tests count those ties and bound them.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.intersect import _sweep_tris_xla
from pupiloptixlab_tpu.accel.intersect import intersect_any as jax_intersect_any
from pupiloptixlab_tpu.accel.intersect import intersect_closest as jax_intersect_closest
from pupiloptixlab_tpu.accel.pallas_bvh import bvh_anyhit as pallas_anyhit
from pupiloptixlab_tpu.accel.pallas_bvh import bvh_closest as pallas_closest
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.accel.bvh import build_bvh, bvh_depth
from pupiloptixlab_tpu_torch.accel.intersect import _mt_planes, intersect_any, intersect_closest
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.render.camera import generate_rays
from pupiloptixlab_tpu_torch.render.vec import Vec3 as TVec3

DATA = Path(__file__).resolve().parent.parent / "data"
MAX_DISTANCE = 1e16


def _soup(r, t, tcl):
    t_pad = ((t + tcl - 1) // tcl) * tcl
    p0 = np.zeros((t_pad, 3), np.float32)
    p1, p2 = np.zeros_like(p0), np.zeros_like(p0)
    p0[:t] = r.random((t, 3), dtype=np.float32) * 4 - 2
    p1[:t] = p0[:t] + (r.random((t, 3), dtype=np.float32) - 0.5) * 0.4
    p2[:t] = p0[:t] + (r.random((t, 3), dtype=np.float32) - 0.5) * 0.4
    return p0, p1, p2


def _soup_tables(r, t, tcl):
    p0, p1, p2 = _soup(r, t, tcl)
    bvh = build_bvh(p0, p1, p2, t, tcl)
    o = bvh.order
    packed = np.concatenate(
        [p0[o], p1[o] - p0[o], p2[o] - p0[o], np.zeros((p0.shape[0], 3), np.float32)], 1
    )
    return packed, bvh


def _rays(r, n):
    """Rays from in front of the soup towards it, unit directions."""
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = -4.0
    ro += r.random((n, 3), dtype=np.float32) - 0.5
    rd = r.random((n, 3), dtype=np.float32) - 0.5
    rd[:, 2] += 1.2
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, MAX_DISTANCE, np.float32)
    tmax[::7] = 4.0  # some short intervals
    tmax[::31] = -1.0  # culled lanes (empty interval)
    return [ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2], tmin, tmax]


def _mt_t(planes, packed, rows):
    """The port's t for ray i against row rows[i] (its _mt_planes)."""
    p = [torch.from_numpy(np.ascontiguousarray(a)) for a in planes]
    tri = torch.from_numpy(packed)[torch.from_numpy(rows.astype(np.int64))]
    _, t, _, _ = _mt_planes(
        TVec3(*p[0:3]), TVec3(*p[3:6]),
        TVec3(tri[:, 0], tri[:, 1], tri[:, 2]), TVec3(tri[:, 3], tri[:, 4], tri[:, 5]),
        TVec3(tri[:, 6], tri[:, 7], tri[:, 8]),
    )
    return t.numpy()


def _compare(planes, packed, got_t, got_i, want_t, want_i, rtol, max_ties, atol=0.0):
    """Indices equal except at exact-t ties (counted); t within rtol."""
    hit = want_i >= 0
    np.testing.assert_array_equal(got_i >= 0, hit)
    diff = np.nonzero(got_i != want_i)[0]
    if diff.size:
        # the port must see the reference's row at exactly its own best t
        t_other = _mt_t([a[diff] for a in planes], packed, want_i[diff])
        np.testing.assert_array_equal(t_other, got_t[diff])
    assert diff.size <= max_ties, f"{diff.size} index ties"
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=rtol, atol=atol)
    assert (got_t[~hit] == MAX_DISTANCE).all()
    return diff.size


def _port(planes, packed, bvh):
    p = [torch.from_numpy(np.ascontiguousarray(a)) for a in planes]
    tabs = [torch.from_numpy(a) for a in (packed, bvh.child, bvh.axis, bvh.boxes)]
    tabs += bt.make_baked_subleaf(tabs[0], bvh.tcl)
    kw = dict(tcl=bvh.tcl, depth=bvh_depth(bvh.child))
    t, i = bt.bvh_closest(*p, *tabs, **kw)
    occ = bt.bvh_anyhit(*p, *tabs, **kw)
    assert t.dtype == torch.float32 and i.dtype == torch.int32 and occ.dtype == torch.int32
    return t.numpy(), i.numpy(), occ.numpy()


def _pallas(planes, packed, bvh):
    args = [jnp.asarray(a) for a in planes]
    tabs = [jnp.asarray(a) for a in (packed, bvh.child, bvh.axis, bvh.boxes)]
    t, i = pallas_closest(*args, *tabs, rb=4, tcl=bvh.tcl, interpret=True)
    occ = pallas_anyhit(*args, *tabs, rb=4, tcl=bvh.tcl, interpret=True)
    return np.asarray(t), np.asarray(i), np.asarray(occ)


def test_soup_matches_pallas_kernels():
    r = np.random.default_rng(5)
    packed, bvh = _soup_tables(r, 5000, 16)
    planes = _rays(r, 1024)
    t, i, occ = _port(planes, packed, bvh)
    wt, wi, wocc = _pallas(planes, packed, bvh)
    assert (wi >= 0).any() and (wi < 0).any()
    _compare(planes, packed, t, i, wt, wi, rtol=3e-5, max_ties=4)
    np.testing.assert_array_equal(occ != 0, wocc != 0)
    np.testing.assert_array_equal(occ != 0, i >= 0)


@pytest.fixture(scope="module")
def mesh_env():
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 128, 8
    data, config = flatten_scene(scene, device="cpu")
    tris = data.tris
    bvh = SimpleNamespace(child=tris.bvh_child.numpy(), axis=tris.bvh_axis.numpy(),
                          boxes=tris.bvh_boxes.numpy(), tcl=config.bvh_tcl)
    return scene, data, config, tris.packed.numpy(), bvh


def _mesh_env_rays(packed, w, h, n, seed):
    """Half camera rays of a w x h film of mesh_env, half rays leaving
    their first hits in random directions (as bounce and shadow rays do)."""
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = w, h
    cam = camera_block_from_scene(scene, device="cpu")
    r = np.random.default_rng(seed)
    jx, jy = (torch.from_numpy(r.random(w * h, dtype=np.float32)) for _ in range(2))
    ro, rd = generate_rays(cam, w, h, jx, jy)
    m = n // 2
    primary = [c.expand(w * h)[:m].numpy().copy() for c in (*ro, *rd)]
    primary += [np.full(m, 1e-4, np.float32), np.full(m, MAX_DISTANCE, np.float32)]
    t, _ = bt.plain_closest(*[torch.from_numpy(a) for a in primary], torch.from_numpy(packed))
    t = np.where(t.numpy() < MAX_DISTANCE, t.numpy(), 1.0)
    org = [primary[k] + primary[k + 3] * t for k in range(3)]
    d = r.standard_normal((3, m)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    secondary = org + list(d) + [primary[6].copy(), primary[7].copy()]
    return [np.concatenate([a, b]).astype(np.float32) for a, b in zip(primary, secondary)]


@pytest.fixture(scope="module")
def mesh_env_rays(mesh_env):
    return _mesh_env_rays(mesh_env[3], 128, 8, 1024, seed=11)


def test_mesh_env_matches_pallas_kernels(mesh_env, mesh_env_rays):
    _, _, _, packed, bvh = mesh_env
    planes = mesh_env_rays
    t, i, occ = _port(planes, packed, bvh)
    wt, wi, wocc = _pallas(planes, packed, bvh)
    assert 0.2 < (wi >= 0).mean() < 0.9
    _compare(planes, packed, t, i, wt, wi, rtol=3e-5, max_ties=4)
    np.testing.assert_array_equal(occ != 0, wocc != 0)


@pytest.mark.parametrize("which", ["soup", "mesh_env"])
def test_plain_sweep_matches_xla_sweep(which, mesh_env):
    r = np.random.default_rng(17)
    if which == "soup":
        packed, _ = _soup_tables(r, 3000, 16)
        planes = _rays(r, 4096)
    else:
        packed = mesh_env[3]
        planes = _mesh_env_rays(packed, 128, 32, 4096, seed=3)
    t, i = bt.plain_closest(*[torch.from_numpy(a) for a in planes], torch.from_numpy(packed))
    jro, jrd = JVec3(*map(jnp.asarray, planes[0:3])), JVec3(*map(jnp.asarray, planes[3:6]))
    scene_ns = SimpleNamespace(tris=SimpleNamespace(packed=jnp.asarray(packed)))
    wt, wp, wk = (np.asarray(a) for a in _sweep_tris_xla(
        jro, jrd, jnp.asarray(planes[6]), jnp.asarray(planes[7]), scene_ns))
    wi = np.where(wk >= 0, wp, -1)
    ties = _compare(planes, packed, t.numpy(), i.numpy(), wt, wi, rtol=1e-6, atol=1e-6,
                    max_ties=8)
    print(f"{which}: {ties} exact-t ties of 4096 rays")


def test_empty_intervals_and_misses():
    """Culled lanes (tmax <= tmin) and misses return (1e16, -1)."""
    r = np.random.default_rng(2)
    packed, bvh = _soup_tables(r, 200, 16)
    planes = _rays(r, 64)
    planes[7][:] = -1.0
    t, i, occ = _port(planes, packed, bvh)
    assert (i == -1).all() and (t == MAX_DISTANCE).all() and (occ == 0).all()


def test_stack_bound_is_checked():
    """The kernels hold the reference's 128 stack entries: depth 18 fits
    (7 * 18 + 1 = 127), 19 does not."""
    assert bt.STACK_SIZE == 128
    assert bt.stack_fits(18) and not bt.stack_fits(19)
    p = [torch.zeros(4, device="meta") for _ in range(8)]
    tabs = (torch.zeros((16, 12), device="meta"), torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"), torch.zeros((8, 8), device="meta"),
            torch.zeros(16, dtype=torch.uint8, device="meta"), torch.zeros((8, 8), device="meta"))
    with pytest.raises(ValueError, match="stack"):
        bt.bvh_closest(*p, *tabs, tcl=16, depth=19)


def test_device_tensors_never_take_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel launcher (which raises here:
    no nvcc, no card); the wrappers never fall back to the plain sweep."""
    def no_launcher(name):
        raise RuntimeError(f"launch {name}")

    monkeypatch.setattr(kernels, "launcher", no_launcher)
    kernels.reset_launches()
    p = [torch.zeros(4, device="meta") for _ in range(8)]
    tabs = (torch.zeros((16, 12), device="meta"), torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"), torch.zeros((8, 8), device="meta"),
            torch.zeros(16, dtype=torch.uint8, device="meta"), torch.zeros((8, 8), device="meta"))
    for fn, name in ((bt.bvh_closest, "bvh_closest"), (bt.bvh_anyhit, "bvh_anyhit")):
        with pytest.raises(RuntimeError, match=f"launch {name}"):
            fn(*p, *tabs, tcl=16, depth=2)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def _scene_pair(name, w, h):
    scene = load_scene(DATA / name)
    scene.sensor.film.w, scene.sensor.film.h = w, h
    return jax_flatten(scene), flatten_scene(scene, device="cpu")


@pytest.mark.parametrize("name", ["oracle_mat.xml", "mesh_env.xml"])
def test_intersect_front_end_matches_reference(name):
    """intersect_closest / intersect_any (triangles + spheres) against the
    reference's CPU path on the same rays: prim and kind equal (up to
    exact-t triangle ties), t rtol 1e-6."""
    (jd, jc), (td, tc) = _scene_pair(name, 64, 16)
    r = np.random.default_rng(23)
    n = 2048
    ro = (r.standard_normal((3, n)) * 2.0).astype(np.float32)
    ro[1] += 1.0
    rd = r.standard_normal((3, n)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, MAX_DISTANCE, np.float32)
    tmax[::5] = r.random(n // 5 + 1, dtype=np.float32)[: tmax[::5].size] * 3.0
    mask = r.random(n) > 0.1
    jh = jax_intersect_closest(JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
                               jnp.asarray(tmin), jnp.asarray(tmax), jd, jc,
                               mask=jnp.asarray(mask))
    th = intersect_closest(TVec3(*map(torch.from_numpy, ro)), TVec3(*map(torch.from_numpy, rd)),
                           torch.from_numpy(tmin), torch.from_numpy(tmax), td, tc,
                           mask=torch.from_numpy(mask))
    kind, wkind = th.kind.numpy(), np.asarray(jh.kind)
    np.testing.assert_array_equal(kind, wkind)
    assert (kind[~mask] == -1).all()
    hit = wkind >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-6, atol=0)
    same = th.prim.numpy() == np.asarray(jh.prim)
    assert (~same).sum() <= 2
    assert ((kind[~same]) == 0).all()
    jocc = jax_intersect_any(JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
                             jnp.asarray(tmin), jnp.asarray(tmax), jd, jc)
    tocc = intersect_any(TVec3(*map(torch.from_numpy, ro)), TVec3(*map(torch.from_numpy, rd)),
                         torch.from_numpy(tmin), torch.from_numpy(tmax), td, tc)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))


def test_chunk_sweep_scene_off_the_cpu_raises(monkeypatch):
    """A scene without a BVH (bvh_nodes == 0) goes to the chunk-sweep
    kernels: tables off the CPU reach the kernel launcher (which raises
    here: no nvcc, no card) and never run plain PyTorch."""
    def no_launcher(name):
        raise RuntimeError(f"launch {name}")

    monkeypatch.setattr(kernels, "launcher", no_launcher)
    (jd, jc), (td, tc) = _scene_pair("oracle_mat.xml", 8, 8)
    assert tc.bvh_nodes == 0 and tc.tri_count > 0
    meta = {f.name: getattr(td.tris, f.name).to("meta")
            for f in dataclasses.fields(td.tris) if f.name != "bvh_depth"}
    scene = dataclasses.replace(td, tris=dataclasses.replace(td.tris, **meta))
    v = TVec3(*(torch.zeros(4, device="meta") for _ in range(3)))
    t = torch.zeros(4, device="meta")
    with pytest.raises(RuntimeError, match="launch sweep_closest"):
        intersect_closest(v, v, t, t, scene, tc)
    with pytest.raises(RuntimeError, match="launch sweep_anyhit"):
        intersect_any(v, v, t, t, scene, tc)


def _stage_rays(seed, n):
    """Rays inside oracle_mat's stage: origins around the spheres, random
    unit directions, a fifth with short intervals."""
    r = np.random.default_rng(seed)
    ro = (r.standard_normal((3, n)) * 2.0).astype(np.float32)
    ro[1] = np.abs(ro[1]) + 0.05
    rd = r.standard_normal((3, n)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, MAX_DISTANCE, np.float32)
    tmax[::5] = r.random(tmax[::5].size, dtype=np.float32) * 3.0
    return ro, rd, tmin, tmax, r.random(n) > 0.1


@pytest.mark.parametrize("name,no_bvh", [("oracle_mat.xml", False), ("mesh_env.xml", True)])
def test_chunk_sweep_front_end_matches_pallas_interpret(name, no_bvh, monkeypatch):
    """intersect_closest / intersect_any on the chunk-sweep route (triangles
    through the plain K5/K6, spheres OR-ed in) against the reference with its
    Pallas sweep kernels in interpret mode (sorted, padded, un-permuted):
    kind equal, occlusion equal, prim equal up to exact-t triangle ties, t
    rtol 3e-5 (the TPU kernel's approximate reciprocal). oracle_mat is one
    chunk; mesh_env under PUPIL_NO_BVH is 321 chunks in 11 super-boxes."""
    from pupiloptixlab_tpu.accel import intersect as jax_intersect

    if no_bvh:
        monkeypatch.setenv("PUPIL_NO_BVH", "1")
    (jd, jc), (td, tc) = _scene_pair(name, 64, 16)
    assert jc.bvh_nodes == 0 and tc.bvh_nodes == 0
    assert td.tris.chunk_boxes.shape[0] == (321 if no_bvh else 1)
    n = 1024
    ro, rd, tmin, tmax, mask = _stage_rays(29, n)
    jargs = (JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
             jnp.asarray(tmin), jnp.asarray(tmax), jd, jc)
    monkeypatch.setattr(jax_intersect, "_PALLAS_INTERPRET", True)
    jh = jax_intersect_closest(*jargs, coherent=False, mask=jnp.asarray(mask))
    jocc = jax_intersect_any(*jargs, coherent=False, mask=jnp.asarray(mask))
    targs = (TVec3(*map(torch.from_numpy, ro)), TVec3(*map(torch.from_numpy, rd)),
             torch.from_numpy(tmin), torch.from_numpy(tmax), td, tc)
    th = intersect_closest(*targs, mask=torch.from_numpy(mask))
    tocc = intersect_any(*targs, mask=torch.from_numpy(mask))
    kind, wkind = th.kind.numpy(), np.asarray(jh.kind)
    np.testing.assert_array_equal(kind, wkind)
    assert (kind[~mask] == -1).all() and not tocc.numpy()[~mask].any()
    hit = wkind >= 0
    assert (kind == 0).any() and (~hit).any()
    if not no_bvh:
        assert (kind == 1).any()  # spheres take part
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=3e-5, atol=0)
    same = th.prim.numpy() == np.asarray(jh.prim)
    assert (~same).sum() <= 2 and (kind[~same] == 0).all()
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(tocc.numpy(), hit)
