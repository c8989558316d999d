"""The chunk sweep's live rows (``rows=`` of K5/K6) and the kernels'
division-free pre-test, on the CPU.

* Every table the sweep route makes holds triangles only in its rows below
  ``config.tri_count``, every row at or past it all zero: ``flatten_scene``
  on oracle_mat and on mesh_env under ``PUPIL_NO_BVH``, ``scene_from_arrays``
  from the reference's arrays, a baked refit that hides an object (the
  hidden rows keep p0 with zero edges: they stay below ``rows``, are tested
  and never hit), and ``shard_tris``' shards (only zero rows past each
  shard's live count; the ring passes a held shard's row count, and only
  the zero rows it appends lie past that).
* The plain sweep over the rows below ``rows`` equals the plain sweep over
  every row, and the reference's Pallas ``sweep_triangles`` /
  ``sweep_triangles_any`` in interpret mode (rows equal, t rtol 3e-5: the
  TPU kernel takes an approximate reciprocal), on seeded rays.
* ``mt_pretest`` (csrc/sweep.cu ``mt_cheap``'s test before the division)
  never rejects a pair that ``mt_hit_t`` accepts: on seeded rays against
  every row of a soup, on rays aimed at the soup's edges and vertices (u
  near 0 and 1), and on rays whose u underflows to -0.0, which passes u >= 0.
* The wrappers raise ValueError on a missing, negative or too large ``rows``
  on the CPU and on the meta device.
* Soundness of the kernels' culling: every (ray, row) hit that ``mt_hit_t``
  accepts lies in a chunk (and, above 32 chunks, a super-box) whose
  ``sweep_boxes`` box ``group_slab`` passes with the hit's t as the far
  limit, on oracle_mat and soups of 128-2,560 rows, for seeded and far
  rays, rays with a zero direction component, rays in the planes of chunk
  box faces and rays grazing them; with the pads set to 0 the face rays
  find hits the boxes drop.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.pallas_intersect import sweep_triangles, sweep_triangles_any
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.accel import sweep as sw
from pupiloptixlab_tpu_torch.flatten import flatten_scene
from pupiloptixlab_tpu_torch.flatten.convert import config_from_fields, scene_from_arrays
from pupiloptixlab_tpu_torch.flatten.refit import refit_scene
from pupiloptixlab_tpu_torch.parallel.ring_sweep import shard_tris, sweep_round, sweep_shard
from pupiloptixlab_tpu_torch.scene import load_scene

DATA = Path(__file__).resolve().parent.parent / "data"
GROUPS = ("tris", "spheres", "curves", "materials", "textures", "emitters")
FLOOR = 1  # mesh_env's shape instance hidden by the refit (tests/test_torch_refit.py)


def _live_count(packed):
    """The rows up to the last one that is not all zero."""
    nz = torch.nonzero((packed != 0).any(dim=1))
    return int(nz[-1]) + 1 if nz.numel() else 0


def _tail_is_zero(packed, rows):
    return bool((packed[rows:] == 0).all())


def _live_rows_nonzero(packed, rows):
    """Rows below ``rows`` hold a triangle: an edge that is not zero (a row
    hidden by a refit keeps p0 and zero edges)."""
    return bool((packed[:rows, 0:9] != 0).any(1).all())


@pytest.fixture(scope="module")
def mesh_env_nobvh():
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 32, 18
    mp = pytest.MonkeyPatch()
    mp.setenv("PUPIL_NO_BVH", "1")
    try:
        data, config, records = flatten_scene(scene, return_refit=True, device="cpu")
    finally:
        mp.undo()
    return scene, data, config, records


def _soup(rows, live, seed):
    r = np.random.default_rng(seed)
    p0 = r.random((live, 3), dtype=np.float32) * 4 - 2
    p0 = p0[np.argsort(p0[:, 0])]
    packed = np.zeros((rows, 12), np.float32)
    packed[:live, 0:3] = p0
    packed[:live, 3:9] = (r.random((live, 6), dtype=np.float32) - 0.5) * 0.5
    verts = np.stack([p0, p0 + packed[:live, 3:6], p0 + packed[:live, 6:9]])
    lo = np.full((rows, 3), 1e30, np.float32)
    hi = np.full((rows, 3), -1e30, np.float32)
    lo[:live], hi[:live] = verts.min(0), verts.max(0)
    boxes = np.zeros((rows // 64, 8), np.float32)
    boxes[:, 0:3] = lo.reshape(-1, 64, 3).min(1)
    boxes[:, 3:6] = hi.reshape(-1, 64, 3).max(1)
    return torch.from_numpy(packed), torch.from_numpy(boxes)


def _rays(seed, n, z0=-4.0):
    r = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = z0
    ro += r.random((n, 3), dtype=np.float32) - 0.5
    rd = r.random((n, 3), dtype=np.float32) - 0.5
    rd[:, 2] += 1.2
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, sw.MAX_DISTANCE, np.float32)
    tmax[::7] = 4.0
    tmax[::31] = -1.0
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (*ro.T, *rd.T, tmin, tmax)]


def test_flattened_sweep_tables_hold_rows_below_tri_count(mesh_env_nobvh):
    _, data, config, _ = mesh_env_nobvh
    assert config.bvh_nodes == 0 and data.tris.packed.shape[0] == 20544
    assert config.tri_count == 20482 == _live_count(data.tris.packed)
    assert _tail_is_zero(data.tris.packed, config.tri_count)
    assert _live_rows_nonzero(data.tris.packed, config.tri_count)
    scene = load_scene(DATA / "oracle_mat.xml")
    scene.sensor.film.w, scene.sensor.film.h = 16, 16
    d, c = flatten_scene(scene, device="cpu")
    assert c.bvh_nodes == 0 and d.tris.packed.shape[0] == 64 and c.tri_count == 4
    assert _tail_is_zero(d.tris.packed, c.tri_count)
    assert _live_rows_nonzero(d.tris.packed, c.tri_count)


def test_converted_sweep_table_holds_rows_below_tri_count():
    from pupiloptixlab_tpu.scene import load_scene as jax_load_scene

    scene = jax_load_scene(DATA / "oracle_mat.xml")
    scene.sensor.film.w, scene.sensor.film.h = 16, 16
    jd, jc = jax_flatten(scene)
    tree = {g: {f.name: np.asarray(getattr(getattr(jd, g), f.name))
                for f in dataclasses.fields(getattr(jd, g))} for g in GROUPS}
    config = config_from_fields(dataclasses.asdict(jc))
    conv = scene_from_arrays(tree, config, device="cpu")
    assert config.bvh_nodes == 0 and config.tri_count == 4
    assert _tail_is_zero(conv.tris.packed, config.tri_count)
    assert _live_rows_nonzero(conv.tris.packed, config.tri_count)


def test_refit_hiding_an_object_keeps_rows_below_tri_count(mesh_env_nobvh):
    scene, data, config, records = mesh_env_nobvh
    scene.shape_instances[FLOOR].visibility_mask = 0
    try:
        got = refit_scene(data, records, scene)
    finally:
        scene.shape_instances[FLOOR].visibility_mask = 1
    p = got.tris.packed
    assert _tail_is_zero(p, config.tri_count)
    hidden = (p[:config.tri_count, 3:9] == 0).all(1)
    assert 0 < int(hidden.sum()) < config.tri_count  # the floor's rows: p0, zero edges
    assert bool((p[:config.tri_count][hidden, 0:3] != 0).any())
    # hidden rows are tested and never hit: the plain sweep over the rows
    # below tri_count equals the one over every row, and no hit is hidden
    planes = _rays(5, 256, z0=-6.0)
    t_a, i_a = sw.plain_sweep_closest(*planes, p)
    t_r, i_r = sw.plain_sweep_closest(*planes, p[:config.tri_count].contiguous())
    assert torch.equal(t_a, t_r) and torch.equal(i_a, i_r)
    assert not bool(hidden[i_a[i_a >= 0].long()].any())
    # the sweep's boxes follow the rows: the floor's chunks shrink or close
    assert torch.equal(got.tris.sweep_boxes, bt.sweep_boxes(p))
    assert not torch.equal(got.tris.sweep_boxes, data.tris.sweep_boxes)


def test_shards_keep_zero_rows_past_their_live_count(mesh_env_nobvh):
    _, data, config, _ = mesh_env_nobvh
    for n_shards in (2, 3, 4):
        table, shard_rows = shard_tris(data.tris.packed, n_shards)
        for s in range(n_shards):
            shard = table[s * shard_rows:(s + 1) * shard_rows]
            live = _live_count(shard)
            assert live == min(max(config.tri_count - s * shard_rows, 0), shard_rows)
            assert _tail_is_zero(shard, live)
    # the ring holds a shard for K5 padded to whole chunks with its boxes, and
    # passes its row count: on CPU tensors the round equals the plain inner's
    rows, boxes = sweep_shard(shard, "kernel")
    assert rows.shape[0] % sw.CHUNK == 0 and torch.equal(rows[:shard_rows], shard)
    assert _tail_is_zero(rows, shard_rows) and torch.equal(boxes, bt.sweep_boxes(rows))
    planes = _rays(6, 64, z0=-6.0)
    best = (torch.full((64,), sw.MAX_DISTANCE), torch.full((64,), -1, dtype=torch.int32))
    got = sweep_round(*best, planes, (rows, boxes), 7, shard_rows, inner="kernel")
    want = sweep_round(*best, planes, sweep_shard(shard), 7, shard_rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # a BVH-ordered table pads inside its leaves: the count reaches its last
    # nonzero row, and only zero rows lie past it
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 16, 16
    bvh_data, bvh_config = flatten_scene(scene, device="cpu")
    assert bvh_config.bvh_nodes > 0
    table, shard_rows = shard_tris(bvh_data.tris.packed, 3)
    for s in range(3):
        shard = table[s * shard_rows:(s + 1) * shard_rows]
        live = _live_count(shard)
        assert _tail_is_zero(shard, live) and bool((shard[live - 1] != 0).any())


@pytest.mark.parametrize("case", ["oracle_mat", "soup_256"])
def test_plain_sweep_over_live_rows_matches_every_row_and_pallas(case):
    if case == "oracle_mat":
        scene = load_scene(DATA / "oracle_mat.xml")
        scene.sensor.film.w, scene.sensor.film.h = 16, 16
        d, c = flatten_scene(scene, device="cpu")
        tri, boxes, rows = d.tris.packed, d.tris.chunk_boxes, c.tri_count
        planes = _rays(11, 256, z0=-1.0)
        planes[1] = planes[1] + 1.0  # inside the stage, above the floor
    else:
        tri, boxes = _soup(256, 250, 256)
        rows = 250
        planes = _rays(12, 256)
    t_a, i_a = sw.plain_sweep_closest(*planes, tri)
    o_a = sw.plain_sweep_anyhit(*planes, tri)
    live = tri[:rows].contiguous()
    t_r, i_r = sw.plain_sweep_closest(*planes, live)
    o_r = sw.plain_sweep_anyhit(*planes, live)
    assert torch.equal(t_a, t_r) and torch.equal(i_a, i_r) and torch.equal(o_a, o_r)
    sb = bt.sweep_boxes(tri)
    t_w, i_w = sw.sweep_closest(*planes, tri, sb, rows=rows)  # the CPU wrappers
    assert torch.equal(t_w, t_a) and torch.equal(i_w, i_a)
    assert torch.equal(sw.sweep_anyhit(*planes, tri, sb, rows=rows), o_a)
    args = [jnp.asarray(p.numpy()) for p in planes]
    wt, wi = sweep_triangles(*args, jnp.asarray(tri.numpy()), jnp.asarray(boxes.numpy()),
                             rb=2, tc=64, interpret=True)
    wocc = sweep_triangles_any(*args, jnp.asarray(tri.numpy()), jnp.asarray(boxes.numpy()),
                               rb=2, tc=64, interpret=True)
    wt, wi = np.asarray(wt), np.asarray(wi)
    assert (wi >= 0).sum() > 10
    np.testing.assert_array_equal(i_r.numpy(), wi)
    hit = wi >= 0
    np.testing.assert_allclose(t_r.numpy()[hit], wt[hit], rtol=3e-5)
    np.testing.assert_array_equal(o_r.numpy() != 0, np.asarray(wocc) != 0)


def _pretest_holds(planes, tri):
    """(pairs mt_hit_t accepts, of them rejected by mt_pretest, pairs
    rejected), all rays against all rows."""
    ray = [p[:, None] for p in planes]
    cols = [tri[None, :, k] for k in range(9)]
    hit = sw.mt_hit_t(*ray, cols) < sw.MAX_DISTANCE
    keep = sw.mt_pretest(*ray[:6], cols)
    return int(hit.sum()), int((hit & ~keep).sum()), int((~keep).sum())


def test_pretest_never_rejects_a_hit():
    tri, _ = _soup(512, 507, 7)
    planes = _rays(13, 2048)
    hits, lost, rejected = _pretest_holds(planes, tri)
    assert hits > 500 and lost == 0 and rejected > hits  # it does reject most pairs
    # rays aimed at edges and vertices: u near 0 and near 1
    r = np.random.default_rng(14)
    live = tri[:507]
    rows = torch.from_numpy(r.integers(0, 507, 4096))
    s = torch.from_numpy(r.random(4096, dtype=np.float32))
    p0, e1, e2 = live[rows, 0:3], live[rows, 3:6], live[rows, 6:9]
    targets = torch.cat([p0[:1024] + s[:1024, None] * e2[:1024],           # u = 0 edge
                         p0[1024:2048] + e1[1024:2048],                     # u = 1 vertex
                         p0[2048:3072] + s[2048:3072, None] * e1[2048:3072]
                         + (1 - s[2048:3072, None]) * e2[2048:3072],        # u + v = 1
                         p0[3072:]])                                        # u = v = 0
    origin = targets + torch.from_numpy((r.random((4096, 3), dtype=np.float32) - 0.5) * 4)
    d = targets - origin
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    planes = [*origin.T.contiguous(), *d.T.contiguous(), torch.full((4096,), 1e-4),
              torch.full((4096,), sw.MAX_DISTANCE)]
    hits, lost, _ = _pretest_holds(planes, tri)
    assert hits > 1000 and lost == 0


def test_pretest_keeps_a_u_that_underflows_to_minus_zero():
    """p0 = 0, e1 = (1e5, 0, 0), e2 = (0, 1e5, 0): det = -1e10 and u_num =
    -1e5 * ox, so ox = -3e-41 gives u = 3e-36 * -1e-10, below half the
    least subnormal: u = -0.0, which passes u >= 0; v = 0.5, t = 1."""
    tri = torch.zeros((64, 12))
    tri[0, 3], tri[0, 7] = 1e5, 1e5
    ox = torch.tensor([-3e-41, 3e-41, -1e-20, 0.0])  # u: -0.0, +0.0, -1e-25, 0.0
    planes = [ox, torch.full((4,), 5e4), torch.full((4,), -1.0), torch.zeros(4),
              torch.zeros(4), torch.ones(4), torch.full((4,), 1e-4),
              torch.full((4,), sw.MAX_DISTANCE)]
    ray = [p[:, None] for p in planes]
    cols = [tri[None, :1, k] for k in range(9)]
    t = sw.mt_hit_t(*ray, cols)[:, 0]
    keep = sw.mt_pretest(*ray[:6], cols)[:, 0]
    assert (t < sw.MAX_DISTANCE / 2).tolist() == [True, True, False, True]  # -0.0 passes
    assert t[[0, 1, 3]].tolist() == [1.0, 1.0, 1.0]
    assert keep.tolist() == [True, True, False, True]
    t_k, i_k = sw.sweep_closest(*planes, tri, bt.sweep_boxes(tri), rows=1)
    assert i_k.tolist() == [0, 0, -1, 0]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_a_bad_rows(device, monkeypatch):
    def no_launcher(name):
        raise RuntimeError(f"launch {name}")

    monkeypatch.setattr(kernels, "launcher", no_launcher)
    p = [torch.zeros(4, device=device) for _ in range(8)]
    tri = torch.zeros((128, 12), device=device)
    boxes = torch.zeros((2, 8), device=device)
    for fn in (sw.sweep_closest, sw.sweep_anyhit):
        with pytest.raises(ValueError, match="rows= .* is required"):
            fn(*p, tri, boxes)
        for bad in (-1, 129, 2.0, True):
            with pytest.raises(ValueError, match="rows"):
                fn(*p, tri, boxes, rows=bad)
        if device == "meta":
            with pytest.raises(RuntimeError, match="launch"):
                fn(*p, tri, boxes, rows=128)
        else:
            fn(*p, tri, boxes, rows=0)


# --- soundness of the culling boxes -------------------------------------------


@pytest.fixture(scope="module")
def sweep_tables():
    """oracle_mat's table (one chunk, 4 live rows) and soups of 128, 512,
    1,024 and 2,560 rows (the last two chunks' 5 rows padding; 2,560 rows
    take two super-boxes)."""
    scene = load_scene(DATA / "oracle_mat.xml")
    scene.sensor.film.w, scene.sensor.film.h = 8, 8
    d, c = flatten_scene(scene, device="cpu")
    tables = {"oracle_mat": (d.tris.packed, c.tri_count)}
    for rows in (128, 512, 1024, 2560):
        tables[f"soup_{rows}"] = (_soup(rows, rows - 5, rows)[0], rows - 5)
    return tables


def _unsound(packed, ro, rd, boxes, chunk=64):
    """(hits, unsound hits) of rays (N, 3) over every row: the (ray, row)
    pairs that ``mt_hit_t`` accepts, and those whose chunk box, or above 32
    chunks whose super-box, ``group_slab`` drops with the hit's t as the far
    limit."""
    n_chunks = packed.shape[0] // sw.CHUNK
    cols = [packed[None, :, k] for k in range(9)]
    hits = bad = 0
    for s in range(0, ro.shape[0], chunk):
        o = [torch.from_numpy(np.ascontiguousarray(ro[s:s + chunk, k])) for k in range(3)]
        d = [torch.from_numpy(np.ascontiguousarray(rd[s:s + chunk, k])) for k in range(3)]
        n = o[0].shape[0]
        tmin, tmax = torch.full((n, 1), 1e-3), torch.full((n, 1), 1e16)
        t = sw.mt_hit_t(*[x[:, None] for x in o + d], tmin, tmax, cols)  # (n, T)
        ri, rr = torch.nonzero(t < sw.MAX_DISTANCE, as_tuple=True)
        th = t[ri, rr]
        ray = ([x[ri] for x in o], [x[ri] for x in d], [bt._safe_inv(x[ri]) for x in d])
        which = [rr // sw.CHUNK]
        if n_chunks > sw.GROUP:
            which.append(n_chunks + rr // (sw.CHUNK * sw.GROUP))
        ok = torch.ones_like(th, dtype=torch.bool)
        for k in which:
            passed, tn = bt.group_slab(boxes[k], *ray, tmin[ri, 0], th)
            ok &= passed & (tn <= th)
        hits += int(ri.numel())
        bad += int((~ok).sum())
    return hits, bad


def _aimed(packed, live, n, seed, dist, zero_axis=False):
    """Rays aimed at a vertex, an edge point or an inside point of seeded
    live rows from ``dist`` away in a seeded direction; with ``zero_axis``
    one direction component is exactly 0 (the origin then shares the
    target's coordinate on that axis)."""
    r = np.random.default_rng(seed)
    p = packed[:live].numpy().astype(np.float64)
    pick = p[r.integers(0, live, n)]
    u, v = r.uniform(0, 1, (2, n))
    kind = r.integers(0, 3, n)  # 0: a vertex, 1: an edge point, 2: inside
    u = np.where(kind == 0, np.round(u), np.where(kind == 1, u, u * 0.5))
    v = np.where(kind == 0, 0.0, np.where(kind == 1, 1.0 - u, v * 0.5))
    target = pick[:, 0:3] + u[:, None] * pick[:, 3:6] + v[:, None] * pick[:, 6:9]
    d = r.standard_normal((n, 3))
    if zero_axis:
        d[np.arange(n), r.integers(0, 3, n)] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    target = target.astype(np.float32).astype(np.float64)
    o = np.where(d == 0.0, target, target - d * dist)
    return o.astype(np.float32), d.astype(np.float32)


def _face_rays(packed, live, seed, tilt=False, per_face=4):
    """Rays in the plane of each face of each chunk's tight box over its
    live rows' vertices (through the vertex that makes the face, the
    direction exactly zero across it) from seeded points 1-3 units out in
    that plane; with ``tilt`` the ray crosses the plane at a seeded slope of
    1e-7 to 1e-3 through the same vertex (grazing the face)."""
    r = np.random.default_rng(seed)
    p = packed[:live].numpy().astype(np.float64)
    verts = np.stack([p[:, 0:3], p[:, 0:3] + p[:, 3:6], p[:, 0:3] + p[:, 6:9]], 1)
    verts = verts.astype(np.float32).astype(np.float64)
    os_, ds = [], []
    for c0 in range(0, live, sw.CHUNK):
        v = verts[c0:c0 + sw.CHUNK].reshape(-1, 3)
        for a in range(3):
            for face in (v[:, a].min(), v[:, a].max()):
                vert = v[v[:, a] == face][0]
                for _ in range(per_face):
                    o = vert.copy()
                    o[(a + 1) % 3] += r.uniform(1.0, 3.0) * r.choice([-1.0, 1.0])
                    o[(a + 2) % 3] += r.uniform(1.0, 3.0) * r.choice([-1.0, 1.0])
                    d = vert - o
                    if tilt:
                        d[a] = 2.5 * 10.0 ** r.uniform(-7, -3) * r.choice([-1.0, 1.0])
                        o[a] = vert[a] - d[a]
                    os_.append(o)
                    ds.append(d)
    return np.stack(os_).astype(np.float32), np.stack(ds).astype(np.float32)


def _sweep_rays(kind, packed, live):
    ext = float(packed.abs().max())
    if kind.endswith("faces"):
        per_face = max(4, 512 // max(live // sw.CHUNK, 1) // 6)
        return _face_rays(packed, live, 3, tilt=kind == "grazing_faces", per_face=per_face)
    dist = 1e3 * ext if kind == "far" else 0.5 * ext
    return _aimed(packed, live, 256, 7, dist, zero_axis=kind == "zero_direction")


@pytest.mark.parametrize("kind", ["seeded", "far", "zero_direction", "faces", "grazing_faces"])
def test_sweep_boxes_hold_every_accepted_hit(sweep_tables, kind):
    for name, (packed, live) in sweep_tables.items():
        ro, rd = _sweep_rays(kind, packed, live)
        hits, bad = _unsound(packed, ro, rd, bt.sweep_boxes(packed))
        assert hits > 50 and bad == 0, (name, hits, bad)


def test_sweep_boxes_need_their_pads(sweep_tables, monkeypatch):
    """The face rays above are strong enough to catch boxes without the
    spatial pads: unpadded chunk boxes drop some of their hits."""
    monkeypatch.setattr(bt, "SUBLEAF_PAD", 0.0)
    monkeypatch.setattr(bt, "SCENE_PAD", 0.0)
    dropped = 0
    for packed, live in sweep_tables.values():
        for kind in ("faces", "grazing_faces"):
            ro, rd = _sweep_rays(kind, packed, live)
            dropped += _unsound(packed, ro, rd, bt.sweep_boxes(packed))[1]
    assert dropped > 0
