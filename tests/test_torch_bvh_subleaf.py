"""The spatial sub-leaf level of the baked traversal (K1/K2/K11), on the CPU.

K1, K2 and K11 test a baked leaf's rows only in the groups whose world
boxes the ray enters (``accel/bvh_traverse.py::make_baked_subleaf``: each
leaf's live rows in ``SUBLEAF_GROUPS`` groups by median splits on their
centroids, a leaf-local row order and one padded box a group). The kernels
run only on the card, where ``chip_smoke.py`` holds them against the full
leaf scan; here:

* the table equals an independent numpy construction on mesh_env and on
  the deep soup, through the flatten and through ``scene_from_arrays`` from
  the reference's arrays; the baked refit keeps the row order and rebuilds
  the boxes from the moved rows (equal to the numpy construction on the
  refit's rows); each ring shard carries its own;
* soundness: every (ray, row) hit that ``mt_hit_t`` accepts lies in a
  group whose box ``group_slab`` passes with the hit's t as the far limit,
  entered no later than the hit: on seeded rays, rays from origins 1e3
  times the scene's extent away, groups of small triangles near (0, 0, 0)
  seen from a few units away, rays along group-box faces and rays with
  exactly zero direction components;
* ``tree_walk`` (K1's walk, the plain version of K11) with the sub-leaf
  step gives the brute sweep's (t, row) and the same pops and leaves as
  with the all-pass table, resolves a tie across two groups to the lower
  row, and the wrappers refuse a missing or malformed table and a leaf size
  without a kernel.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.accel.sweep import MAX_DISTANCE, mt_hit_t
from pupiloptixlab_tpu_torch.flatten import flatten_scene
from pupiloptixlab_tpu_torch.flatten.convert import config_from_fields, scene_from_arrays
from pupiloptixlab_tpu_torch.flatten.refit import refit_scene
from pupiloptixlab_tpu_torch.parallel.ring_sweep import build_ring_bvh
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.scene.deep_soup import soup_tables
from pupiloptixlab_tpu_torch.utils.math import Transform

DATA = Path(__file__).resolve().parent.parent / "data"
GROUPS = ("tris", "spheres", "curves", "materials", "textures", "emitters")
G = bt.SUBLEAF_GROUPS


@pytest.fixture(scope="module")
def mesh_env():
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 32, 16
    data, config = flatten_scene(scene, device="cpu")
    assert config.bvh_nodes > 0 and config.bvh_tcl == 16
    return scene, data, config


def _live(p):
    return (p[:, 3:6] != 0).any(1) & (p[:, 6:9] != 0).any(1)


def numpy_order(packed: np.ndarray, tcl: int) -> np.ndarray:
    """The leaf-local row order from its definition, leaf by leaf: live rows
    (nonzero e1 and e2) split recursively at the median of their centroids
    (3 p0 + e1 + e2 in float64, stable sort) along the widest axis, the
    left half taking ceil(n / 2) of them up to half the slots, each half
    filled up with the leaf's other rows in row order."""
    p = packed[:, 0:9].astype(np.float64)
    live = _live(p)
    cen = 3.0 * p[:, 0:3] + p[:, 3:6] + p[:, 6:9]
    gr = tcl // G

    def split(lv, dead, cap):
        if cap == gr:
            return [lv + dead]
        ax = int(np.argmax(np.ptp(cen[lv], axis=0))) if lv else 0
        lv = [lv[k] for k in np.argsort([cen[r, ax] for r in lv], kind="stable")]
        half = cap // 2
        nl = min(half, (len(lv) + 1) // 2)
        return (split(lv[:nl], dead[:half - nl], half)
                + split(lv[nl:], dead[half - nl:], half))

    out = np.zeros(packed.shape[0], np.uint8)
    for base in range(0, packed.shape[0], tcl):
        rows = list(range(base, base + tcl))
        groups = split([r for r in rows if live[r]], [r for r in rows if not live[r]], tcl)
        out[base:base + tcl] = np.concatenate(groups) - base
    return out


def numpy_boxes(packed: np.ndarray, order: np.ndarray, tcl: int) -> np.ndarray:
    """The group boxes from their definition: per group the float64 bounds
    of its live rows' vertices, widened by SUBLEAF_PAD times the box's
    largest |coordinate| plus SCENE_PAD times the table's largest live
    |coordinate|, rounded outward to float32; the never-box without a live
    row."""
    p = packed[:, 0:9].astype(np.float64)
    live = _live(p)
    verts = np.stack([p[:, 0:3], p[:, 0:3] + p[:, 3:6], p[:, 0:3] + p[:, 6:9]], 1)
    extent = np.abs(verts[live]).max() if live.any() else 0.0
    gr = tcl // G
    slots = np.arange(p.shape[0]) // tcl * tcl + order.astype(np.int64)
    out = np.zeros((p.shape[0] // gr, 8), np.float32)
    for g in range(out.shape[0]):
        rows = [r for r in slots[g * gr:(g + 1) * gr] if live[r]]
        if not rows:
            out[g, 0:6] = 1e30
            continue
        v = verts[rows].reshape(-1, 3)
        lo, hi = v.min(0), v.max(0)
        pad = bt.SUBLEAF_PAD * max(np.abs(lo).max(), np.abs(hi).max()) + bt.SCENE_PAD * extent
        for a in range(3):
            x = np.float32(lo[a] - pad)
            out[g, a] = np.nextafter(x, np.float32(-np.inf)) if x > lo[a] - pad else x
            x = np.float32(hi[a] + pad)
            out[g, 3 + a] = np.nextafter(x, np.float32(np.inf)) if x < hi[a] + pad else x
    return out


def _assert_numpy_table(packed, rows, boxes, tcl):
    order = numpy_order(packed.numpy(), tcl)
    assert rows.dtype == torch.uint8 and rows.is_contiguous() and boxes.is_contiguous()
    np.testing.assert_array_equal(rows.numpy(), order)
    np.testing.assert_array_equal(boxes.numpy(), numpy_boxes(packed.numpy(), order, tcl))


def test_table_equals_numpy_construction_on_mesh_env(mesh_env):
    _, data, config = mesh_env
    tr = data.tris
    _assert_numpy_table(tr.packed, tr.subleaf_rows, tr.subleaf_boxes, config.bvh_tcl)
    # each leaf's order is a permutation of its rows
    order = tr.subleaf_rows.long().reshape(-1, config.bvh_tcl)
    assert torch.equal(order.sort(1).values, torch.arange(config.bvh_tcl).expand_as(order))


def test_table_equals_numpy_construction_on_the_deep_soup():
    soup = soup_tables()
    _assert_numpy_table(soup["tri"], soup["subleaf_rows"], soup["subleaf_boxes"], soup["tcl"])


def test_converted_scene_derives_the_table(mesh_env):
    scene, data, config = mesh_env
    jd, jc = jax_flatten(scene)
    tree = {g: {f.name: np.asarray(getattr(getattr(jd, g), f.name))
                for f in dataclasses.fields(getattr(jd, g))} for g in GROUPS}
    conv = scene_from_arrays(tree, config_from_fields(dataclasses.asdict(jc)), device="cpu")
    assert torch.equal(conv.tris.packed, data.tris.packed)
    assert torch.equal(conv.tris.subleaf_rows, data.tris.subleaf_rows)
    assert torch.equal(conv.tris.subleaf_boxes, data.tris.subleaf_boxes)


def test_baked_refit_rebuilds_the_boxes():
    """Object 0 moved and object 1 hidden (phase 12's mesh_env edit): the
    refit keeps the row order and its boxes are the numpy construction
    from the moved rows (a hidden row has zero edges: it is left out)."""
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 32, 16
    data, config, records = flatten_scene(scene, return_refit=True, device="cpu")
    ros = scene.shape_instances
    ros[0].transform = Transform(Transform().translate(0.4, 0.25, -0.3).matrix
                                 @ ros[0].transform.matrix)
    ros[1].visibility_mask = 0
    got = refit_scene(data, records, scene).tris
    assert got.subleaf_rows is data.tris.subleaf_rows
    assert not torch.equal(got.subleaf_boxes, data.tris.subleaf_boxes)
    want = numpy_boxes(got.packed.numpy(), got.subleaf_rows.numpy(), config.bvh_tcl)
    np.testing.assert_array_equal(got.subleaf_boxes.numpy(), want)
    assert int(bt._live_rows(got.packed).sum()) < int(bt._live_rows(data.tris.packed).sum())


def test_each_ring_shard_carries_its_table(mesh_env):
    _, data, _ = mesh_env
    ring = build_ring_bvh(data.tris.packed, 4)
    assert ring.subleaf_rows.shape == ring.rows.shape[:2]
    for s in range(4):
        tabs = ring.shard_tables(s)
        assert len(tabs) == 6
        _assert_numpy_table(tabs[0], tabs[4], tabs[5], ring.tcl)


# --- soundness -------------------------------------------------------------


def _unsound(packed, rows, boxes, tcl, ro, rd, chunk=64):
    """(hits, unsound hits) of rays (N, 3) over every row: the (ray, row)
    pairs that ``mt_hit_t`` accepts, and those whose group ``group_slab``
    drops with the hit's t as the far limit, or enters beyond the hit."""
    t_rows = packed.shape[0]
    slots = torch.arange(t_rows) // tcl * tcl + rows.long()
    group_of = torch.empty(t_rows, dtype=torch.int64)
    group_of[slots] = torch.arange(t_rows) // (tcl // G)
    cols = [packed[None, :, k] for k in range(9)]
    hits = bad = 0
    for s in range(0, ro.shape[0], chunk):
        o = [torch.from_numpy(np.ascontiguousarray(ro[s:s + chunk, k])) for k in range(3)]
        d = [torch.from_numpy(np.ascontiguousarray(rd[s:s + chunk, k])) for k in range(3)]
        n = o[0].shape[0]
        tmin, tmax = torch.full((n, 1), 1e-3), torch.full((n, 1), 1e16)
        t = mt_hit_t(*[x[:, None] for x in o + d], tmin, tmax, cols)  # (n, T)
        ri, rr = torch.nonzero(t < MAX_DISTANCE, as_tuple=True)
        th = t[ri, rr]
        ok, tn = bt.group_slab(boxes[group_of[rr]], [x[ri] for x in o], [x[ri] for x in d],
                               [bt._safe_inv(x[ri]) for x in d], tmin[ri, 0], th)
        hits += int(ri.numel())
        bad += int((~(ok & (tn <= th))).sum())
    return hits, bad


def _aimed(packed, n, seed, dist, zero_axis=False):
    """Rays aimed at a vertex, an edge point or an inside point of seeded
    live rows from ``dist`` away in a seeded direction; with
    ``zero_axis`` one direction component is exactly 0 (the origin then
    shares the target's coordinate on that axis)."""
    r = np.random.default_rng(seed)
    p = packed.numpy().astype(np.float64)
    live = np.nonzero(_live(p))[0]
    pick = p[r.choice(live, n)]
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
    o = target - d * dist
    if zero_axis:
        o = np.where(d == 0.0, target, o)
    return o.astype(np.float32), d.astype(np.float32)


def _face_rays(packed, rows, tcl, n_groups, seed, tilt=False, out=1.0):
    """Rays in the plane of a face of seeded groups' tight boxes (the
    vertex that makes the face, the direction exactly zero across it),
    aimed at that vertex from 2 and 1.5 times ``out`` units out along the
    other axes;
    with ``tilt`` the direction crosses the plane at a seeded slope of
    1e-7 to 1e-3 (the ray still passes through the vertex), where the
    slab distances of that axis are huge and only the spatial margin
    holds the hit."""
    r = np.random.default_rng(seed)
    p = packed.numpy().astype(np.float64)
    live = _live(p)
    gr = tcl // G
    slots = np.arange(p.shape[0]) // tcl * tcl + rows.numpy().astype(np.int64)
    verts = np.stack([p[:, 0:3], p[:, 0:3] + p[:, 3:6], p[:, 0:3] + p[:, 6:9]], 1)
    verts = verts.astype(np.float32)
    os_, ds = [], []
    for g in r.choice(p.shape[0] // gr, n_groups, replace=False):
        grp = [x for x in slots[g * gr:(g + 1) * gr] if live[x]]
        if not grp:
            continue
        v = verts[grp].reshape(-1, 3)
        for a in range(3):
            for face in (v[:, a].min(), v[:, a].max()):
                vert = v[v[:, a] == face][0]
                o = vert.astype(np.float64)
                o[(a + 1) % 3] += 2.0 * out
                o[(a + 2) % 3] += 1.5 * out
                d = vert - o
                if tilt:
                    d[a] = 2.5 * 10.0 ** r.uniform(-7, -3) * r.choice([-1.0, 1.0])
                    o[a] = vert[a] - d[a]
                os_.append(o)
                ds.append(d)
    o, d = np.stack(os_).astype(np.float32), np.stack(ds).astype(np.float32)
    assert ((d == 0).sum(1) >= 1).all() != tilt
    return o, d


def _extent(packed):
    p = packed.numpy()
    return float(np.abs(p[:, 0:3]).max() + np.abs(p[:, 3:9]).max())


@pytest.mark.parametrize("rays", ["seeded", "far", "zero_direction", "faces", "tilted_faces"])
def test_mesh_env_groups_hold_every_accepted_hit(mesh_env, rays):
    _, data, config = mesh_env
    tr = data.tris
    tcl = config.bvh_tcl
    ext = _extent(tr.packed)
    if rays.endswith("faces"):
        ro, rd = _face_rays(tr.packed, tr.subleaf_rows, tcl, 100, 3, tilt=rays[0] == "t")
    else:
        dist = {"seeded": 0.5 * ext, "far": 1e3 * ext, "zero_direction": 0.5 * ext}[rays]
        ro, rd = _aimed(tr.packed, 384, 7, dist, zero_axis=rays == "zero_direction")
    hits, bad = _unsound(tr.packed, tr.subleaf_rows, tr.subleaf_boxes, tcl, ro, rd)
    assert hits > 250 and bad == 0, (hits, bad)


def near_origin_table():
    """Small triangles (a few 1e-3 across) clustered within 0.02 of the
    origin, and large ones out to 3 units that set the scene's extent, as
    big_env's groups near (0, 0, 0) against its floor; rows sorted along x
    and padded with 8 zero rows to whole 16-row leaves."""
    r = np.random.default_rng(5)
    small = r.uniform(-0.02, 0.02, (503, 1, 3)) + r.normal(0, 2e-3, (503, 3, 3))
    big = r.uniform(-3.0, 3.0, (65, 3, 3))
    v = np.concatenate([small, big]).astype(np.float32)
    v = v[np.argsort(v.mean(1)[:, 0])]
    rows = np.zeros((576, 12), np.float32)
    rows[:568, 0:3] = v[:, 0]
    rows[:568, 3:6] = v[:, 1] - v[:, 0]
    rows[:568, 6:9] = v[:, 2] - v[:, 0]
    return torch.from_numpy(rows)


@pytest.mark.parametrize("rays", ["seeded", "zero_direction", "faces", "tilted_faces"])
def test_groups_near_the_origin_hold_every_accepted_hit(rays):
    packed = near_origin_table()
    rows, boxes = bt.make_baked_subleaf(packed, 16)
    _assert_numpy_table(packed, rows, boxes, 16)
    if rays.endswith("faces"):
        ro, rd = _face_rays(packed, rows, 16, 60, 4, tilt=rays[0] == "t", out=2.5)
    else:
        ro, rd = _aimed(packed, 512, 9, 3.3, zero_axis=rays == "zero_direction")
    hits, bad = _unsound(packed, rows, boxes, 16, ro, rd)
    assert hits > 250 and bad == 0, (hits, bad)


# --- the walk and the wrappers ----------------------------------------------


def _allpass(rows, boxes, tcl):
    order = (torch.arange(rows.shape[0]) % tcl).to(torch.uint8)
    box = torch.tensor([-1e30, -1e30, -1e30, 1e30, 1e30, 1e30, 0.0, 0.0]).expand_as(boxes)
    return order, box.contiguous()


def test_walk_with_groups_equals_the_full_leaf_scan(mesh_env):
    """On seeded rays aimed at vertices, edges and insides of triangles,
    tree_walk with the sub-leaf table gives the (t, row), pops and leaves
    of the walk with the all-pass table (the full leaf scan of every leaf
    it visits), with fewer rows tested. (Against the brute sweep the walk
    differs on one lane either way: its unpadded tree boxes, the
    reference's, drop a leaf whose triangle wins by one ulp of t at a
    shared vertex.)"""
    _, data, config = mesh_env
    tr = data.tris
    ro, rd = _aimed(tr.packed, 1024, 13, 0.5 * _extent(tr.packed))
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (ro, rd)
              for k in range(3)] + [torch.full((1024,), 1e-3), torch.full((1024,), 1e16)]
    tabs = (tr.packed, tr.bvh_child, tr.bvh_axis, tr.bvh_boxes)
    w = bt.tree_walk(*planes, *tabs, tr.subleaf_rows, tr.subleaf_boxes, config.bvh_tcl)
    a = bt.tree_walk(*planes, *tabs, *_allpass(tr.subleaf_rows, tr.subleaf_boxes,
                                               config.bvh_tcl), config.bvh_tcl)
    assert torch.equal(w["t"], a["t"]) and torch.equal(w["idx"], a["idx"])
    assert int((w["idx"] >= 0).sum()) > 900
    for k in ("pops", "leaves"):
        assert torch.equal(w[k], a[k])
    assert torch.equal(a["rows"], a["leaves"] * config.bvh_tcl)
    assert int(w["rows"].sum()) * 3 < int(a["rows"].sum())


def tie_case():
    """chip_smoke.py's bvh_tie_case on the CPU: rows 0 and 9 hold one
    triangle, in different groups; the group of row 9 starts nearer."""
    def tri(x, z):
        return torch.tensor([x, 0.0, z, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])

    packed = torch.zeros((16, 12))
    packed[0, 0:9] = packed[9, 0:9] = tri(0.0, 0.0)
    packed[1, 0:9] = tri(-2.5, -1.0)
    packed[3, 0:9] = tri(2.5, -3.0)
    far = [r for r in range(16) if r not in (0, 1, 3, 9)]
    for k, r in enumerate(far):
        packed[r, 0:9] = tri(-10.0 * (k + 1) if k < 6 else 10.0 * (k - 5), 0.0)
    boxes = torch.zeros((8, 8))
    boxes[:, 0:6] = 1e30
    boxes[0, 0:6] = torch.tensor([-60.0, 0.0, -3.0, 61.0, 1.0, 0.0])
    child = torch.tensor([-1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    rows, sub = bt.make_baked_subleaf(packed, 16)
    return packed, child, torch.zeros(1, dtype=torch.int32), boxes, rows, sub


def test_walk_keeps_the_lower_row_of_a_tie_across_groups():
    tabs = tie_case()
    order = tabs[4].long()
    group = {int(order[j]): j // (16 // G) for j in range(16)}
    assert group[0] != group[9]
    g = torch.linspace(0.05, 0.45, 8)
    gx, gy = [a.reshape(-1).contiguous() for a in torch.meshgrid(g, g, indexing="ij")]
    n = gx.shape[0]
    planes = [gx, gy, torch.full((n,), -5.0), torch.zeros(n), torch.zeros(n), torch.ones(n),
              torch.full((n,), 1e-3), torch.full((n,), 1e16)]
    w = bt.tree_walk(*planes, *tabs, 16)
    assert bool((w["idx"] == 0).all()) and bool((w["t"] == 5.0).all())
    # row 9's group is entered first, then row 0's, which starts before the hit
    assert bool((w["groups"] == 2).all())


def test_wrappers_refuse_a_missing_or_malformed_table(mesh_env):
    _, data, config = mesh_env
    tr = data.tris
    p = [x[:8].contiguous() for x in (tr.packed[:, 0], tr.packed[:, 1], tr.packed[:, 2])] * 2
    p += [torch.full((8,), 1e-3), torch.full((8,), 1e16)]
    tabs = (tr.packed, tr.bvh_child, tr.bvh_axis, tr.bvh_boxes)
    kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
    for fn in (bt.bvh_closest, bt.bvh_anyhit):
        with pytest.raises(TypeError):
            fn(*p, *tabs, **kw)  # the table is a required argument
        for rows, boxes in ((tr.subleaf_rows.to(torch.int32), tr.subleaf_boxes),
                            (tr.subleaf_rows[:-16], tr.subleaf_boxes),
                            (tr.subleaf_rows, tr.subleaf_boxes[:, 0:6].contiguous()),
                            (tr.subleaf_rows, tr.subleaf_boxes.t().contiguous().t()),
                            (torch.zeros(1, dtype=torch.uint8), torch.zeros((1, 8)))):
            with pytest.raises(ValueError, match="subleaf"):
                fn(*p, *tabs, rows, boxes, **kw)
        with pytest.raises(ValueError, match="leaf size"):
            fn(*p, *tabs, tr.subleaf_rows, tr.subleaf_boxes, tcl=48, depth=tr.bvh_depth)
    with pytest.raises(ValueError, match="leaf size"):
        bt.bvh_closest(*[x.to("meta") for x in p], *[x.to("meta") for x in tabs],
                       tr.subleaf_rows.to("meta"), tr.subleaf_boxes.to("meta"), tcl=24,
                       depth=tr.bvh_depth)
