"""The sub-leaf level of the instanced traversal (K7/K8), on the CPU.

K7/K8 test a world leaf's rows only in the groups of ``tcl / 8`` rows
whose object-space boxes the object ray enters
(``accel/bvh_traverse.py::make_subleaf_boxes``). The kernels run only on
the card, where ``chip_smoke.py`` holds them against the full leaf scan;
here, on the 16-instance scene of tests/test_torch_instanced.py (leaves
of 32 rows, groups of 4):

* the table equals an independent numpy construction from the unique rows
  (padding-only groups hold the never-box), through the flatten and
  through ``scene_from_arrays`` from the reference's arrays, and is kept
  as it is by the instanced refit after a transform and after a
  visibility edit;
* soundness: every (ray, world leaf, row) that ``mt_hit_t`` accepts in
  object space lies in a group whose box the object ray passes under the
  kernels' slab test (``_slab``, with the object direction's own inverse),
  entering it no later than the hit, on seeded rays, rays with exactly
  zero direction components and object-space rays along group-box faces,
  so skipping the other groups never drops a hit.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.scene import load_scene as jax_load_scene
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.accel.sweep import mt_hit_t
from pupiloptixlab_tpu_torch.flatten import flatten_scene
from pupiloptixlab_tpu_torch.flatten.convert import config_from_fields, scene_from_arrays
from pupiloptixlab_tpu_torch.flatten.refit import refit_scene
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.scene.instanced_grid import write_instanced_scene
from pupiloptixlab_tpu_torch.utils.math import Transform

DATA = Path(__file__).resolve().parent.parent / "data"
SKY = DATA / "env" / "sky.exr"
GROUPS = ("tris", "spheres", "curves", "materials", "textures", "emitters")


@pytest.fixture(scope="module")
def xmls(tmp_path_factory):
    """The 16-instance scene with its area light (instanced tables) and
    without (the refit keeps instanced tables only on a non-emissive scene)."""
    root = tmp_path_factory.mktemp("subleaf")
    kw = dict(n_inst=16, grid=8, width=32, height=32, max_depth=3)
    return {"light": write_instanced_scene(root / "light", SKY, area_light=True, **kw),
            "env": write_instanced_scene(root / "env", SKY, **kw)}


@pytest.fixture(scope="module")
def scene(xmls):
    data, config = flatten_scene(load_scene(xmls["light"]), device="cpu")
    assert config.instanced and config.bvh_tcl == 32
    return data, config


def numpy_subleaf(packed: np.ndarray, tcl: int) -> np.ndarray:
    """The sub-leaf table from its definition, row by row in numpy."""
    gr = tcl // 8
    out = np.zeros((packed.shape[0] // gr, 8), np.float32)
    for k in range(out.shape[0]):
        lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
        for row in packed[k * gr:(k + 1) * gr].astype(np.float64):
            p0, e1, e2 = row[0:3], row[3:6], row[6:9]
            if not (e1.any() and e2.any()):
                continue  # det is exactly 0: never hit (the padding rows)
            for v in (p0, p0 + e1, p0 + e2):
                lo, hi = np.minimum(lo, v), np.maximum(hi, v)
        if lo[0] > hi[0]:
            out[k, 0:6] = 1e30
            continue
        pad = bt.SUBLEAF_PAD * max(np.abs(lo).max(), np.abs(hi).max())
        for a in range(3):
            x = np.float32(lo[a] - pad)
            out[k, a] = np.nextafter(x, np.float32(-np.inf)) if x > lo[a] - pad else x
            x = np.float32(hi[a] + pad)
            out[k, 3 + a] = np.nextafter(x, np.float32(np.inf)) if x < hi[a] + pad else x
    return out


def test_table_equals_numpy_construction(scene):
    data, config = scene
    packed = data.tris.packed.numpy()
    want = numpy_subleaf(packed, config.bvh_tcl)
    got = data.tris.subleaf_boxes
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == (packed.shape[0] // config.bvh_tcl * 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rectangle's leaf holds 2 rows and 30 padding rows: 7 never-boxes
    padding = ~np.abs(packed[:, 3:9]).reshape(-1, config.bvh_tcl // 8, 6).any(axis=(1, 2))
    never = (got.numpy()[:, 0:6] == np.float32(1e30)).all(1)
    assert padding.sum() == 7 and np.array_equal(never, padding)
    # every live box is widened: it strictly contains its rows' vertices
    assert (got[~torch.from_numpy(never), 0:3] < got[~torch.from_numpy(never), 3:6]).all()


def test_converted_scene_derives_the_table(xmls, scene):
    data, config = scene
    jd, jc = jax_flatten(jax_load_scene(xmls["light"]))
    tree = {g: {f.name: np.asarray(getattr(getattr(jd, g), f.name))
                for f in dataclasses.fields(getattr(jd, g))} for g in GROUPS}
    conv = scene_from_arrays(tree, config_from_fields(dataclasses.asdict(jc)), device="cpu")
    assert torch.equal(conv.tris.subleaf_boxes, data.tris.subleaf_boxes)


@pytest.mark.parametrize("which", ["transform", "visibility"])
def test_refit_keeps_the_table(xmls, which):
    """The edits of tests/test_torch_refit.py (instance 5 moved, or hidden):
    the refit changes world boxes and matrices, never object-space rows."""
    scene = load_scene(xmls["env"])
    data, config, records = flatten_scene(scene, return_refit=True, device="cpu")
    assert config.instanced
    ins = scene.shape_instances[5]
    if which == "transform":
        ins.transform = Transform(Transform().translate(0.4, 0.25, -0.3).matrix
                                  @ ins.transform.matrix)
    else:
        ins.visibility_mask = 0
    got = refit_scene(data, records, scene)
    assert got.tris.subleaf_boxes is data.tris.subleaf_boxes
    assert not torch.equal(got.tris.bvh_boxes, data.tris.bvh_boxes)
    fresh, _ = flatten_scene(scene, device="cpu")
    assert torch.equal(got.tris.subleaf_boxes, fresh.tris.subleaf_boxes)


def _world_rays(n, seed):
    """Seeded rays (half aimed down at the instances, half random), then
    rays with exactly zero direction components: straight down, along
    +-x and +-z at the bumps' height, and down with zero x or zero z."""
    r = np.random.default_rng(seed)
    h = n // 2
    ro = (r.standard_normal((n, 3)) * 3.0 + [0, 3, 0]).astype(np.float32)
    rd = r.standard_normal((n, 3)).astype(np.float32)
    ro[:h] = np.array([0, 6, 0], np.float32) + r.standard_normal((h, 3)).astype(np.float32) * [3, .5, 3]
    tgt = r.uniform(-3, 3, (h, 3)).astype(np.float32)
    tgt[:, 1] = 0.15
    rd[:h] = tgt - ro[:h]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    m = 256
    g = r.uniform(-5, 5, (m, 2)).astype(np.float32)
    down = np.stack([g[:, 0], np.full(m, 2.0, np.float32), g[:, 1]], 1)
    ox = np.stack([np.full(m, -8.0, np.float32), r.uniform(0.0, 0.3, m).astype(np.float32),
                   g[:, 1]], 1)
    oz = np.stack([g[:, 0], r.uniform(0.0, 0.3, m).astype(np.float32),
                   np.full(m, 8.0, np.float32)], 1)
    slant = r.uniform(-0.5, 0.5, m).astype(np.float32)
    zero = np.zeros(m, np.float32)
    one = np.ones(m, np.float32)
    ro = np.concatenate([ro, down, ox, oz, down, down])
    rd = np.concatenate([rd, np.stack([zero, -one, zero], 1), np.stack([one, zero, zero], 1),
                         np.stack([zero, zero, -one], 1), np.stack([zero, -one, slant], 1),
                         np.stack([slant, -one, zero], 1)])
    return ro, rd


def _object_rays(data, ro, rd):
    """(N, L) object-space planes of every ray under every world leaf's
    instance, as leaf_scan_inst maps them."""
    tr = data.tris
    w = tr.inst_w2o[tr.leaf_inst.long()]
    o = [torch.from_numpy(np.ascontiguousarray(ro[:, k]))[:, None] for k in range(3)]
    d = [torch.from_numpy(np.ascontiguousarray(rd[:, k]))[:, None] for k in range(3)]
    w = [w[None, :, k] for k in range(12)]
    return ([w[0] * o[0] + w[1] * o[1] + w[2] * o[2] + w[3],
             w[4] * o[0] + w[5] * o[1] + w[6] * o[2] + w[7],
             w[8] * o[0] + w[9] * o[1] + w[10] * o[2] + w[11]],
            [w[0] * d[0] + w[1] * d[1] + w[2] * d[2],
             w[4] * d[0] + w[5] * d[1] + w[6] * d[2],
             w[8] * d[0] + w[9] * d[1] + w[10] * d[2]])


def _face_rays(data, config):
    """Object-space rays along a face of each group's tight box: the
    origin on the face plane, 2 and 1.5 units out along the other axes, the
    direction in that plane (exactly zero across it) aimed at the vertex that makes
    the face, so Moller-Trumbore hits an edge or a corner lying in it.
    Returns (leaf, o, d) with o, d as (M, 1) planes for the leaf's rows."""
    packed = data.tris.packed.numpy().astype(np.float64)
    gr = config.bvh_tcl // 8
    leaves, os_, ds = [], [], []
    for row in range(packed.shape[0]):
        p0, e1, e2 = packed[row, 0:3], packed[row, 3:6], packed[row, 6:9]
        if not (e1.any() and e2.any()):
            continue
        grp = slice(row // gr * gr, row // gr * gr + gr)
        v = packed[grp, 0:3][:, None, :] + np.concatenate(
            [np.zeros((gr, 1, 3)), packed[grp, None, 3:6], packed[grp, None, 6:9]], 1)
        live = np.abs(packed[grp, 3:9]).any(1)
        v = v[live].reshape(-1, 3)
        for a in range(3):
            for lohi in (v[:, a].min(), v[:, a].max()):
                for vert in (p0, p0 + e1, p0 + e2):
                    vert = vert.astype(np.float32)
                    if vert[a] != np.float32(lohi):
                        continue
                    o = vert.copy()
                    o[(a + 1) % 3] += 2.0
                    o[(a + 2) % 3] += 1.5
                    leaves.append(row // config.bvh_tcl)
                    os_.append(o)
                    ds.append(vert - o)
    o, d = np.stack(os_).astype(np.float32), np.stack(ds).astype(np.float32)
    assert ((d == 0).sum(1) == 1).all()
    return np.array(leaves), o, d


def _unsound(packed, o, d, rows_of, subleaf, gr):
    """(hits, unsound hits): the (ray, leaf, row) hits that Moller-Trumbore
    accepts, and those among them in a group whose box the object ray
    misses, or enters beyond the hit. ``o``/``d``: (N, L) object planes;
    ``rows_of``: (L,) first row of each leaf's rows."""
    n = o[0].shape[0]
    tmin = torch.full((n, 1, 1), 1e-3)
    tmax = torch.full((n, 1, 1), 1e16)
    ob, db = [x[..., None] for x in o], [x[..., None] for x in d]
    inv = [bt._safe_inv(x) for x in db]
    tcl = 8 * gr
    rows = rows_of[:, None] + torch.arange(tcl)[None, :]  # (L, tcl)
    blk = packed[rows]  # (L, tcl, 12)
    t = mt_hit_t(*ob, *db, tmin, tmax, [blk[None, :, :, k] for k in range(9)])
    hit = t < 1e16  # (N, L, tcl)
    boxes = subleaf[(rows_of // tcl)[:, None] * 8 + torch.arange(8)[None, :]]  # (L, 8, 8)
    ok, tn = bt._slab(boxes.expand(n, -1, -1, -1), ob, db, inv, tmin, tmax)  # (N, L, 8)
    ok = ok.repeat_interleave(gr, dim=2)
    tn = tn.repeat_interleave(gr, dim=2)
    bad = hit & ~(ok & (tn <= t))
    return int(hit.sum()), int(bad.sum())


def test_group_boxes_hold_every_accepted_hit(scene):
    data, config = scene
    gr = config.bvh_tcl // 8
    ro, rd = _world_rays(2048, 11)
    o, d = _object_rays(data, ro, rd)
    zero_dir = [(x == 0.0) for x in d]
    starts = data.tris.leaf_start.long()
    hits, bad = _unsound(data.tris.packed, o, d, starts, data.tris.subleaf_boxes, gr)
    assert hits > 1000 and bad == 0, (hits, bad)
    # the zero-direction rays reach object space with zero components too
    assert bool((zero_dir[0] | zero_dir[2])[2048:].any())
    leaves, fo, fd = _face_rays(data, config)
    o = [torch.from_numpy(np.ascontiguousarray(fo[:, k]))[:, None] for k in range(3)]
    d = [torch.from_numpy(np.ascontiguousarray(fd[:, k]))[:, None] for k in range(3)]
    for leaf in np.unique(leaves):
        sel = torch.from_numpy(np.nonzero(leaves == leaf)[0])
        start = torch.tensor([leaf * config.bvh_tcl])
        h, b = _unsound(data.tris.packed, [x[sel] for x in o], [x[sel] for x in d], start,
                        data.tris.subleaf_boxes, gr)
        assert h >= 1 and b == 0, (leaf, h, b)
