"""Port parity: the device refit (flatten/refit.py) and the World's edit path,
on the CPU.

* Instanced refit (``InstRefitData``: the instanced scene of
  ``pupiloptixlab_tpu_torch.scene.instanced_grid``, 16 instances, envmap
  only, so the refit keeps the instanced tables): after a transform edit and
  after a visibility edit the tables equal the reference's ``refit_scene``
  bit for bit (both run the same numpy on the host), and equal a fresh
  flatten of the edited scene: the object-space tables and instance rows
  bit for bit, and each live world leaf's box (found by its (row start,
  instance) in either tree, as the refit keeps its topology) within 1 ulp.
* Baked refit (``RefitData``) on data/mesh_env.xml: the same two edits give
  the reference's refit tables bit for bit (world rows by per-component
  multiply-adds, normals normalised by ``torch.linalg.vector_norm``, which
  rounds as ``jnp.linalg.norm`` on the CPU). Against a fresh flatten, rows
  are matched by (instance, unique row) since the refit keeps the tree and
  the flatten rebuilds it: every live row's p0/e1/e2 within 2e-6 (the refit
  maps object-space edges through the matrix, the flatten subtracts
  world-space vertices) and normals within 1e-6.
* The port's ``World`` refits on an instance edit and never calls the
  flatten (counted), keeping ``packed`` itself on the instanced path.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.flatten.refit import refit_scene as jax_refit_scene
from pupiloptixlab_tpu.scene import load_scene as jax_load_scene
from pupiloptixlab_tpu.utils.math import Transform as JaxTransform
from pupiloptixlab_tpu_torch.flatten import flatten_scene
from pupiloptixlab_tpu_torch.flatten.refit import refit_scene
from pupiloptixlab_tpu_torch.flatten.types import InstRefitData, RefitData
from pupiloptixlab_tpu_torch.scene import load_scene
from pupiloptixlab_tpu_torch.scene.instanced_grid import write_instanced_scene
from pupiloptixlab_tpu_torch.utils.math import Transform
from pupiloptixlab_tpu_torch.world import world as world_mod

DATA = Path(__file__).resolve().parent.parent / "data"
SKY = DATA / "env" / "sky.exr"
GROUPS = ("tris", "spheres", "emitters")
EDITS = ("transform", "visibility")
MESH_ENV_EDIT = {"transform": 0, "visibility": 1}  # move the Ball, hide the Floor


@pytest.fixture(scope="module")
def inst_xml(tmp_path_factory):
    return write_instanced_scene(tmp_path_factory.mktemp("refit"), SKY, n_inst=16, grid=8,
                                 width=32, height=32, max_depth=3)


def _edit(scene, transform_cls, which, idx):
    ins = scene.shape_instances[idx]
    if which == "transform":
        ins.transform = transform_cls(
            transform_cls().translate(0.4, 0.25, -0.3).matrix @ ins.transform.matrix)
    else:
        ins.visibility_mask = 0


def _assert_tables_equal(port, ref):
    for g in GROUPS:
        for f in dataclasses.fields(getattr(ref, g)):
            want = np.asarray(getattr(getattr(ref, g), f.name))
            got = getattr(getattr(port, g), f.name).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, (g, f.name)
            np.testing.assert_array_equal(got, want, err_msg=f"{g}.{f.name}")


def _refit_both(xml, which, idx):
    """(port refit tables, port records, reference refit tables, edited port scene)."""
    jscene, tscene = jax_load_scene(xml), load_scene(xml)
    jd, _, jr = jax_flatten(jscene, return_refit=True)
    td, _, tr = flatten_scene(tscene, return_refit=True, device="cpu")
    _edit(jscene, JaxTransform, which, idx)
    _edit(tscene, Transform, which, idx)
    return refit_scene(td, tr, tscene), tr, jax_refit_scene(jd, jr, jscene), tscene, td


def _leaf_boxes(tris):
    """{(row start, instance): (lo, hi)} of every world leaf of a tree."""
    child = tris.bvh_child.numpy()
    boxes = tris.bvh_boxes.numpy()
    start, inst = tris.leaf_start.numpy(), tris.leaf_inst.numpy()
    out = {}
    for slot in np.nonzero(child < 0)[0]:
        li = -child[slot] - 1
        out[(int(start[li]), int(inst[li]))] = boxes[slot, 0:6]
    return out


@pytest.mark.parametrize("which", EDITS)
def test_instanced_refit_equals_reference(inst_xml, which):
    got, records, want, _, before = _refit_both(inst_xml, which, 5)
    assert isinstance(records, InstRefitData)
    _assert_tables_equal(got, want)
    assert got.tris.packed is before.tris.packed  # object-space rows stay put
    assert not torch.equal(got.tris.bvh_boxes, before.tris.bvh_boxes)


@pytest.mark.parametrize("which", EDITS)
def test_instanced_refit_equals_a_fresh_flatten(inst_xml, which):
    got, _, _, scene, _ = _refit_both(inst_xml, which, 5)
    fresh, config = flatten_scene(scene, device="cpu")
    assert config.instanced
    for f in ("packed", "attrs", "inst_w2o", "inst_packed"):
        np.testing.assert_array_equal(getattr(got.tris, f).numpy(),
                                      getattr(fresh.tris, f).numpy(), err_msg=f)
    a, b = _leaf_boxes(got.tris), _leaf_boxes(fresh.tris)
    assert a.keys() == b.keys() and len(a) == got.tris.leaf_start.shape[0]
    live = [k for k in a if a[k][0] < 1e30]
    assert len(live) == len(a) - (4 if which == "visibility" else 0)
    np.testing.assert_array_max_ulp(np.stack([a[k] for k in live]),
                                    np.stack([b[k] for k in live]), maxulp=1)
    for k in set(a) - set(live):  # the hidden instance's never-boxes
        assert (b[k] >= 1e30).all()


@pytest.mark.parametrize("which", EDITS)
def test_baked_refit_equals_reference(which):
    got, records, want, _, _ = _refit_both(DATA / "mesh_env.xml", which, MESH_ENV_EDIT[which])
    assert isinstance(records, RefitData) and records.depth > 0
    _assert_tables_equal(got, want)
    # a tree's tables hold the chunk sweep's placeholder, which the refit keeps
    assert tuple(got.tris.sweep_boxes.shape) == (0, 8)


@pytest.mark.parametrize("which", EDITS)
def test_baked_refit_equals_a_fresh_flatten_on_live_rows(which):
    idx = MESH_ENV_EDIT[which]
    got, records, _, scene, _ = _refit_both(DATA / "mesh_env.xml", which, idx)
    fresh, _, frecords = flatten_scene(scene, return_refit=True, device="cpu")

    def by_key(data, rec):
        key = rec.tri_inst.astype(np.int64) * (1 << 32) + rec.u_row
        live = rec.tri_valid & ((rec.tri_inst != idx) | (which == "transform"))
        order = np.argsort(key[live])
        return data.tris.packed.numpy()[live][order], data.tris.attrs.numpy()[live][order]

    (gp, ga), (fp, fa) = by_key(got, records), by_key(fresh, frecords)
    assert gp.shape == fp.shape and gp.shape[0] > 1000
    np.testing.assert_allclose(gp[:, 0:9], fp[:, 0:9], rtol=0, atol=2e-6)
    np.testing.assert_allclose(ga[:, 0:9], fa[:, 0:9], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ga[:, 9:17], fa[:, 9:17])  # uv, material, emitter


@pytest.mark.parametrize("xml", ["instanced", "mesh_env"])
def test_world_refits_and_never_flattens_on_an_edit(inst_xml, xml, monkeypatch):
    calls = []
    real = world_mod.flatten_scene

    def counting(*args, **kwargs):
        calls.append(kwargs.get("return_refit"))
        return real(*args, **kwargs)

    monkeypatch.setattr(world_mod, "flatten_scene", counting)
    w = world_mod.World(device="cpu")
    w.set_scene(load_scene(inst_xml if xml == "instanced" else DATA / "mesh_env.xml"))
    data0, config0 = w.get_scene_data()
    assert calls == [True]
    assert isinstance(w._refit, InstRefitData if xml == "instanced" else RefitData)
    moved, hidden = (3, 5) if xml == "instanced" else (0, 1)
    ros = w.render_objects
    ros[moved].apply_transform(Transform().translate(0.4, 0.25, -0.3))
    ros[hidden].set_visible(False)
    data1, config1 = w.get_scene_data()
    assert calls == [True] and config1 == config0
    assert (data1.tris.packed is data0.tris.packed) == (xml == "instanced")
    assert not torch.equal(data1.tris.bvh_boxes, data0.tris.bvh_boxes)
    want = refit_scene(data0, w._refit, w.scene)
    for f in ("packed", "attrs", "bvh_boxes", "inst_w2o", "inst_packed"):
        assert torch.equal(getattr(data1.tris, f), getattr(want.tris, f)), f
    assert w.get_scene_data()[0] is data1  # nothing dirty: nothing redone
