"""Port parity: every flattened table, the BVH builder and dtype mapping.

The port's flatten must reproduce the JAX flatten's arrays exactly —
value, shape and dtype (the reference narrows float64/int64 to 32 bits
through jnp.asarray; the port maps dtypes explicitly).
"""

import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.bvh import build_bvh as jax_build_bvh
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.accel.bvh import build_bvh, bvh_depth, pick_leaf_size
from pupiloptixlab_tpu_torch.flatten import flatten_scene
from pupiloptixlab_tpu_torch.flatten.convert import config_from_fields, scene_from_arrays
from pupiloptixlab_tpu_torch.flatten.flatten import _t

DATA = Path(__file__).resolve().parent.parent / "data"
GROUPS = ("tris", "spheres", "curves", "materials", "textures", "emitters")
_cache = {}


def _both(name):
    if name not in _cache:
        scene = load_scene(DATA / name)
        _cache[name] = (jax_flatten(scene), flatten_scene(scene))
    return _cache[name]


def _fields():
    out = []
    for name in ("mesh_env.xml", "oracle_mat.xml", "dispersion.xml"):
        for g in GROUPS:
            out.append((name, g))
    return out


@pytest.mark.parametrize("name,group", _fields())
def test_tables_equal_reference(name, group):
    (jd, _), (td, _) = _both(name)
    jg, tg = getattr(jd, group), getattr(td, group)
    for f in dataclasses.fields(jg):
        a = np.asarray(getattr(jg, f.name))
        b = getattr(tg, f.name)
        assert isinstance(b, torch.Tensor), f.name
        assert b.numpy().dtype == a.dtype, (f.name, b.dtype, a.dtype)
        assert tuple(b.shape) == a.shape, (f.name, tuple(b.shape), a.shape)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=f"{group}.{f.name}")


@pytest.mark.parametrize("name", ["mesh_env.xml", "oracle_mat.xml", "dispersion.xml"])
def test_config_equal_reference(name):
    (_, jc), (td, tc) = _both(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert config_from_fields(dataclasses.asdict(jc)) == tc
    if tc.bvh_nodes:
        assert td.tris.bvh_depth == bvh_depth(td.tris.bvh_child.numpy()) > 0


def test_mesh_env_shapes():
    """The slice's scene at its recorded sizes."""
    _, (td, tc) = _both("mesh_env.xml")
    assert (tc.bvh_nodes, tc.bvh_tcl, tc.instanced, tc.emitter_count) == (316, 16, False, 0)
    assert tc.has_env and tc.env_size == (128, 64)
    assert tuple(td.tris.packed.shape) == (20544, 12)
    assert tuple(td.tris.attrs.shape) == (20544, 26)
    assert tuple(td.emitters.env_row_cdf.shape) == (65,)
    assert tuple(td.emitters.env_col_cdf.shape) == (64, 129)
    assert tuple(td.textures.pool.shape) == (8192, 3)
    assert tuple(td.textures.pool_bi.shape) == (8385, 12)
    assert 7 * td.tris.bvh_depth + 1 <= 64


@pytest.mark.parametrize("name", ["mesh_env.xml", "oracle_mat.xml"])
def test_convert_round_trip(name):
    (jd, jc), (td, _) = _both(name)
    tree = {g: {f.name: np.asarray(getattr(getattr(jd, g), f.name))
                for f in dataclasses.fields(getattr(jd, g))} for g in GROUPS}
    conv = scene_from_arrays(tree, config_from_fields(dataclasses.asdict(jc)))
    assert conv.tris.bvh_depth == td.tris.bvh_depth
    for g in GROUPS:
        for f in dataclasses.fields(getattr(td, g)):
            a, b = getattr(getattr(conv, g), f.name), getattr(getattr(td, g), f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), (g, f.name)


@pytest.mark.parametrize("arr,dtype", [
    (np.zeros(3, np.float64), torch.float32),
    (np.zeros((2, 2), np.int64), torch.int32),
    (np.zeros(3, np.float32), torch.float32),
    (np.array(5, np.int64), torch.int32),
    (np.array([True, False]), torch.bool),
    (2.5, torch.float32),
])
def test_dtype_mapping(arr, dtype):
    t = _t(arr)
    assert t.dtype == dtype
    assert tuple(t.shape) == np.shape(arr)


def _soup(r, t, tcl):
    t_pad = ((t + tcl - 1) // tcl) * tcl
    p0 = np.zeros((t_pad, 3), np.float32)
    p1, p2 = np.zeros_like(p0), np.zeros_like(p0)
    p0[:t] = r.random((t, 3), dtype=np.float32) * 4 - 2
    p1[:t] = p0[:t] + (r.random((t, 3), dtype=np.float32) - 0.5) * 0.4
    p2[:t] = p0[:t] + (r.random((t, 3), dtype=np.float32) - 0.5) * 0.4
    return p0, p1, p2


@pytest.mark.parametrize("t_tris,tcl", [(900, 16), (3000, 16), (2100, 32)])
@pytest.mark.parametrize("native", [False, True])
def test_build_bvh_equals_reference(t_tris, tcl, native):
    r = np.random.default_rng(t_tris + tcl)
    p0, p1, p2 = _soup(r, t_tris, tcl)
    want = jax_build_bvh(p0, p1, p2, t_tris, tcl, allow_native=native)
    got = build_bvh(p0, p1, p2, t_tris, tcl, allow_native=native)
    for k in ("order", "child", "axis", "boxes"):
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert (got.tcl, got.n_nodes) == (want.tcl, want.n_nodes)


def test_pick_leaf_size_matches_reference():
    from pupiloptixlab_tpu.accel.bvh import pick_leaf_size as ref

    for t_pad in (2048, 20544, 4 * 1024 * 1024):
        for m in (16, 32):
            assert pick_leaf_size(t_pad, m) == ref(t_pad, m)


def test_instanced_scene_raises():
    """A scene the reference would flatten into instanced tables is
    refused (instancing is not ported) unless the baked path is asked for."""
    scene = load_scene(DATA / "mesh_env.xml")
    ball = next(i for i in scene.shape_instances if i.name == "Ball")
    twin = copy.copy(ball)
    twin.name = "Ball2"
    scene.shape_instances.append(twin)
    with pytest.raises(NotImplementedError, match="A.8"):
        flatten_scene(scene)
    td, tc = flatten_scene(scene, allow_instanced=False)
    jd, jc = jax_flatten(scene, allow_instanced=False)
    assert not tc.instanced and tc.tri_count == jc.tri_count
    np.testing.assert_array_equal(td.tris.packed.numpy(), np.asarray(jd.tris.packed))
