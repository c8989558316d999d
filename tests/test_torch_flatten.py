"""Port parity: the scene layer, every flattened table, the BVH build and
dtype mapping.

The port loads scenes with its own copy of the host scene layer
(``pupiloptixlab_tpu_torch.scene``); the loaded ``Scene`` must equal the
reference's field by field, and the port's flatten of it must reproduce the
JAX flatten's arrays exactly: value, shape and dtype (the reference narrows
float64/int64 to 32 bits through jnp.asarray; the port maps dtypes
explicitly). ``PUPIL_NO_BVH`` gives both packages the same BVH-less tables,
and the entry points run on the card unless the caller names the CPU.
"""

import copy
import dataclasses
import enum
from pathlib import Path

import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.bvh import build_bvh as jax_build_bvh
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.accel.bvh import build_bvh, bvh_depth, pick_leaf_size
from pupiloptixlab_tpu_torch.accel.bvh_traverse import sweep_boxes
from pupiloptixlab_tpu_torch.flatten import camera_block, camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.flatten.convert import config_from_fields, scene_from_arrays
from pupiloptixlab_tpu_torch.flatten.flatten import _t
from pupiloptixlab_tpu_torch.scene import load_scene as port_load_scene

DATA = Path(__file__).resolve().parent.parent / "data"
GROUPS = ("tris", "spheres", "curves", "materials", "textures", "emitters")
_cache = {}


SCENES = ("mesh_env.xml", "oracle_mat.xml", "dispersion.xml", "meshlight_env.xml")


def _both(name):
    """(reference flatten of the reference's Scene, port flatten of the
    port's own Scene)."""
    if name not in _cache:
        _cache[name] = (jax_flatten(load_scene(DATA / name)),
                        flatten_scene(port_load_scene(DATA / name), device="cpu"))
    return _cache[name]


def _assert_same(a, b, path):
    """Deep equality of two loaded scenes: the same class names, fields,
    enum members, numbers and arrays all the way down."""
    assert type(a).__name__ == type(b).__name__, f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, enum.Enum):
        assert (a.name, a.value) == (b.name, b.value), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__"):
        assert vars(a).keys() == vars(b).keys(), path
        for k in vars(a):
            _assert_same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


@pytest.mark.parametrize("name", SCENES)
def test_scene_equal_reference(name):
    """The port's load_scene against the reference's, field by field."""
    want, got = load_scene(DATA / name), port_load_scene(DATA / name)
    assert type(got).__module__.startswith("pupiloptixlab_tpu_torch.")
    _assert_same(want, got, "scene")
    if name == "dispersion.xml":  # the Abbe number goes through the port's copy
        disp = [s.material.dispersion for s in got.shape_instances
                if getattr(s.material, "dispersion", 0.0)]
        assert disp and all(d > 0.0 for d in disp)


def _fields():
    out = []
    for name in SCENES:
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


@pytest.mark.parametrize("name", SCENES)
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
    conv = scene_from_arrays(tree, config_from_fields(dataclasses.asdict(jc)),
                             device="cpu")
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
    t = _t(arr, device="cpu")
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
    """A scene the reference flattens into instanced tables (mesh_env with
    its 20,480-triangle ball twice) no longer raises: both packages flatten
    it into the same instanced tables (unique object-space rows, leaf
    tables, per-instance matrices), and ``allow_instanced=False`` still
    gives the baked world tables."""
    scene = load_scene(DATA / "mesh_env.xml")
    ball = next(i for i in scene.shape_instances if i.name == "Ball")
    twin = copy.copy(ball)
    twin.name = "Ball2"
    scene.shape_instances.append(twin)
    td, tc = flatten_scene(scene, device="cpu")
    jd, jc = jax_flatten(scene)
    assert tc.instanced and dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for f in dataclasses.fields(jd.tris):
        np.testing.assert_array_equal(getattr(td.tris, f.name).numpy(),
                                      np.asarray(getattr(jd.tris, f.name)), err_msg=f.name)
    assert tuple(td.tris.inst_w2o.shape) == (3, 12)
    td, tc = flatten_scene(scene, allow_instanced=False, device="cpu")
    jd, jc = jax_flatten(scene, allow_instanced=False)
    assert not tc.instanced and tc.tri_count == jc.tri_count
    np.testing.assert_array_equal(td.tris.packed.numpy(), np.asarray(jd.tris.packed))


def test_pupil_no_bvh_gives_both_packages_the_sweep_tables(monkeypatch):
    """With PUPIL_NO_BVH set, mesh_env flattens without a BVH in both
    packages: 20,544 Morton-ordered rows in 321 chunks, equal tables."""
    monkeypatch.setenv("PUPIL_NO_BVH", "1")
    jd, jc = jax_flatten(load_scene(DATA / "mesh_env.xml"))
    td, tc = flatten_scene(port_load_scene(DATA / "mesh_env.xml"), device="cpu")
    assert jc.bvh_nodes == 0 and tc.bvh_nodes == 0 and tc.bvh_tcl == 0
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tuple(td.tris.packed.shape) == (20544, 12)
    assert tuple(td.tris.chunk_boxes.shape) == (321, 8)
    for f in ("packed", "chunk_boxes", "attrs", "mat_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(td.tris, f).numpy(),
                                      np.asarray(getattr(jd.tris, f)), err_msg=f)
    # the culled sweep's padded boxes (321 chunks, 11 super-boxes) are built once, here
    assert tuple(td.tris.sweep_boxes.shape) == (332, 8)
    assert torch.equal(td.tris.sweep_boxes, sweep_boxes(td.tris.packed))
    monkeypatch.delenv("PUPIL_NO_BVH")
    assert flatten_scene(port_load_scene(DATA / "mesh_env.xml"), device="cpu")[1].bvh_nodes == 316


def test_entry_points_default_to_the_card():
    """With no ``device`` the flatten and the camera block go to the CUDA
    device and raise where there is none; they never return CPU tables."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    scene = port_load_scene(DATA / "oracle_mat.xml")
    tree = {g: {} for g in GROUPS}
    for call in (
        lambda: flatten_scene(scene),
        lambda: camera_block_from_scene(scene),
        lambda: camera_block(None),
        lambda: scene_from_arrays(tree, None),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    data, _ = flatten_scene(scene, device="cpu")
    assert data.tris.packed.device.type == "cpu"


def test_native_library_builds_inside_the_port():
    """The port's C++ host runtime is built from its own source copy into its
    own build directory, and parses an OBJ to the reference's arrays."""
    from pupiloptixlab_tpu import native as ref_native
    from pupiloptixlab_tpu_torch import native

    pkg = Path(native.__file__).resolve().parent
    assert native._SRC_PATH == pkg / "csrc" / "pupil_native.cpp" and native._SRC_PATH.exists()
    assert native._LIB_PATH.parent == pkg / "_build"
    repo_native = Path(ref_native.__file__).resolve().parent.parent / "native"
    assert native._SRC_PATH.read_text() == (repo_native / "pupil_native.cpp").read_text()
    if not (native.available() and ref_native.available()):
        pytest.skip("no C++ toolchain: both packages use their numpy fallbacks")
    assert native._LIB_PATH.exists()
    got = native.parse_obj_native(DATA / "meshes" / "icosphere.obj")
    want = ref_native.parse_obj_native(DATA / "meshes" / "icosphere.obj")
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
