"""Port parity: shading modules on random inputs, on the CPU.

geometry, texture, bsdf (all seven types) and emitter (area, sphere,
point and directional emitters, the constant env, envmap importance
sampling) against the JAX package's functions, called eagerly on the same
numpy inputs made from a seed and on the same tables.

Tolerance: allclose rtol 1e-5 / atol 1e-6. Both sides round every float
op on its own; transcendentals (sin, cos, acos, atan2, exp, pow) of the
two libraries may differ in the last ulp, and a GGX or Fresnel term
amplifies that by a few ulps. A rare lane near a branch point (grazing
refraction, a sqrt of a value near 0) amplifies it further: at most
OUTLIERS lanes of 4,096 per output may miss the tolerance, and those must
still agree to rtol 1e-3 / atol 1e-4; the tests print how many there were.
Integer and boolean outputs (ids, lobes, masks) must be equal.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.intersect import Hit as JHit
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.render import bsdf as jbsdf
from pupiloptixlab_tpu.render import emitter as jem
from pupiloptixlab_tpu.render import geometry as jgeo
from pupiloptixlab_tpu.render import texture as jtex
from pupiloptixlab_tpu.render.vec import Vec2 as JVec2
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.accel.intersect import Hit as THit
from pupiloptixlab_tpu_torch.flatten import flatten_scene
from pupiloptixlab_tpu_torch.flatten.types import MAT_TYPE
from pupiloptixlab_tpu_torch.render import bsdf as tbsdf
from pupiloptixlab_tpu_torch.render import emitter as tem
from pupiloptixlab_tpu_torch.render import geometry as tgeo
from pupiloptixlab_tpu_torch.render import texture as ttex
from pupiloptixlab_tpu_torch.render.vec import Vec2 as TVec2
from pupiloptixlab_tpu_torch.render.vec import Vec3 as TVec3

DATA = Path(__file__).resolve().parent.parent / "data"
RTOL, ATOL = 1e-5, 1e-6
OUTLIERS = 8
N = 4096

# Every emitter kind and texture kind the port shades: a sphere emitter,
# a textured rectangle light, point and directional lights, the constant
# env, checkerboard and bitmap textures (point and bilinear, each address
# mode), and round curves.
LIGHTS_XML = """<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective"><float name="fov" value="50"/>
    <transform name="to_world"><lookat origin="0, 2, 5" target="0, 0.5, 0" up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="32"/><integer name="height" value="32"/></film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="0.1, 0.12, 0.15"/></emitter>
  <emitter type="point"><point name="position" x="1" y="3" z="0.5"/>
    <rgb name="intensity" value="4, 4, 4"/></emitter>
  <emitter type="directional"><vector name="direction" x="0.3" y="-1" z="0.2"/>
    <rgb name="irradiance" value="1.5, 1.4, 1.2"/></emitter>
  <shape type="rectangle" id="Floor">
    <bsdf type="diffuse"><texture type="checkerboard" name="reflectance">
      <rgb name="color0" value="0.8, 0.7, 0.6"/><rgb name="color1" value="0.1, 0.2, 0.3"/>
      <transform name="to_uv"><scale value="6"/></transform>
    </texture></bsdf>
    <transform name="to_world"><scale value="6"/><rotate x="1" angle="-90"/></transform>
  </shape>
  <shape type="rectangle" id="Wall">
    <bsdf type="plastic"><texture type="bitmap" name="diffuse_reflectance">
      <string name="filename" value="{sky}"/><string name="filter_type" value="bilinear"/>
      <string name="wrap_mode" value="mirror"/>
    </texture></bsdf>
    <transform name="to_world"><scale value="3"/><translate value="0, 1, -3"/></transform>
  </shape>
  <shape type="sphere" id="Ball">
    <bsdf type="roughplastic"><float name="alpha" value="0.2"/>
      <texture type="bitmap" name="diffuse_reflectance">
        <string name="filename" value="{sky}"/><string name="wrap_mode" value="clamp"/>
      </texture></bsdf>
    <transform name="to_world"><scale value="0.6"/><translate value="-1.2, 0.6, 0"/></transform>
  </shape>
  <shape type="sphere" id="Bulb">
    <emitter type="area"><rgb name="radiance" value="6, 5, 4"/></emitter>
    <transform name="to_world"><scale value="0.2"/><translate value="1.4, 1.6, 0.4"/></transform>
  </shape>
  <shape type="rectangle" id="Panel">
    <emitter type="area"><texture type="checkerboard" name="radiance">
      <rgb name="color0" value="3, 3, 3"/><rgb name="color1" value="1, 1, 1"/>
    </texture></emitter>
    <transform name="to_world"><scale value="0.5"/><rotate x="1" angle="90"/><translate value="0, 3, 0"/></transform>
  </shape>
  <shape type="linearcurve">
    <string name="points" value="-1,0.5,1,0.1; 0,0.8,1,0.08; 1,0.5,1,0.1"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.7, 0.3, 0.2"/></bsdf>
  </shape>
</scene>"""

_cache = {}


def _scene(name, tmp_path_factory=None):
    if name not in _cache:
        if name == "lights":
            p = tmp_path_factory.mktemp("lights") / "lights.xml"
            p.write_text(LIGHTS_XML.format(sky=DATA / "env" / "sky.exr"))
        else:
            p = DATA / name
        scene = load_scene(p)
        _cache[name] = (jax_flatten(scene), flatten_scene(scene, device="cpu"))
    return _cache[name]


@pytest.fixture(scope="module", params=["oracle_mat.xml", "mesh_env.xml", "lights"])
def scenes(request, tmp_path_factory):
    return _scene(request.param, tmp_path_factory)


def _np(x):
    """Flatten a result (Vec3/Vec2, dataclass, tuple, tensor, array) into
    a dict of numpy arrays keyed by path."""
    out = {}

    def walk(v, key):
        if isinstance(v, torch.Tensor):
            out[key] = v.numpy()
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name), f"{key}.{f.name}")
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            for f in v._fields:
                walk(getattr(v, f), f"{key}.{f}")
        elif isinstance(v, (tuple, list)):
            for i, e in enumerate(v):
                walk(e, f"{key}[{i}]")
        else:
            out[key] = np.asarray(v)

    walk(x, "")
    return out


def _assert_match(got, want):
    g, w = _np(got), _np(want)
    assert g.keys() == w.keys(), (sorted(g), sorted(w))
    for k in w:
        a, b = np.broadcast_to(g[k], np.broadcast_shapes(g[k].shape, w[k].shape)), w[k]
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        off = ~np.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        if off.any():
            print(f"{k}: {int(off.sum())} lanes outside rtol 1e-5 / atol 1e-6")
        assert off.sum() <= OUTLIERS, f"{k}: {int(off.sum())} lanes off"
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=k)


def _both(arrs):
    """numpy arrays -> (jax list, torch list), each side on its own copy."""
    return ([jnp.array(a, copy=True) for a in arrs],
            [torch.from_numpy(np.array(a, copy=True)) for a in arrs])


def _unit(r, n):
    v = r.standard_normal((3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def test_lights_scene_covers_every_kind(tmp_path_factory):
    _, (td, tc) = _scene("lights", tmp_path_factory)
    assert tc.has_sphere_emitter and tc.has_point_emitter and tc.has_directional_emitter
    assert tc.emitter_count >= 4 and tc.has_env and tc.env_size == (0, 0)
    assert tc.curve_count > 0 and tc.sphere_count == 2
    assert set(tc.tex_kinds) == {0, 1, 2} and set(tc.mat_tex_filters) == {0, 1}
    assert 1 in tc.em_tex_kinds


def test_texture_sampling(scenes):
    (jd, jc), (td, tc) = scenes
    r = np.random.default_rng(1)
    n_tex = td.textures.packed.shape[0]
    ids = r.integers(0, n_tex, N).astype(np.int32)
    uv = (r.random((2, N), dtype=np.float32) * 5.0 - 2.0)
    uv[:, :64] = np.linspace(0, 1, 64, dtype=np.float32)  # texel edges and centres
    (jid, ju, jv), (tid, tu, tv) = _both([ids, uv[0], uv[1]])
    kinds, filters = (0, 1, 2), (0, 1)
    want = jtex.sample_texture(jd.textures, jid, JVec2(ju, jv), kinds, filters)
    got = ttex.sample_texture(td.textures, tid, TVec2(tu, tv), kinds, filters)
    _assert_match(got, want)


def _bsdf_inputs(td, tc, seed):
    r = np.random.default_rng(seed)
    mat = r.integers(0, td.materials.packed.shape[0], N).astype(np.int32)
    uv = r.random((2, N), dtype=np.float32) * 3.0 - 1.0
    wo, wi = _unit(r, N), _unit(r, N)
    wo[2, : N // 2] = np.abs(wo[2, : N // 2])  # most lanes above the surface
    u = r.random((3, N), dtype=np.float32)
    return mat, uv, wo, wi, u


def test_bsdf_local_eval_sample(scenes):
    (jd, jc), (td, tc) = scenes
    mat, uv, wo, wi, u = _bsdf_inputs(td, tc, 2)
    (jm, ju, jv, *jrest), (tm, tu, tv, *trest) = _both([mat, uv[0], uv[1], *wo, *wi, *u])
    jwo, jwi, ju3 = JVec3(*jrest[0:3]), JVec3(*jrest[3:6]), jrest[6:9]
    twi_o, twi, tu3 = TVec3(*trest[0:3]), TVec3(*trest[3:6]), trest[6:9]
    args = (jc.mat_types, jc.mat_tex_kinds, jc.mat_tex_filters)
    jl = jbsdf.get_local_bsdf(jd.materials, jd.textures, jm, JVec2(ju, jv), *args)
    tl = tbsdf.get_local_bsdf(td.materials, td.textures, tm, TVec2(tu, tv), *args)
    _assert_match(tl, jl)
    _assert_match(tbsdf.albedo(tl), jbsdf.albedo(jl))
    _assert_match(tbsdf.evaluate(tl, twi_o, twi, tc.mat_types),
                  jbsdf.evaluate(jl, jwo, jwi, jc.mat_types))
    _assert_match(tbsdf.sample(tl, twi_o, *tu3, tc.mat_types),
                  jbsdf.sample(jl, jwo, *ju3, jc.mat_types))


@pytest.mark.parametrize("mtype", range(1, 8))
def test_each_bsdf_type(mtype):
    """Each of the seven BSDFs alone (the single-type dispatch), on the
    oracle_mat material that has it."""
    (jd, jc), (td, tc) = _scene("oracle_mat.xml")
    types = td.materials.packed[:, MAT_TYPE].numpy().astype(int)
    assert mtype in types
    _, uv, wo, wi, u = _bsdf_inputs(td, tc, 10 + mtype)
    mat = np.full(N, int(np.nonzero(types == mtype)[0][0]), np.int32)
    (jm, ju, jv, *jrest), (tm, tu, tv, *trest) = _both([mat, uv[0], uv[1], *wo, *wi, *u])
    only = (mtype,)
    jl = jbsdf.get_local_bsdf(jd.materials, jd.textures, jm, JVec2(ju, jv), only)
    tl = tbsdf.get_local_bsdf(td.materials, td.textures, tm, TVec2(tu, tv), only)
    _assert_match(tl, jl)
    _assert_match(tbsdf.evaluate(tl, TVec3(*trest[0:3]), TVec3(*trest[3:6]), only),
                  jbsdf.evaluate(jl, JVec3(*jrest[0:3]), JVec3(*jrest[3:6]), only))
    _assert_match(tbsdf.sample(tl, TVec3(*trest[0:3]), *trest[6:9], only),
                  jbsdf.sample(jl, JVec3(*jrest[0:3]), *jrest[6:9], only))


def test_local_geometry(scenes):
    """Random hits on every primitive kind the scene has (and misses)."""
    (jd, jc), (td, tc) = scenes
    r = np.random.default_rng(3)
    kinds = [k for k, c in ((0, tc.tri_count), (1, tc.sphere_count), (2, tc.curve_count)) if c]
    kind = np.asarray(kinds + [-1], np.int32)[r.integers(0, len(kinds) + 1, N)]
    counts = {0: td.tris.attrs.shape[0], 1: max(tc.sphere_count, 1), 2: max(tc.curve_count, 1)}
    prim = np.zeros(N, np.int32)
    for k in kinds:
        sel = kind == k
        prim[sel] = r.integers(0, counts[k], sel.sum())
    t = (r.random(N, dtype=np.float32) * 5.0 + 0.1).astype(np.float32)
    ro = (r.standard_normal((3, N)) * 2.0).astype(np.float32)
    rd = _unit(r, N)
    inst = np.zeros(N, np.int32)
    (jt, jp, jk, ji, *jv), (tt, tp, tk, ti, *tv) = _both([t, prim, kind, inst, *ro, *rd])
    want = jgeo.get_local_geometry(jd, JHit(jt, jp, jk, ji), JVec3(*jv[0:3]), JVec3(*jv[3:6]),
                                   jc.sphere_count, False, jc.curve_count)
    got = tgeo.get_local_geometry(td, THit(tt, tp, tk, ti), TVec3(*tv[0:3]), TVec3(*tv[3:6]),
                                  tc.sphere_count, False, tc.curve_count)
    _assert_match(got, want)


def test_emitters(scenes):
    """select_emitter, sample_direct (area, sphere, point, directional,
    constant env, envmap importance sampling), eval_hit_emitter, eval_env."""
    (jd, jc), (td, tc) = scenes
    r = np.random.default_rng(4)
    u = r.random((3, N), dtype=np.float32)
    pos = (r.standard_normal((3, N)) * 1.5).astype(np.float32)
    pos[1] = np.abs(pos[1])
    nrm = _unit(r, N)
    nrm[1] = np.abs(nrm[1]) + 0.1
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    (ju, *jv), (tu, *tv) = _both([u, *pos, *nrm])
    jpos, jnrm = JVec3(*jv[0:3]), JVec3(*jv[3:6])
    tpos, tnrm = TVec3(*tv[0:3]), TVec3(*tv[3:6])

    jidx, jenv = jem.select_emitter(jd.emitters, jc, ju[0])
    tidx, tenv = tem.select_emitter(td.emitters, tc, tu[0])
    _assert_match((tidx, tenv), (jidx, jenv))
    if tc.emitter_count > 1:
        assert len(np.unique(tidx.numpy())) == tc.emitter_count
    if tc.has_env and tc.emitter_count:
        assert tenv.any() and not tenv.all()

    want = jem.sample_direct(jd.emitters, jd.textures, jc, jidx, jenv, jpos, jnrm, ju[1], ju[2])
    got = tem.sample_direct(td.emitters, td.textures, tc, tidx, tenv, tpos, tnrm, tu[1], tu[2])
    _assert_match(got, want)

    eid = np.where(r.random(N) < 0.8, r.integers(0, max(tc.emitter_count, 1), N), -1)
    eid = eid.astype(np.int32)
    uv = r.random((2, N), dtype=np.float32)
    spos = (r.standard_normal((3, N)) * 2.0).astype(np.float32)
    (je, *jw), (te, *tw) = _both([eid, *uv, *spos])
    _assert_match(
        tem.eval_hit_emitter(td.emitters, td.textures, tc, te, tpos, tnrm, TVec2(*tw[0:2]),
                             TVec3(*tw[2:5])),
        jem.eval_hit_emitter(jd.emitters, jd.textures, jc, je, jpos, jnrm, JVec2(*jw[0:2]),
                             JVec3(*jw[2:5])),
    )
    _assert_match(tem.eval_env(td.emitters, td.textures, tc, tnrm),
                  jem.eval_env(jd.emitters, jd.textures, jc, jnrm))


def test_envmap_sampling_covers_the_map():
    """mesh_env's envmap importance sampling: directions from sample_direct
    evaluate (eval_env) to the radiance and pdf they were sampled with, on
    texel centres, in both packages."""
    (jd, jc), (td, tc) = _scene("mesh_env.xml")
    assert tc.has_env and tc.env_size == (128, 64) and tc.emitter_count == 0
    r = np.random.default_rng(5)
    u = r.random((2, N), dtype=np.float32)
    pos = np.zeros((3, N), np.float32)
    nrm = np.zeros((3, N), np.float32)
    nrm[1] = 1.0
    (ju1, ju2, *jv), (tu1, tu2, *tv) = _both([u[0], u[1], *pos, *nrm])
    idx = torch.zeros(N, dtype=torch.int32)
    use_env = torch.ones(N, dtype=torch.bool)
    got = tem.sample_direct(td.emitters, td.textures, tc, idx, use_env, TVec3(*tv[0:3]),
                            TVec3(*tv[3:6]), tu1, tu2)
    want = jem.sample_direct(jd.emitters, jd.textures, jc, jnp.asarray(idx.numpy()),
                             jnp.asarray(use_env.numpy()), JVec3(*jv[0:3]), JVec3(*jv[3:6]),
                             ju1, ju2)
    _assert_match(got, want)
    assert (got.pdf > 0).float().mean() > 0.99


def test_first_hit_emission(scenes):
    """_first_hit_emission through the column-selected gathers (the emitter
    record's radiance-texture column, the texture columns its kinds read)
    against the reference's whole-row gathers."""
    from types import SimpleNamespace

    from pupiloptixlab_tpu.render import integrator as jint
    from pupiloptixlab_tpu_torch.render import integrator as tint

    (jd, jc), (td, tc) = scenes
    r = np.random.default_rng(6)
    eid = np.where(r.random(N) < 0.7, r.integers(0, max(tc.emitter_count, 1), N), -1)
    uv = r.random((2, N), dtype=np.float32) * 3.0 - 1.0
    (je, *jw), (te, *tw) = _both([eid.astype(np.int32), *uv])
    _assert_match(
        tint._first_hit_emission(td, tc, SimpleNamespace(emitter_id=te, uv=TVec2(*tw))),
        jint._first_hit_emission(jd, jc, SimpleNamespace(emitter_id=je, uv=JVec2(*jw))),
    )


@pytest.mark.parametrize("kinds,filters", [((0,), (0,)), ((1,), (0, 1)), ((2,), (1,)),
                                           ((0, 1, 2), (0, 1)), ((0, 2), (0,))])
def test_texture_cols_hold_what_sampling_reads(kinds, filters, tmp_path_factory):
    """sample_texture_cols on gather_texture's columns equals it on whole
    texture records, for every kind and filter set, bit for bit (the lights
    scene holds every texture kind and both filters)."""
    _, (td, _) = _scene("lights", tmp_path_factory)
    tex = td.textures
    r = np.random.default_rng(len(kinds) + 3 * len(filters))
    ids = torch.from_numpy(r.integers(0, tex.packed.shape[0], N).astype(np.int32))
    uv = TVec2(*torch.from_numpy(r.random((2, N), dtype=np.float32) * 4.0 - 1.5))
    full = ttex.gather_cols(tex.packed, ids)
    fields = ttex.gather_texture(tex, ids, kinds, filters)
    assert len(fields.planes) == len(ttex.texture_cols(kinds, filters, tex.pool_bi.shape[0] > 1))
    _assert_match(ttex.sample_texture_cols(fields, tex.pool, uv, kinds, filters, tex.pool_bi),
                  ttex.sample_texture_cols(full, tex.pool, uv, kinds, filters, tex.pool_bi))
