"""Port parity: spectral transport (render/spectral.py and the frame's
spectral branches) and the value sanitizer (utils/debug.py).

* The calibrated constants (the RGB lift's basis matrices, the sensor's
  scales, the wavelength pdf's normalisation) equal the reference's bit for
  bit: both run the same float64 quadrature in numpy at import.
* ``cie_*``, ``wavelength_pdf``, ``sample_wavelengths``, ``lift``,
  ``to_rgb`` and ``eta_at`` on equal seeded inputs: within rtol 1e-6 of
  the reference (atol 2.4e-7, two ulps of 1, where a value is near 0: the
  CMFs' negative lobe cancels; ``to_rgb`` atol 1e-6, its 12 signed terms
  a channel each off by an ulp of exp).
* The reference's self-contained checks (tests/test_spectral.py:42-123,
  :160) restated on the port.
* Frames against the reference at equal seeds, the reference run op by op
  (``jax.disable_jit``): ``data/dispersion.xml`` (the chunk sweep, its own
  spectral integrator, depth 6) and a spectral ``oracle_mat.xml``
  at 64x64 (oracle_mat's own film), 2 and 1 progressive frames: frame rel MSE <= 1e-5, >=
  99% of pixels within rtol 1e-4, ``test`` AOV bit-equal (the gate of
  tests/test_torch_frame.py; a rare lane may take another branch after an
  ulp-level difference).
* The sanitizer: ``finite_report`` / ``assert_all_finite`` on equal inputs;
  the report of a frame with ``debug_checks`` equal to the reference's,
  clean (oracle_mat) and with NaN constant colours in the texture table
  (the reference's tests/test_sanitizer.py:58); ``PTPass``'s gate under
  ``PUPIL_SANITIZE`` is held in tests/test_torch_system.py. Spectral frames count
  negative radiance: the sensor's sRGB matching functions are negative in
  places, so a one-sample estimate is too, in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.render import spectral as jsp
from pupiloptixlab_tpu.render.integrator import render_frame as jax_render_frame
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu.utils import debug as jdebug
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.flatten.types import MAT_DISPERSION, TEX_RGB
from pupiloptixlab_tpu_torch.render import spectral as sp
from pupiloptixlab_tpu_torch.render.integrator import render, render_frame
from pupiloptixlab_tpu_torch.render.vec import Vec3
from pupiloptixlab_tpu_torch.scene import Scene
from pupiloptixlab_tpu_torch.scene.emitters import Emitter, EmitterType
from pupiloptixlab_tpu_torch.scene.materials import Material, MatType
from pupiloptixlab_tpu_torch.scene.shapes import ShapeInstance
from pupiloptixlab_tpu_torch.scene.textures import rgb_texture
from pupiloptixlab_tpu_torch.utils.debug import SanitizerError, assert_all_finite, finite_report
from pupiloptixlab_tpu_torch.utils.math import Transform, look_at_matrix, mitsuba_handedness_fix
from test_torch_frame import DATA, _jax_tables, _load

RTOL, ATOL = 1e-6, 2.4e-7  # atol: 2 ulps of 1, for values near 0


def _np(x):
    return np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


# -- the module's functions against the reference ---------------------------


def test_calibrated_constants_equal_reference():
    assert sp._D_SCALE == jsp._D_SCALE
    assert sp._M_BASIS == jsp._M_BASIS
    assert sp._C_RGB == jsp._C_RGB
    for name in ("_VIS_A", "_VIS_MU", "_VIS_T0", "_VIS_T1", "_VIS_NORM", "LAM_MIN",
                 "LAM_MAX", "LAM_D", "LAM_F", "LAM_C", "SPECTRAL_SAMPLES"):
        assert getattr(sp, name) == getattr(jsp, name), name
    np.testing.assert_array_equal(sp._XYZ_TO_SRGB, jsp._XYZ_TO_SRGB)
    assert sp.abbe_to_cauchy(1.5168, 64.17) == jsp.abbe_to_cauchy(1.5168, 64.17)
    # the constants themselves, as float32: what the frame multiplies by
    for a, b in zip(np.float32(np.ravel(sp._C_RGB)), np.float32(np.ravel(jsp._C_RGB))):
        assert a.tobytes() == b.tobytes()


def test_spectral_functions_match_reference():
    rs = np.random.RandomState(11)
    n = 4096
    lam = rs.uniform(sp.LAM_MIN, sp.LAM_MAX, n).astype(np.float32)
    u = rs.rand(n).astype(np.float32)
    rgb = rs.uniform(-0.2, 2.0, (3, n)).astype(np.float32)
    eta = rs.uniform(1.0, 2.0, n).astype(np.float32)
    b = rs.uniform(0.0, 0.02, n).astype(np.float32)
    tl, jl = torch.from_numpy(lam), jnp.asarray(lam)
    for f in ("cie_x", "cie_y", "cie_z", "wavelength_pdf"):
        _close(getattr(sp, f)(tl), getattr(jsp, f)(jl))
    lams_t, lams_j = sp.sample_wavelengths(torch.from_numpy(u)), jsp.sample_wavelengths(jnp.asarray(u))
    for a, c in zip(lams_t, lams_j):
        _close(a, c)
    # each function on equal inputs: the reference's wavelengths
    lams_t = sp.Spec4(*(torch.from_numpy(np.array(x)) for x in lams_j))
    v_t = Vec3(*(torch.from_numpy(c) for c in rgb))
    v_j = JVec3(*(jnp.asarray(c) for c in rgb))
    s_t, s_j = sp.lift(v_t, lams_t), jsp.lift(v_j, lams_j)
    for a, c in zip(s_t, s_j):
        _close(a, c)
    s_t = sp.Spec4(*(torch.from_numpy(np.array(x)) for x in s_j))
    for a, c in zip(sp.to_rgb(s_t, lams_t), jsp.to_rgb(s_j, lams_j)):
        # 12 signed terms a channel, each off by an ulp of exp: atol 1e-6
        np.testing.assert_allclose(_np(a), _np(c), rtol=RTOL, atol=1e-6)
    _close(sp.eta_at(torch.from_numpy(eta), torch.from_numpy(b), tl),
           jsp.eta_at(jnp.asarray(eta), jnp.asarray(b), jl))
    assert sp.Spec4(*lams_t).mean().shape == (n,)


# -- the reference's self-contained checks on the port ------------------------


def _quad_rgb(rgb):
    """Dense-quadrature rgb of lift(rgb): the exact sensor integral."""
    lam = torch.linspace(sp.LAM_MIN, sp.LAM_MAX, 4001)
    v = Vec3(*(torch.full((4001,), float(c)) for c in rgb))
    s = sp.lift(v, sp.Spec4(lam, lam, lam, lam)).s0
    x, y, z = sp.cie_x(lam), sp.cie_y(lam), sp.cie_z(lam)
    out = []
    for c in range(3):
        m = sp._XYZ_TO_SRGB[c]
        w = sp._D_SCALE[c] * (m[0] * x + m[1] * y + m[2] * z)
        out.append(float(np.trapezoid((s * w).numpy(), lam.numpy())))
    return np.array(out)


def test_white_lifts_to_unit_spectrum():
    lam = torch.linspace(sp.LAM_MIN, sp.LAM_MAX, 801)
    s = sp.lift(Vec3.ones(801), sp.Spec4(lam, lam, lam, lam))
    np.testing.assert_allclose(s.s0.numpy(), 1.0, atol=1e-6)


def test_rgb_round_trip_exact_in_gamut():
    rs = np.random.RandomState(7)
    for rgb in rs.rand(6, 3):
        np.testing.assert_allclose(_quad_rgb(rgb), rgb, atol=2e-6)


def test_estimator_unbiased_over_wavelengths():
    rgb = (0.7, 0.4, 0.2)
    n = 20000
    u = torch.from_numpy(((np.arange(n) + 0.5) / n).astype(np.float32))
    lams = sp.sample_wavelengths(u)
    v = Vec3(*(torch.full((n,), float(c)) for c in rgb))
    est = sp.to_rgb(sp.lift(v, lams), lams).to_array().numpy()
    np.testing.assert_allclose(est.mean(0), _quad_rgb(rgb), atol=2e-3)


def test_wavelengths_stratified_and_importance():
    lams = sp.sample_wavelengths(torch.tensor([0.1, 0.9]))
    a = np.sort(np.stack([x.numpy() for x in lams])[:, 0])
    assert a.min() >= sp.LAM_MIN - 1e-3 and a.max() <= sp.LAM_MAX + 1e-3
    q = np.sort((np.tanh(sp._VIS_A * (a - sp._VIS_MU)) - sp._VIS_T0) / (sp._VIS_T1 - sp._VIS_T0))
    assert all(j / 4 <= q[j] <= (j + 1) / 4 for j in range(4)), q
    lam = np.linspace(sp.LAM_MIN, sp.LAM_MAX, 2001)
    p = sp.wavelength_pdf(torch.from_numpy(lam)).numpy()
    assert np.trapezoid(p, lam) == pytest.approx(1.0, abs=1e-6)
    n = 20000
    u = torch.from_numpy(((np.arange(n) + 0.5) / n).astype(np.float32))
    est = sp.to_rgb(sp.Spec4.ones(n), sp.sample_wavelengths(u)).to_array().numpy()
    np.testing.assert_allclose(est.mean(0), 1.0, atol=2e-3)
    assert est.std(0)[0] < 0.2 and est.std(0)[1] < 0.08


def _furnace_scene(dispersive_glass=False):
    scene = Scene()
    scene.shape_instances = [ShapeInstance(
        shape=scene.shape_manager.load_rectangle(),
        material=Material(type=MatType.DIFFUSE, reflectance=rgb_texture(1.0)),
        transform=Transform().scale(100, 100, 1).rotate(1, 0, 0, -90),
    )]
    if dispersive_glass:
        scene.shape_instances.append(ShapeInstance(
            shape=scene.shape_manager.load_sphere(),
            material=Material(type=MatType.DIELECTRIC, int_ior=1.5, ext_ior=1.0,
                              dispersion=0.009),
            transform=Transform().translate(0, 1.5, 0),
        ))
    scene.emitters = [Emitter(type=EmitterType.CONST_ENV, color=np.ones(3, np.float32))]
    scene.sensor.film.w = scene.sensor.film.h = 24
    scene.integrator.max_depth = 6
    m = mitsuba_handedness_fix(mitsuba_handedness_fix(
        look_at_matrix([0, 5, 0.01], [0, 0, 0], [0, 1, 0])))
    scene.sensor.transform = Transform(m)
    scene.sensor.fov = 30.0
    return scene


def test_spectral_white_furnace():
    """White lifts to the constant-1 spectrum, so the spectral frame keeps
    the furnace's energy; only the sensor's wavelength MC adds variance."""
    scene = _furnace_scene()
    data, config = flatten_scene(scene, device="cpu")
    config = dataclasses.replace(config, spectral=True)
    img = render(data, camera_block_from_scene(scene, device="cpu"), config, spp=96).numpy()
    assert img.mean() == pytest.approx(1.0, rel=0.03)
    np.testing.assert_allclose(img.reshape(-1, 3).mean(0), 1.0, rtol=0.04)


def test_dispersion_eta_and_rainbow():
    """eta(lambda) falls with wavelength, and a dispersive glass sphere
    makes chroma that the same sphere without dispersion lacks."""
    e = sp.eta_at(torch.full((3,), 1.5), torch.full((3,), 0.009),
                  torch.tensor([420.0, 580.0, 700.0])).numpy()
    assert e[0] > e[1] > e[2] > 1.0
    scene = _furnace_scene(dispersive_glass=True)
    data, config = flatten_scene(scene, device="cpu")
    config = dataclasses.replace(config, spectral=True, max_depth=4)
    camera = camera_block_from_scene(scene, device="cpu")
    img = render(data, camera, config, spp=32).numpy()
    assert np.isfinite(img).all()
    packed = data.materials.packed.clone()
    packed[:, MAT_DISPERSION] = 0.0
    data0 = dataclasses.replace(data, materials=dataclasses.replace(data.materials, packed=packed))
    img0 = render(data0, camera, config, spp=32).numpy()

    def chroma(im):
        return np.abs(np.diff(im, axis=-1)).max()

    assert chroma(img) > 2.0 * chroma(img0), (chroma(img), chroma(img0))


# -- frames against the reference -------------------------------------------


def _frames(jd, jc, jcam, data, config, cam, seeds):
    n = config.width * config.height
    jacc = jnp.zeros((n, 3), jnp.float32)
    acc = torch.zeros((n, 3))
    out = []
    for i in seeds:
        with jax.disable_jit():
            jacc, jb = jax_render_frame(jd, jcam, jnp.uint32(i), jnp.int32(i), jacc, jc)
        acc, b = render_frame(data, cam, i, i, acc, config)
        out.append(({k: v for k, v in jb.items()}, {k: v for k, v in b.items()}))
        jb_np = {k: np.asarray(v) for k, v in jb.items() if k != "sanitizer"}
        b_np = {k: v.numpy() for k, v in b.items() if k != "sanitizer"}
        a, g = jb_np["frame"], b_np["frame"]
        rel = float(np.mean((a - g) ** 2) / max(np.mean(a ** 2), 1e-30))
        frac = float(np.isclose(g, a, rtol=1e-4, atol=0.0).all(-1).mean())
        print(f"seed {i}: rel MSE {rel:.3e}, within rtol 1e-4 {frac:.4f}")
        assert np.isfinite(g).all() and rel <= 1e-5 and frac >= 0.99, (rel, frac)
        np.testing.assert_array_equal(b_np["test"], jb_np["test"])
        np.testing.assert_allclose(b_np["albedo"], jb_np["albedo"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b_np["normal"], jb_np["normal"], rtol=1e-5, atol=1e-5)
    return out


def _debug(jc, config):
    return dataclasses.replace(jc, debug_checks=True), dataclasses.replace(config, debug_checks=True)


def _report(r):
    return {k: int(v) for k, v in r.items()}


def test_dispersion_frames_match_reference():
    (jd, jc, jcam), (data, config, cam) = _jax_tables(_load("dispersion.xml", 64, 64))
    assert config.spectral and config.bvh_nodes == 0 and config.max_depth == 6
    jc, config = _debug(jc, config)
    out = _frames(jd, jc, jcam, data, config, cam, [0, 1])
    for jb, b in out:
        assert _report(b["sanitizer"]) == _report(jb["sanitizer"])
    assert out[0][1]["sanitizer"]["radiance"] > 0  # negative spectral estimates


def test_spectral_oracle_mat_frames_match_reference():
    (jd, jc, jcam), (data, config, cam) = _jax_tables(_load("oracle_mat.xml", 64, 64))
    jc = dataclasses.replace(jc, spectral=True)
    config = dataclasses.replace(config, spectral=True)
    _frames(jd, jc, jcam, data, config, cam, [2])  # blends into a zero accumulation


# -- the sanitizer -------------------------------------------------------------


def test_finite_report_matches_reference():
    rs = np.random.RandomState(3)
    arr = rs.randn(257).astype(np.float32)
    arr[[3, 40]] = np.nan
    arr[[7, 100, 200]] = np.inf
    arr[9] = -np.inf
    stages = {"a": None, "b": 0.0, "c": -0.5}
    got = finite_report({k: (torch.from_numpy(arr), lo) for k, lo in stages.items()})
    want = jdebug.finite_report({k: (jnp.asarray(arr), lo) for k, lo in stages.items()})
    assert _report(got) == _report(want) and _report(got)["a"] == 6
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in got.values())
    small = finite_report({"a": (torch.tensor([1.0, float("nan"), -2.0, float("inf")]), None),
                           "b": (torch.tensor([1.0, float("nan"), -2.0, float("inf")]), 0.0)})
    assert _report(small) == {"a": 2, "b": 3}
    assert_all_finite({"x": torch.zeros((), dtype=torch.int32)})
    with pytest.raises(SanitizerError) as e1:
        assert_all_finite(got, context="pt")
    with pytest.raises(jdebug.SanitizerError) as e2:
        jdebug.assert_all_finite(want, context="pt")
    assert str(e1.value) == str(e2.value)
    assert "[pt]" in str(e1.value) and "a: 6 bad element(s)" in str(e1.value)


def test_sanitizer_frame_counts_match_reference():
    """oracle_mat at 64x64, depth 3: the clean frame reports zeros in both
    packages; with NaN constant colours in the texture table both report
    the same counts and the gate names the stage."""
    (jd, jc, jcam), (data, config, cam) = _jax_tables(_load("oracle_mat.xml", 64, 64))
    jc = dataclasses.replace(jc, debug_checks=True, max_depth=3)
    config = dataclasses.replace(config, debug_checks=True, max_depth=3)
    n = config.width * config.height

    def both(jd, data):
        with jax.disable_jit():
            _, jb = jax_render_frame(jd, jcam, jnp.uint32(0), jnp.int32(0),
                                     jnp.zeros((n, 3), jnp.float32), jc)
        _, b = render_frame(data, cam, 0, 0, torch.zeros((n, 3)), config)
        return _report(jb["sanitizer"]), b["sanitizer"]

    want, got = both(jd, data)
    assert set(want) == {"radiance", "albedo", "normal", "primary_t", "throughput"}
    assert _report(got) == want and all(v == 0 for v in want.values()), want
    assert_all_finite(got)

    jtex = np.asarray(jd.textures.packed).copy()
    jtex[:, TEX_RGB] = np.nan
    jd_bad = dataclasses.replace(jd, textures=dataclasses.replace(
        jd.textures, packed=jnp.asarray(jtex)))
    tex = data.textures.packed.clone()
    tex[:, TEX_RGB] = float("nan")
    data_bad = dataclasses.replace(data, textures=dataclasses.replace(data.textures, packed=tex))
    want, got = both(jd_bad, data_bad)
    assert _report(got) == want and want["radiance"] > 0, want
    with pytest.raises(SanitizerError) as e:
        assert_all_finite(got, context="pt")
    assert "radiance" in str(e.value) and "[pt]" in str(e.value)
