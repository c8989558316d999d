"""Port parity on the CPU for the denoiser (denoise/, passes/denoise.py).

The reference functions run op by op under ``jax.disable_jit()``: jitted,
XLA's CPU backend contracts a*b+c into FMAs where PyTorch rounds each
operation, and compiling the 5-iteration filter takes minutes on one core.
Inputs come from numpy seeds. Most images are 24x20, aligned to neither the
8-row nor the 128-lane tile, so each reference primitive is compiled for
one shape.

* ``atrous_denoise`` (the plain filter) and ``atrous_denoise_cuda`` (one
  K9 call per iteration; on the CPU its plain version ``atrous_iter_plain``)
  against the reference's ``atrous_denoise``, guided, unguided and with a
  non-integer normal power: atol 2e-6, rtol 1e-5, the limits of
  tests/test_denoise.py:351 (the two ports of exp differ by an ulp or so);
  the two port routes are bit-equal.
* ``atrous_denoise_cuda`` against ``atrous_denoise_pallas(interpret=True)``
  at 2 iterations: the same limits.
* The variance (SVGF) and AOV modes, ``reproject``, ``temporal_blend`` with
  and without motion, both ``upscale_2x`` branches and ``Denoiser`` with
  TILED, TEMPORAL state, APPLY_TO_AOV and UPSCALE_2X + TEMPORAL: atol 2e-6,
  rtol 1e-5 on radiance. ``camera_motion_vectors`` (two 4x4 inverses and
  two matrix products, whose summation order differs between the
  libraries): within 2e-3 pixels.
* ``DenoisePass`` after a ``PTPass`` frame of data/oracle_mat.xml at its
  64x64 film through the port's CPU ``System``: ``pt denoised`` equals the
  reference's ``atrous_denoise`` of the port's own buffers, at the limits
  above.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.denoise import Denoiser as JaxDenoiser
from pupiloptixlab_tpu.denoise import DenoiserMode as JaxMode
from pupiloptixlab_tpu.denoise import atrous as ja
from pupiloptixlab_tpu.denoise.pallas_atrous import atrous_denoise_pallas
from pupiloptixlab_tpu_torch.denoise import Denoiser, DenoiserMode
from pupiloptixlab_tpu_torch.denoise import atrous as ta
from pupiloptixlab_tpu_torch.denoise import atrous_kernel as tk
from pupiloptixlab_tpu_torch.flatten import camera_block
from pupiloptixlab_tpu_torch.passes import DenoisePass, PTPass
from pupiloptixlab_tpu_torch.system import System
from pupiloptixlab_tpu_torch.utils.camera import Camera, CameraDesc
from pupiloptixlab_tpu_torch.utils.math import Transform

DATA = Path(__file__).resolve().parent.parent / "data"
H, W = 24, 20
TOL = dict(atol=2e-6, rtol=1e-5)


def _inputs(seed, h=H, w=W):
    """Colour and albedo in [0, 1), unit normals (bench.py:89-94's recipe)."""
    r = np.random.RandomState(seed)
    color = r.rand(h, w, 3).astype(np.float32)
    albedo = r.rand(h, w, 3).astype(np.float32)
    normal = r.randn(h, w, 3).astype(np.float32)
    normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)
    return color, albedo, normal


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ref(fn, *args, **kwargs):
    """The reference op by op, numpy in, numpy out (tuples kept)."""
    with jax.disable_jit():
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
                 **kwargs)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("kwargs", [
    {},
    {"use_albedo": False, "use_normal": False},
    {"iterations": 3, "sigma_normal": 0.3},  # n_pow 3.33: pow, not products
], ids=["guided", "unguided", "pow"])
def test_atrous_denoise_matches_reference(kwargs):
    c, a, n = _inputs(3)
    want = _ref(ja.atrous_denoise, c, a, n, **kwargs)
    plain = ta.atrous_denoise(_t(c), _t(a), _t(n), **kwargs)
    k9 = tk.atrous_denoise_cuda(_t(c), _t(a), _t(n), **kwargs)
    assert plain.shape == k9.shape == (H, W, 3)
    assert torch.equal(plain, k9)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_atrous_denoise_cuda_matches_pallas_interpret():
    c, a, n = _inputs(4)
    want = np.asarray(atrous_denoise_pallas(jnp.asarray(c), jnp.asarray(a),
                                            jnp.asarray(n), iterations=2,
                                            interpret=True))
    got = tk.atrous_denoise_cuda(_t(c), _t(a), _t(n), iterations=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_normal_power_rule():
    assert tk.normal_power(0.25) == (4.0, 4)
    assert tk.normal_power(1.0) == (1.0, 1)
    assert tk.normal_power(0.1)[1] == 0  # 10 > 8: pow
    assert tk.normal_power(0.3)[1] == 0


def test_variance_and_aov_modes_match_reference():
    c, a, n = _inputs(5)
    r = np.random.RandomState(6)
    var = (r.rand(H, W) * 0.05).astype(np.float32)
    aov = (0.5 + 0.2 * r.randn(H, W, 3)).astype(np.float32)
    want = _ref(ja.atrous_denoise, c, a, n, iterations=3, variance=var)
    got = ta.atrous_denoise(_t(c), _t(a), _t(n), iterations=3, variance=_t(var))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_c, want_aovs = _ref(ja.atrous_denoise, c, a, n, iterations=3, aovs=(c, aov))
    got_c, got_aovs = ta.atrous_denoise(_t(c), _t(a), _t(n), iterations=3,
                                        aovs=(_t(c), _t(aov)))
    np.testing.assert_allclose(got_c.numpy(), want_c, **TOL)
    assert len(got_aovs) == 2
    for g, w in zip(got_aovs, want_aovs):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert torch.equal(got_aovs[0], got_c)  # the beauty's own weights


def test_reproject_and_temporal_blend_match_reference():
    cur, prev, _ = _inputs(7)
    r = np.random.RandomState(8)
    motion = (r.randn(H, W, 2) * 3.0).astype(np.float32)  # some land off frame
    want_w, want_v = _ref(ja.reproject, prev, motion)
    got_w, got_v = ta.reproject(_t(prev), _t(motion))
    assert 0 < got_v.numpy().mean() < 1
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_allclose(got_w.numpy(), want_w, **TOL)
    for m in (None, motion):
        want = _ref(ja.temporal_blend, cur, prev, motion=None if m is None else jnp.asarray(m))
        got = ta.temporal_blend(_t(cur), _t(prev), motion=None if m is None else _t(m))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_camera_motion_vectors_match_reference():
    # a camera at (0, 1.2, 3.5) looking about 10 degrees down, as mesh_env's does
    cam = Camera(CameraDesc(fov_y=45.0, aspect_ratio=W / H, to_world=Transform().look_at(
        (0.0, 1.2, 3.5), (0.0, 0.5, -0.6), (0.0, 1.0, 0.0))))
    block = camera_block(cam, device="cpu")
    s2c = block.sample_to_camera.numpy().astype(np.float64)
    c2w = block.camera_to_world.numpy().astype(np.float64)
    # world points on each pixel's centre ray at seeded depths, seen from a
    # camera moved since the previous frame
    r = np.random.RandomState(9)
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    ndc = np.stack([(px.ravel() + 0.5) / W, (py.ravel() + 0.5) / H,
                    np.zeros(H * W), np.ones(H * W)], 1)
    pc = ndc @ s2c.T
    d = pc[:, :3] / pc[:, 3:4]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dw = (np.concatenate([d, np.zeros((H * W, 1))], 1) @ c2w.T)[:, :3]
    depth = r.uniform(2.0, 6.0, (H * W, 1))
    pos = (c2w[:3, 3] + dw * depth).reshape(H, W, 3).astype(np.float32)
    hit = r.rand(H, W) < 0.8
    moved = c2w.copy()
    moved[:3, 3] += (0.05, -0.02, 0.03)
    prev = SimpleNamespace(sample_to_camera=s2c.astype(np.float32),
                           camera_to_world=moved.astype(np.float32))
    want = _ref(ja.camera_motion_vectors, pos, hit, prev, W, H)
    got = ta.camera_motion_vectors(_t(pos), _t(hit), prev, W, H).numpy()
    assert np.abs(want).max() > 0.1  # the camera moved
    np.testing.assert_array_equal(got[~hit], 0.0)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_upscale_2x_matches_reference():
    low, _, _ = _inputs(10)
    _, a_hi, n_hi = _inputs(11, 2 * H, 2 * W)
    want = _ref(ja.upscale_2x, low, a_hi, n_hi)
    got = ta.upscale_2x(_t(low), _t(a_hi), _t(n_hi))
    assert got.shape == (2 * H, 2 * W, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # bilinear: jax.image.resize's half-pixel centres, edge pixels kept
    want = _ref(ja.upscale_2x, low)
    got = ta.upscale_2x(_t(low))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def _both(mode_bits):
    return (Denoiser(DenoiserMode(mode_bits)), JaxDenoiser(JaxMode(mode_bits)))


def test_denoiser_tiled_matches_reference():
    c, a, n = _inputs(12, 2 * W, W)  # two overlapped tiles of 24x20
    port, ref = _both(DenoiserMode.USE_ALBEDO | DenoiserMode.USE_NORMAL | DenoiserMode.TILED)
    for d in (port, ref):
        d.setup(W, 2 * W)
        d.tile_size, d.overlap = W, 4
    want = _ref(ref.execute, {"input": jnp.asarray(c), "albedo": jnp.asarray(a),
                              "normal": jnp.asarray(n)})
    got = port.execute({"input": _t(c), "albedo": _t(a), "normal": _t(n)})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("upscale", [False, True], ids=["temporal", "upscale_temporal"])
def test_denoiser_temporal_state_matches_reference(upscale):
    bits = DenoiserMode.USE_ALBEDO | DenoiserMode.TEMPORAL | DenoiserMode.APPLY_TO_AOV
    if upscale:
        bits |= DenoiserMode.UPSCALE_2X
    port, ref = _both(bits)
    for d in (port, ref):
        d.setup(W, H)
    for frame in range(2):
        c, a, n = _inputs(13 + frame)
        want, want_aov = _ref(ref.execute, {
            "input": jnp.asarray(c), "albedo": jnp.asarray(a), "normal": jnp.asarray(n),
            "aovs": {"diffuse": jnp.asarray(a)}})
        got, got_aov = port.execute({"input": _t(c), "albedo": _t(a), "normal": _t(n),
                                     "aovs": {"diffuse": _t(a)}})
        assert got.shape == ((2 * H, 2 * W, 3) if upscale else (H, W, 3))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert set(got_aov) == {"diffuse"}
        np.testing.assert_allclose(got_aov["diffuse"].numpy(), want_aov["diffuse"], **TOL)
        # the history lives at the render resolution
        assert port._previous.shape == (H, W, 3)
        np.testing.assert_allclose(port._previous.numpy(), np.asarray(ref._previous), **TOL)


def test_denoise_pass_matches_reference_on_port_buffers():
    system = System(device="cpu")
    pt = PTPass()
    dn = DenoisePass()
    system.add_pass(pt)
    system.add_pass(dn)
    assert system.set_scene(DATA / "oracle_mat.xml")
    system.run(max_frames=1)
    bm = system.buffers
    assert "pt denoised" in bm.displayable_names()
    h, w = dn._shape
    assert (h, w) == (64, 64)
    color = _np(bm["pt frame"].array)[:, :3].reshape(h, w, 3)
    albedo = _np(bm["pt albedo"].array).reshape(h, w, 3)
    normal = _np(bm["pt normal"].array).reshape(h, w, 3)
    got = _np(bm["pt denoised"].array)
    assert got.shape == (h * w, 3) and np.isfinite(got).all()
    want = _ref(ja.atrous_denoise, color, albedo, normal)
    np.testing.assert_allclose(got.reshape(h, w, 3), want, **TOL)
    assert got.std() < color.std()  # the check of tests/test_mesh_env.py:60-63
    system.destroy()


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _atrous_iter_model(color, albedo, normal, step: int, use_albedo: bool = True,
                      use_normal: bool = True, sigma_color: float = 0.35,
                      sigma_albedo: float = 0.15, sigma_normal: float = 0.25):
    """K9's arithmetic in float32 on (3, h, w) planes, where it departs from
    ``atrous_step``'s order (csrc/atrous.cu): the albedo distance and the
    normal dot as fused multiply-add chains, one exponential of the two
    edge-stop exponents summed, and the weighted sums accumulated with
    fused multiply-adds. Taps in row-major order, edges clamped, as the
    kernel sums them."""
    _, h, w = color.shape
    inv_2sc = 1.0 / (2.0 * sigma_color**2)
    inv_2sa = 1.0 / (2.0 * sigma_albedo**2)
    n_pow, npow_int = tk.normal_power(sigma_normal)
    halo = 2 * step
    pads = tk._edge_pad(torch.cat([color, albedo, normal]), halo)
    lum = 0.2126 * pads[0] + 0.7152 * pads[1] + 0.0722 * pads[2]
    lum_c = lum[halo:halo + h, halo:halo + w]
    ac = albedo
    nc = normal
    acc = [torch.zeros_like(color[0]) for _ in range(3)]
    wsum = torch.zeros_like(color[0])
    for iy in range(-2, 3):
        for ix in range(-2, 3):
            k = float(tk._B3[iy + 2] * tk._B3[ix + 2])
            y0, x0 = halo + iy * step, halo + ix * step

            def sh(j):
                return pads[j, y0:y0 + h, x0:x0 + w]

            dl = lum[y0:y0 + h, x0:x0 + w] - lum_c
            e = -(dl * dl) * inv_2sc
            if use_albedo:
                d = [sh(3 + c) - ac[c] for c in range(3)]
                da = _fma(d[2], d[2], _fma(d[1], d[1], d[0] * d[0]))
                e = _fma(-da, torch.full_like(da, inv_2sa), e)
            wt = k * torch.exp(e)
            if use_normal:
                nd = _fma(sh(8), nc[2], _fma(sh(7), nc[1], sh(6) * nc[0]))
                ndot = torch.clamp(nd, 0.0, 1.0)
                if npow_int:
                    pw = ndot
                    for _ in range(npow_int - 1):
                        pw = pw * ndot
                else:
                    pw = torch.pow(ndot, n_pow)
                wt = wt * pw
            acc = [_fma(sh(c), wt, acc[c]) for c in range(3)]
            wsum = wsum + wt
    inv_w = 1.0 / torch.clamp(wsum, min=1e-8)
    return torch.stack([a * inv_w for a in acc])


@pytest.mark.parametrize("kwargs", [
    {},
    {"use_albedo": False, "use_normal": False},
    {"use_albedo": True, "use_normal": False},
    {"sigma_normal": 0.3},  # n_pow 3.33: pow, not products
], ids=["guided", "unguided", "albedo", "pow"])
def test_k9_arithmetic_model_within_the_gate(kwargs):
    """K9's float32 arithmetic (``_atrous_iter_model``: fused multiply-add
    chains, one exponential a tap, fused accumulation) against its plain
    version ``atrous_iter_plain`` at steps 1-16, each step on the plain
    output of the one before, on HDR colour (uniform times a log-normal
    factor up to ~1e3, a few fireflies at 1e4) over a 37x23 image, so that
    steps 8 and 16 clamp at every edge: within K9's gate, atol 2e-6 and
    rtol 1e-5."""
    r = np.random.RandomState(21)
    h, w = 23, 37
    color = r.rand(3, h, w) * np.exp(r.randn(1, h, w) * 2.0)
    color[:, r.randint(0, h, 4), r.randint(0, w, 4)] = 1e4
    albedo = r.rand(3, h, w)
    normal = r.randn(3, h, w)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    x, a, n = (_t(v.astype(np.float32)) for v in (color, albedo, normal))
    worst = 0.0
    for it in range(5):
        step = 1 << it
        want = tk.atrous_iter_plain(x, a, n, step, **kwargs)
        got = _atrous_iter_model(x, a, n, step, **kwargs)
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, float(((got - want).abs() / (2e-6 + 1e-5 * want.abs())).max()))
        x = want
    assert worst > 0.0  # the model's arithmetic does depart from the plain order
