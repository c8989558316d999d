"""Hero-wavelength spectral transport (4 wavelengths a path).

Mirrors pupiloptixlab_tpu/render/spectral.py: a path carries C = 4
wavelengths (the hero and 3 rotated strata, Wilkie et al. 2014) as four
(N,) planes (``Spec4``, the layout of Vec3), RGB reflectances and
radiances lift to spectra through a calibrated partition-of-unity basis,
and the sensor integrates against the CIE 1931 fits (Wyman, Sloan,
Shirley, JCGT 2013) by Monte Carlo over the path's wavelengths.

Every op here is elementwise plain PyTorch; the calibration runs once in
numpy at import, in float64, as the reference's does, so its constants
are the same Python floats.

Dispersion: dielectrics carry a Cauchy coefficient B (um^2; the scene
layer's ``abbe_to_cauchy`` turns an Abbe number into one), and
eta(lambda) = eta_d + B (1/lambda^2 - 1/lambda_d^2). The path's geometry
follows the hero; on the first dispersive transmission the 3 secondary
wavelengths terminate (the integrator's hero collapse).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.render.vec import Vec3
from benchmark.reference.scene.materials import LAM_C, LAM_F, abbe_to_cauchy  # noqa: F401

SPECTRAL_SAMPLES = 4
LAM_MIN, LAM_MAX = 380.0, 780.0
LAM_RANGE = LAM_MAX - LAM_MIN
LAM_D = 587.6  # Fraunhofer d line (nm): the anchor of eta(lambda)


class Spec4(NamedTuple):
    """Four spectral samples as dense (N,) planes (cf. Vec3)."""

    s0: torch.Tensor  # hero
    s1: torch.Tensor
    s2: torch.Tensor
    s3: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Spec4):
            return Spec4(*(a + b for a, b in zip(self, o)))
        return Spec4(*(a + o for a in self))

    def __mul__(self, o):
        if isinstance(o, Spec4):
            return Spec4(*(a * b for a, b in zip(self, o)))
        return Spec4(*(a * o for a in self))

    __rmul__ = __mul__

    @staticmethod
    def zeros(n: int, device=None) -> "Spec4":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return Spec4(z, z, z, z)

    @staticmethod
    def ones(n: int, device=None) -> "Spec4":
        o = torch.ones(n, dtype=torch.float32, device=device)
        return Spec4(o, o, o, o)

    def mean(self):
        return 0.25 * (self.s0 + self.s1 + self.s2 + self.s3)

    def to_array(self) -> torch.Tensor:
        """planes -> (N, 4)."""
        return torch.stack(list(self), dim=-1)


# -- CIE 1931 CMFs: Wyman, Sloan, Shirley (JCGT 2013) multi-Gaussian fits ----


def _pg(lam, mu, s1, s2):
    """Piecewise Gaussian: sigma = s1 below mu, s2 above."""
    s = torch.where(lam < mu, s1, s2)
    t = (lam - mu) / s
    return torch.exp(-0.5 * t * t)


def cie_x(lam):
    return (
        1.056 * _pg(lam, 599.8, 37.9, 31.0)
        + 0.362 * _pg(lam, 442.0, 16.0, 26.7)
        - 0.065 * _pg(lam, 501.1, 20.4, 26.2)
    )


def cie_y(lam):
    return 0.821 * _pg(lam, 568.8, 46.9, 40.5) + 0.286 * _pg(lam, 530.9, 16.3, 31.1)


def cie_z(lam):
    return 1.217 * _pg(lam, 437.0, 11.8, 36.0) + 0.681 * _pg(lam, 459.0, 26.0, 13.8)


# XYZ -> linear sRGB (IEC 61966-2-1)
_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float64,
)


def _smoothstep(x, a, b):
    t = torch.clamp((x - a) / (b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# Band edges of the partition-of-unity reflectance basis, near the
# blue-green / green-red CMF crossovers; the 3x3 calibration absorbs the
# exact placement.
_EDGE_BG = (460.0, 520.0)
_EDGE_GR = (555.0, 625.0)


def _basis(lam):
    """Partition-of-unity smoothstep bands (b_r, b_g, b_b), summing to 1
    at every lambda."""
    t_bg = _smoothstep(lam, *_EDGE_BG)
    t_gr = _smoothstep(lam, *_EDGE_GR)
    return t_gr, t_bg - t_gr, 1.0 - t_bg


def _trapezoid(y, x, axis=-1):
    """numpy's trapezoid rule (``np.trapezoid``, ``np.trapz`` before numpy 2)."""
    fn = getattr(np, "trapezoid", None) or np.trapz
    return fn(y, x, axis=axis)


def _calibrate():
    """Import-time quadrature in numpy float64:

    * D: per-channel scale mapping the constant-1 spectrum to sRGB (1,1,1),
    * M[c, b] = integral of rgbw_c(lambda) * basis_b(lambda), the
      basis -> rgb matrix (rows sum to 1),
    * C = M^-1, the rgb -> basis-coefficient matrix (C @ (1,1,1) = (1,1,1)).
    """
    lam = np.linspace(LAM_MIN, LAM_MAX, 2001)

    def pg(mu, s1, s2):
        s = np.where(lam < mu, s1, s2)
        return np.exp(-0.5 * ((lam - mu) / s) ** 2)

    cmf = np.stack([
        1.056 * pg(599.8, 37.9, 31.0) + 0.362 * pg(442.0, 16.0, 26.7)
        - 0.065 * pg(501.1, 20.4, 26.2),
        0.821 * pg(568.8, 46.9, 40.5) + 0.286 * pg(530.9, 16.3, 31.1),
        1.217 * pg(437.0, 11.8, 36.0) + 0.681 * pg(459.0, 26.0, 13.8),
    ])  # (3, L)
    rgbw_raw = _XYZ_TO_SRGB @ cmf  # (3, L)
    scale = _trapezoid(rgbw_raw, lam, axis=1)  # rgb of the unit spectrum
    d = 1.0 / scale
    rgbw = rgbw_raw * d[:, None]

    def ss(a, b):
        t = np.clip((lam - a) / (b - a), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    t_bg, t_gr = ss(*_EDGE_BG), ss(*_EDGE_GR)
    b = np.stack([t_gr, t_bg - t_gr, 1.0 - t_bg])  # (3, L)
    m = np.stack(
        [_trapezoid(rgbw * b[j][None, :], lam, axis=1) for j in range(3)],
        axis=1,
    )  # (3 rgb, 3 basis)
    c = np.linalg.inv(m)
    return (
        tuple(float(x) for x in d),
        tuple(tuple(float(x) for x in row) for row in m),
        tuple(tuple(float(x) for x in row) for row in c),
    )


_D_SCALE, _M_BASIS, _C_RGB = _calibrate()


# Visible-wavelength importance sampling: p(lambda) proportional to
# sech^2(A (lambda - MU)) (pbrt-v4's visible-wavelength pdf), normalised
# over [LAM_MIN, LAM_MAX] in closed form.
_VIS_A, _VIS_MU = 0.0072, 538.5
_VIS_T0 = float(np.tanh(_VIS_A * (LAM_MIN - _VIS_MU)))
_VIS_T1 = float(np.tanh(_VIS_A * (LAM_MAX - _VIS_MU)))
_VIS_NORM = (_VIS_T1 - _VIS_T0) / _VIS_A  # integral of sech^2(A(l-mu)) dl


def wavelength_pdf(lam: torch.Tensor) -> torch.Tensor:
    c = torch.cosh(_VIS_A * (lam - _VIS_MU))
    return 1.0 / (_VIS_NORM * c * c)


def sample_wavelengths(u: torch.Tensor) -> Spec4:
    """One uniform draw -> 4 stratified wavelengths (nm): the hero and 3
    equal rotations, warped through the visible-importance CDF (each
    marginally p = wavelength_pdf)."""
    def lam(j):
        f = u + j / SPECTRAL_SAMPLES
        f = f - torch.floor(f)
        t = _VIS_T0 + (_VIS_T1 - _VIS_T0) * f
        return _VIS_MU + torch.atanh(t) / _VIS_A

    return Spec4(lam(0), lam(1), lam(2), lam(3))


def lift(rgb: Vec3, lams: Spec4) -> Spec4:
    """rgb -> spectrum at the path's wavelengths:
    S(lambda) = max(sum_c (C rgb)_c basis_c(lambda), 0). Exact round trip
    in gamut; negative lobes of out-of-gamut colours clamp."""
    c = _C_RGB
    kr = c[0][0] * rgb.x + c[0][1] * rgb.y + c[0][2] * rgb.z
    kg = c[1][0] * rgb.x + c[1][1] * rgb.y + c[1][2] * rgb.z
    kb = c[2][0] * rgb.x + c[2][1] * rgb.y + c[2][2] * rgb.z

    def at(lam):
        br, bg, bb = _basis(lam)
        return torch.clamp(kr * br + kg * bg + kb * bb, min=0.0)

    return Spec4(*(at(l) for l in lams))


def to_rgb(spec: Spec4, lams: Spec4) -> Vec3:
    """Monte-Carlo CMF integration over the 4 path wavelengths:
    rgb = mean_j S_j * rgbw(lambda_j) / p(lambda_j)."""
    d = _D_SCALE
    acc = [0.0, 0.0, 0.0]
    for s, lam in zip(spec, lams):
        x, y, z = cie_x(lam), cie_y(lam), cie_z(lam)
        sp = s / wavelength_pdf(lam)
        for c in range(3):
            m0, m1, m2 = (float(v) for v in _XYZ_TO_SRGB[c])
            acc[c] = acc[c] + sp * (d[c] * (m0 * x + m1 * y + m2 * z))
    w = 1.0 / SPECTRAL_SAMPLES
    return Vec3(acc[0] * w, acc[1] * w, acc[2] * w)


def eta_at(eta_d: torch.Tensor, cauchy_b: torch.Tensor, lam_nm: torch.Tensor):
    """Cauchy dispersion on the ior RATIO, anchored at the d line:
    eta(lambda) = eta_d + B (1/lambda^2 - 1/lambda_d^2), lambda in um."""
    lam = lam_nm * 1e-3
    ld = LAM_D * 1e-3
    return eta_d + cauchy_b * (1.0 / (lam * lam) - 1.0 / (ld * ld))
