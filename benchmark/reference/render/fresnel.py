"""Fresnel terms (render/material/fresnel.h parity); mirrors
pupiloptixlab_tpu/render/fresnel.py."""

from __future__ import annotations

import torch

from benchmark.reference.render.vec import Vec3


def dielectric_reflectance(eta, cos_theta_i):
    """Exact dielectric Fresnel; returns (F, cos_theta_t) with the
    reference's sign convention: cos_theta_t opposite in sign to
    cos_theta_i, 0 on total internal reflection (F = 1)."""
    scale = torch.where(cos_theta_i > 0.0, torch.reciprocal(eta), eta)
    cos_t2 = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * scale * scale
    tir = cos_t2 <= 0.0

    ci = torch.abs(cos_theta_i)
    ct = torch.sqrt(torch.clamp(cos_t2, min=0.0))
    rs = (ci - eta * ct) / torch.clamp(ci + eta * ct, min=1e-20)
    rp = (eta * ci - ct) / torch.clamp(eta * ci + ct, min=1e-20)
    f = 0.5 * (rs * rs + rp * rp)

    cos_theta_t = torch.where(cos_theta_i > 0.0, -ct, ct)
    return torch.where(tir, 1.0, f), torch.where(tir, 0.0, cos_theta_t)


def conductor_reflectance(eta, k, cos_theta_i):
    """Scalar conductor Fresnel (fresnel.h:31-48)."""
    c2 = cos_theta_i * cos_theta_i
    s2 = 1.0 - c2
    s4 = s2 * s2

    t1 = eta * eta - k * k - s2
    a2pb2 = torch.sqrt(torch.clamp(t1 * t1 + 4.0 * k * k * eta * eta, min=0.0))
    a = torch.sqrt(torch.clamp(0.5 * (a2pb2 + t1), min=0.0))

    term1 = a2pb2 + c2
    term2 = 2.0 * a * cos_theta_i
    rs2 = (term1 - term2) / torch.clamp(term1 + term2, min=1e-20)

    term3 = a2pb2 * c2 + s4
    term4 = term2 * s2
    rp2 = rs2 * (term3 - term4) / torch.clamp(term3 + term4, min=1e-20)
    return 0.5 * (rp2 + rs2)


def conductor_reflectance_rgb(eta: Vec3, k: Vec3, cos_theta_i) -> Vec3:
    """Vec3 eta/k with per-lane scalar cos (fresnel.h:50-56)."""
    return Vec3(
        conductor_reflectance(eta.x, k.x, cos_theta_i),
        conductor_reflectance(eta.y, k.y, cos_theta_i),
        conductor_reflectance(eta.z, k.z, cos_theta_i),
    )


def diffuse_reflectance(eta):
    """Hemispherical diffuse Fresnel fit (fresnel.h:58-85), in the
    reference's float32 arithmetic: true divisions (``c / eta`` in torch
    is a reciprocal and a product) and its integer powers' products."""
    low = -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + torch.full_like(eta, 0.0636) / eta
    ie = 1.0 / eta
    ie2 = ie * ie
    ie4 = ie2 * ie2
    high = (
        0.919317
        - 3.4793 * ie
        + 6.75335 * ie2
        - 7.80989 * (ie * ie2)
        + 4.98554 * ie4
        - 1.36881 * (ie * ie4)
    )
    return torch.where(eta < 1.0, low, high)
