"""GGX microfacet distribution: Smith masking, NDF, VNDF sampling.

Mirrors pupiloptixlab_tpu/render/ggx.py (render/material/ggx.h parity,
with the anisotropic alpha_u/alpha_v path). Vectors are Vec3 planes in
the local shading frame (z-up).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.render.vec import Vec3, where


def _axes(alpha, alpha_v):
    return alpha, (alpha if alpha_v is None else alpha_v)


def smith_lambda(w: Vec3, alpha, alpha_v=None):
    au, av = _axes(alpha, alpha_v)
    z2 = torch.clamp(w.z * w.z, min=1e-12)
    a2 = (w.x * w.x * au * au + w.y * w.y * av * av) / z2
    return (-1.0 + torch.sqrt(1.0 + a2)) / 2.0


def g1(w: Vec3, alpha, alpha_v=None):
    return torch.reciprocal(1.0 + smith_lambda(w, alpha, alpha_v))


def g(wi: Vec3, wo: Vec3, alpha, alpha_v=None):
    return g1(wi, alpha, alpha_v) * g1(wo, alpha, alpha_v)


def d(wh: Vec3, alpha, alpha_v=None):
    au, av = _axes(alpha, alpha_v)
    au2 = torch.clamp(au * au, min=1e-12)
    av2 = torch.clamp(av * av, min=1e-12)
    t = wh.x * wh.x / au2 + wh.y * wh.y / av2 + wh.z * wh.z
    return torch.reciprocal(
        torch.clamp(math.pi * torch.sqrt(au2 * av2) * t * t, min=1e-20)
    )


def pdf(wo: Vec3, wh: Vec3, alpha, alpha_v=None):
    """VNDF pdf: D * G1(wo) * (wo.wh) / |wo.z| (ggx.h:31-37)."""
    return d(wh, alpha, alpha_v) * g1(wo, alpha, alpha_v) * wo.dot(wh) / torch.clamp(
        torch.abs(wo.z), min=1e-12
    )


def sample(wo: Vec3, alpha, u1, u2, alpha_v=None) -> Vec3:
    """Heitz VNDF visible-normal sampling (ggx.h:39-57; anisotropic
    stretch per ggx.h:66-79)."""
    au, av = _axes(alpha, alpha_v)
    vh = Vec3(au * wo.x, av * wo.y, wo.z).normalized()
    lensq = vh.x * vh.x + vh.y * vh.y
    inv_len = torch.reciprocal(torch.sqrt(torch.clamp(lensq, min=1e-18)))
    # tangent frame around vh; degenerate when wo ~ +z
    ok = wo.z < 0.9999
    t1 = where(
        ok,
        Vec3(-vh.y * inv_len, vh.x * inv_len, torch.zeros_like(inv_len)),
        Vec3.full(inv_len.shape[0], 1.0, 0.0, 0.0, device=inv_len.device),
    )
    t2 = vh.cross(t1)

    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2

    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = Vec3(
        p1 * t1.x + p2 * t2.x + pz * vh.x,
        p1 * t1.y + p2 * t2.y + pz * vh.y,
        p1 * t1.z + p2 * t2.z + pz * vh.z,
    )
    return Vec3(au * nh.x, av * nh.y, torch.clamp(nh.z, min=0.0)).normalized()
