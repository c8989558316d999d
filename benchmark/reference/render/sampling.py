"""Device sampling / frame / misc helpers on the Vec3 plane layout.

Mirrors pupiloptixlab_tpu/render/sampling.py (optix/util.h parity):
uniform triangle/sphere/hemisphere and cosine-hemisphere sampling with
pdfs, Reflect/Refract, the Pixar ONB, sphere uv, luminance, the
balance-heuristic ``mis_weight(x, y) = x / (x + y)``, and the ACES tone
map and gamma encode that display/tonemap.py applies.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.render.vec import Vec2, Vec3

EPS = 1e-6
MAX_DISTANCE = 1e16
RAY_OFFSET = 1e-3  # reference t_min (main.cu:79)


def is_zero(v, eps: float = EPS):
    """abs-all-below-eps test (optix/util.h:169-180)."""
    if isinstance(v, Vec3):
        return v.max_abs() < eps
    return torch.abs(v) < eps


def mis_weight(x, y):
    """Balance heuristic (optix/util.h:165-167)."""
    return x / (x + y)


def luminance(c: Vec3):
    return 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z


# -- sampling ---------------------------------------------------------------

def uniform_sample_triangle(u1, u2) -> Vec3:
    """Barycentric factors for v0, v1, v2 (optix/util.h:33-37)."""
    s = torch.sqrt(u1)
    return Vec3(1.0 - s, s * (1.0 - u2), u2 * s)


def uniform_sample_sphere(u1, u2) -> Vec3:
    z = 1.0 - 2.0 * u1
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), z)


def cosine_sample_hemisphere(u1, u2) -> Vec3:
    sin_t = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), z)


def cosine_hemisphere_pdf(v: Vec3):
    return torch.where(v.z > 0.0, v.z / math.pi, 0.0)


def uniform_sample_hemisphere(u1, u2) -> Vec3:
    z = 1.0 - 2.0 * u1
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.abs(z))


def uniform_hemisphere_pdf(v: Vec3):
    return torch.where(v.z > 0.0, 0.5 / math.pi, 0.0)


# -- reflection / refraction (local frame, z-up) -----------------------------

def reflect_z(v: Vec3) -> Vec3:
    """Mirror about the z axis (optix/util.h:74-78)."""
    return Vec3(-v.x, -v.y, v.z)


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """Mirror ``v`` about normal ``n``; both point away from the surface."""
    d = 2.0 * v.dot(n)
    return Vec3(d * n.x - v.x, d * n.y - v.y, d * n.z - v.z)


def refract_z(v: Vec3, cos_theta_t, eta) -> Vec3:
    """Smooth refraction about z (optix/util.h:80-83)."""
    scale = -torch.where(cos_theta_t < 0.0, torch.reciprocal(eta), eta)
    return Vec3(scale * v.x, scale * v.y, cos_theta_t).normalized()


def refract(v: Vec3, n: Vec3, cos_theta_t, eta) -> Vec3:
    """Refraction about microfacet normal n (optix/util.h:85-88)."""
    eta = torch.where(cos_theta_t < 0.0, torch.reciprocal(eta), eta)
    k = v.dot(n) * eta + cos_theta_t
    return Vec3(n.x * k - v.x * eta, n.y * k - v.y * eta, n.z * k - v.z * eta)


# -- orthonormal basis (Pixar, optix/util.h:95-115) --------------------------

def build_onb(n: Vec3):
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -torch.reciprocal(sign + n.z)
    b = n.x * n.y * a
    b1 = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    b2 = Vec3(b, sign + n.y * n.y * a, -n.y)
    return b1, b2


def to_local(v: Vec3, n: Vec3) -> Vec3:
    b1, b2 = build_onb(n)
    return Vec3(v.dot(b1), v.dot(b2), v.dot(n))


def to_world(v: Vec3, n: Vec3) -> Vec3:
    b1, b2 = build_onb(n)
    return Vec3(
        b1.x * v.x + b2.x * v.y + n.x * v.z,
        b1.y * v.x + b2.y * v.y + n.y * v.z,
        b1.z * v.x + b2.z * v.y + n.z * v.z,
    )


# -- misc --------------------------------------------------------------------

def sphere_texcoord(local_p: Vec3) -> Vec2:
    """Unit-sphere uv (optix/util.h:117-128)."""
    phi = torch.atan2(local_p.y, local_p.x)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    theta = torch.acos(torch.clamp(local_p.z, -1.0, 1.0))
    return Vec2(phi * 0.5 / math.pi, theta / math.pi)


def aces_tonemap(color: torch.Tensor, adapted_lum: float = 1.0) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = color * adapted_lum
    return (x * (a * x + b)) / (x * (c * x + d) + e)


def gamma_correct(color: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return torch.pow(torch.clamp(color, min=0.0), 1.0 / gamma)
