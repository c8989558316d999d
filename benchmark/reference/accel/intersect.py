"""Ray/scene intersection: triangles, unit spheres, round curves.

Copied from the port's accel/intersect.py with every triangle query sent
to the brute-force sweep of accel/sweep.py (every ray against every row,
ties to the lowest row), where the port takes its BVH or chunk-sweep
kernels; the sphere and curve tests are the port's own plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference.accel.sweep import brute_sweep
from benchmark.reference.flatten.types import (
    CRV_P0,
    CRV_P1,
    CRV_R0,
    CRV_R1,
    RenderConfig,
    SceneData,
)
from benchmark.reference.render.sampling import MAX_DISTANCE
from benchmark.reference.render.vec import Vec3

_DET_EPS = 1e-12


@dataclass
class Hit:
    t: torch.Tensor     # (N,) hit distance; MAX_DISTANCE on miss
    prim: torch.Tensor  # (N,) i32 primitive index (tri row or sphere)
    kind: torch.Tensor  # (N,) i32: 0 tri, 1 sphere, 2 curve, -1 miss
    inst: torch.Tensor  # (N,) i32 instance id (instanced scenes; 0 elsewhere)

    @property
    def hit_mask(self) -> torch.Tensor:
        return self.kind >= 0


def _mt_planes(ro: Vec3, rd: Vec3, p0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore on planes; broadcast-compatible shapes."""
    pvec = rd.cross(e2)
    det = e1.dot(pvec)
    inv = torch.reciprocal(torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det))
    tvec = ro - p0
    u = tvec.dot(pvec) * inv
    qvec = tvec.cross(e1)
    v = rd.dot(qvec) * inv
    t = e2.dot(qvec) * inv
    return det, t, u, v


def _tri_closest(ro: Vec3, rd: Vec3, tmin, tmax, scene: SceneData,
                 config: RenderConfig):
    """(t, prim, kind, inst) of the closest triangle hit."""
    planes = [p.contiguous() for p in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, tmin, tmax)]
    t, idx = brute_sweep(*planes, scene.tris.packed, any_hit=False)
    hit = idx >= 0
    return (
        torch.where(hit, t, MAX_DISTANCE),
        torch.where(hit, idx, 0),
        torch.where(hit, 0, -1).to(torch.int32),
        torch.zeros_like(idx),
    )


def _sphere_tests(ro: Vec3, rd: Vec3, scene: SceneData, tmin, tmax):
    """Analytic unit-sphere hits in each sphere's object frame; returns
    (t (S,N), hit (S,N)) in sphere-major layout."""
    w2o = scene.spheres.w2o  # (S,3,4)

    def xform(vx, vy, vz, translate):
        outs = []
        for i in range(3):
            o = (
                w2o[:, i, 0][:, None] * vx[None, :]
                + w2o[:, i, 1][:, None] * vy[None, :]
                + w2o[:, i, 2][:, None] * vz[None, :]
            )
            if translate:
                o = o + w2o[:, i, 3][:, None]
            outs.append(o)
        return outs

    ox, oy, oz = xform(ro.x, ro.y, ro.z, True)
    dx, dy, dz = xform(rd.x, rd.y, rd.z, False)
    a = dx * dx + dy * dy + dz * dz
    b = ox * dx + oy * dy + oz * dz
    c = ox * ox + oy * oy + oz * oz - 1.0
    disc = b * b - a * c
    valid = (disc >= 0.0) & (a > _DET_EPS)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = torch.reciprocal(torch.clamp(a, min=_DET_EPS))
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    in0 = (t0 > tmin[None, :]) & (t0 < tmax[None, :])
    in1 = (t1 > tmin[None, :]) & (t1 < tmax[None, :])
    t = torch.where(in0, t0, t1)
    hit = valid & (in0 | in1)
    return torch.where(hit, t, MAX_DISTANCE), hit


def _curve_tests(ro: Vec3, rd: Vec3, scene: SceneData, tmin, tmax):
    """Analytic rounded-cone hits for round-curve segments, curve-major
    (C, N) layout; rays must be unit-length. Returns (t, hit)."""
    rows = scene.curves.packed  # (C, 12)
    ax = rows[:, CRV_P0.start][:, None]
    ay = rows[:, CRV_P0.start + 1][:, None]
    az = rows[:, CRV_P0.start + 2][:, None]
    bx = rows[:, CRV_P1.start][:, None]
    by = rows[:, CRV_P1.start + 1][:, None]
    bz = rows[:, CRV_P1.start + 2][:, None]
    ra = rows[:, CRV_R0][:, None]
    rb = rows[:, CRV_R1][:, None]

    bax, bay, baz = bx - ax, by - ay, bz - az
    oax = ro.x[None, :] - ax
    oay = ro.y[None, :] - ay
    oaz = ro.z[None, :] - az
    obx = ro.x[None, :] - bx
    oby = ro.y[None, :] - by
    obz = ro.z[None, :] - bz
    dx, dy, dz = rd.x[None, :], rd.y[None, :], rd.z[None, :]

    rr = ra - rb
    m0 = bax * bax + bay * bay + baz * baz
    m1 = bax * oax + bay * oay + baz * oaz
    m2 = bax * dx + bay * dy + baz * dz
    m3 = dx * oax + dy * oay + dz * oaz
    m5 = oax * oax + oay * oay + oaz * oaz
    m6 = obx * dx + oby * dy + obz * dz
    m7 = obx * obx + oby * oby + obz * obz

    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * ra - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    k2s = torch.where(torch.abs(k2) < 1e-12, 1e-12, k2)
    t_cone = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / k2s
    y = m1 - ra * rr + t_cone * m2
    cone_ok = (h >= 0.0) & (y > 0.0) & (y < d2)

    h1 = m3 * m3 - m5 + ra * ra
    t_a = -m3 - torch.sqrt(torch.clamp(h1, min=0.0))
    h2 = m6 * m6 - m7 + rb * rb
    t_b = -m6 - torch.sqrt(torch.clamp(h2, min=0.0))

    big = MAX_DISTANCE
    degen = (ra <= 0.0) & (rb <= 0.0)  # hidden / padding rows never hit

    def in_rng(t):
        return (t > tmin[None, :]) & (t < tmax[None, :])

    tc = torch.where(cone_ok & in_rng(t_cone) & ~degen, t_cone, big)
    ta = torch.where((h1 >= 0.0) & in_rng(t_a) & (ra > 0.0), t_a, big)
    tb = torch.where((h2 >= 0.0) & in_rng(t_b) & (rb > 0.0), t_b, big)
    t = torch.minimum(tc, torch.minimum(ta, tb))
    return t, t < big


def intersect_closest(
    ro: Vec3,
    rd: Vec3,
    tmin: torch.Tensor,
    tmax: torch.Tensor,
    scene: SceneData,
    config: RenderConfig,
    mask: torch.Tensor | None = None,
) -> Hit:
    """``mask``: lanes whose result the caller will use. Culled lanes get
    an empty ray interval (tmax = -1): a guaranteed miss."""
    if mask is not None:
        tmax = torch.where(mask, tmax, -1.0)
    n = ro.x.shape[0]
    dev = ro.x.device
    best_t = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    best_prim = torch.zeros(n, dtype=torch.int32, device=dev)
    best_kind = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.zeros(n, dtype=torch.int32, device=dev)
    if config.tri_count > 0:
        best_t, best_prim, best_kind, best_inst = _tri_closest(
            ro, rd, tmin, tmax, scene, config)

    if config.sphere_count > 0:
        t_s, _ = _sphere_tests(ro, rd, scene, tmin, tmax)  # (S, N)
        tj, j = torch.min(t_s, dim=0)
        better = (tj < MAX_DISTANCE) & (tj < best_t)
        best_t = torch.where(better, tj, best_t)
        best_prim = torch.where(better, j.to(torch.int32), best_prim)
        best_kind = torch.where(better, 1, best_kind)
    if config.curve_count > 0:
        t_c, _ = _curve_tests(ro, rd, scene, tmin, tmax)  # (C, N)
        tj, j = torch.min(t_c, dim=0)
        better = (tj < MAX_DISTANCE) & (tj < best_t)
        best_t = torch.where(better, tj, best_t)
        best_prim = torch.where(better, j.to(torch.int32), best_prim)
        best_kind = torch.where(better, 2, best_kind)
    return Hit(t=best_t, prim=best_prim, kind=best_kind, inst=best_inst)


def intersect_any(
    ro: Vec3,
    rd: Vec3,
    tmin: torch.Tensor,
    tmax: torch.Tensor,
    scene: SceneData,
    config: RenderConfig,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Occlusion test (shadow rays): any hit in (tmin, tmax) -> True.
    Triangles go through the brute sweep, with the sphere and curve tests
    OR-ed in; a scene without triangles takes the closest-hit path."""
    if mask is not None:
        tmax = torch.where(mask, tmax, -1.0)
    if config.tri_count > 0:
        planes = [p.contiguous() for p in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, tmin, tmax)]
        _, idx = brute_sweep(*planes, scene.tris.packed, any_hit=True)
        occ = idx >= 0
        occluded = occ != 0
        if config.sphere_count > 0:
            _, hit_s = _sphere_tests(ro, rd, scene, tmin, tmax)
            occluded = occluded | torch.any(hit_s, dim=0)
        if config.curve_count > 0:
            _, hit_c = _curve_tests(ro, rd, scene, tmin, tmax)
            occluded = occluded | torch.any(hit_c, dim=0)
        return occluded
    return intersect_closest(ro, rd, tmin, tmax, scene, config).hit_mask
