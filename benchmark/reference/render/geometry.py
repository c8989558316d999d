"""Hit-point local geometry reconstruction (plane layout).

Mirrors pupiloptixlab_tpu/render/geometry.py (GetHitLocalGeometry
parity): barycentric normal/uv for triangles from one packed-attribute
gather (with barycentrics recomputed by one Moller-Trumbore re-test of
the winning triangle), analytic normals for spheres and round curves,
and the twosided flip toward the viewer. Instanced tables hold
object-space rows: the ray goes into the hit instance's space for the
barycentrics, and the normal matrix, material and emitter base come from
the instance's row (two more K3 gathers, of ``inst_w2o`` and
``inst_packed``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference.accel.gather import gather_cols
from benchmark.reference.accel.intersect import Hit, _mt_planes
from benchmark.reference.flatten.types import (
    CRV_MAT,
    CRV_P0,
    CRV_P1,
    CRV_R0,
    CRV_R1,
    CRV_UV0,
    CRV_UV1,
    INST_EMIT_BASE,
    INST_MAT,
    INST_W2O0,
    MAT_TWOSIDED,
    SPH_EMITTER,
    SPH_FLIP,
    SPH_MAT,
    TRI_E1,
    TRI_E2,
    TRI_EMITTER,
    TRI_MAT,
    TRI_N0,
    TRI_N1,
    TRI_N2,
    TRI_P0,
    TRI_UV0,
    TRI_UV1,
    TRI_UV2,
    SceneData,
)
from benchmark.reference.render.sampling import sphere_texcoord
from benchmark.reference.render.vec import Vec2, Vec3, where, where2


@dataclass
class LocalGeometry:
    position: Vec3
    normal: Vec3              # shading normal (twosided-flipped)
    uv: Vec2
    mat_id: torch.Tensor      # (N,) i32
    emitter_id: torch.Tensor  # (N,) i32 (-1 when not emissive)
    front: torch.Tensor       # (N,) bool: the UNFLIPPED normal faces the ray
    # (emission is one-sided on the stored normal; the twosided flip
    # applies to the BSDF only)


def get_local_geometry(
    scene: SceneData,
    hit: Hit,
    ro: Vec3,
    rd: Vec3,
    sphere_count: int = -1,
    instanced: bool = False,
    curve_count: int = 0,
) -> LocalGeometry:
    """``sphere_count`` skips the sphere branch when 0 (-1: unknown).
    ``instanced``: the attrs table holds unique OBJECT-space rows — normals
    transform by the hit instance's normal matrix, material and emitter ids
    come from the per-instance row (flatten/instanced.py)."""
    spheres = scene.spheres
    prim = hit.prim
    is_sphere = hit.kind == 1

    position = ro + rd * hit.t

    # triangles: one packed gather for normals/uv/ids + the p0/e1/e2
    # mirror columns
    a = gather_cols(scene.tris.attrs, prim)  # (C, N)

    def vec(s: slice) -> Vec3:
        return Vec3(a[s.start], a[s.start + 1], a[s.start + 2])

    # instanced rows are in object space: transform the ray first
    # (barycentrics are affine-invariant)
    ro_b, rd_b = ro, rd
    if instanced:
        w = gather_cols(scene.tris.inst_w2o, hit.inst)  # (12, N)
        ro_b = Vec3(
            w[0] * ro.x + w[1] * ro.y + w[2] * ro.z + w[3],
            w[4] * ro.x + w[5] * ro.y + w[6] * ro.z + w[7],
            w[8] * ro.x + w[9] * ro.y + w[10] * ro.z + w[11],
        )
        rd_b = Vec3(
            w[0] * rd.x + w[1] * rd.y + w[2] * rd.z,
            w[4] * rd.x + w[5] * rd.y + w[6] * rd.z,
            w[8] * rd.x + w[9] * rd.y + w[10] * rd.z,
        )
    _, _, bu, bv = _mt_planes(ro_b, rd_b, vec(TRI_P0), vec(TRI_E1), vec(TRI_E2))
    is_tri = hit.kind == 0
    bu = torch.where(is_tri, bu, 0.0)
    bv = torch.where(is_tri, bv, 0.0)
    w0 = 1.0 - bu - bv
    w1 = bu
    w2 = bv

    nrm_tri = vec(TRI_N0) * w0 + vec(TRI_N1) * w1 + vec(TRI_N2) * w2
    uv_tri = Vec2(
        a[TRI_UV0.start] * w0 + a[TRI_UV1.start] * w1 + a[TRI_UV2.start] * w2,
        a[TRI_UV0.start + 1] * w0 + a[TRI_UV1.start + 1] * w1 + a[TRI_UV2.start + 1] * w2,
    )
    if instanced:
        ic = gather_cols(scene.tris.inst_packed, hit.inst,
                         cols=tuple(range(INST_W2O0 + 1)))  # (12, N) of 16
        # object -> world normal: inverse-transpose 3x3 (flip folded in)
        nrm_tri = Vec3(
            ic[0] * nrm_tri.x + ic[1] * nrm_tri.y + ic[2] * nrm_tri.z,
            ic[3] * nrm_tri.x + ic[4] * nrm_tri.y + ic[5] * nrm_tri.z,
            ic[6] * nrm_tri.x + ic[7] * nrm_tri.y + ic[8] * nrm_tri.z,
        )
        mat_tri = ic[INST_MAT].to(torch.int32)
        emit_base = ic[INST_EMIT_BASE].to(torch.int32)
        f_orig = a[TRI_EMITTER].to(torch.int32)
        emit_tri = torch.where((emit_base >= 0) & (f_orig >= 0), emit_base + f_orig, -1)
        uv_tri = Vec2(uv_tri.x, torch.where(ic[INST_W2O0] > 0.5, 1.0 - uv_tri.y, uv_tri.y))
    else:
        mat_tri = a[TRI_MAT].to(torch.int32)
        emit_tri = a[TRI_EMITTER].to(torch.int32)
    nrm_tri = nrm_tri.normalized()

    if sphere_count != 0:
        # spheres (geometry.h:82-89): one packed-column gather of the
        # flattened w2o rows + ids
        sp = torch.clamp(prim, max=spheres.attrs.shape[0] - 1)
        c = gather_cols(spheres.attrs, sp, cols=tuple(range(SPH_FLIP + 1)))  # (15, N) of 16

        def w2o_apply(i):
            return (
                c[i * 4 + 0] * position.x
                + c[i * 4 + 1] * position.y
                + c[i * 4 + 2] * position.z
                + c[i * 4 + 3]
            )

        local = Vec3(w2o_apply(0), w2o_apply(1), w2o_apply(2))
        # normal transforms by (w2o)^T of the local point
        nrm_sph = Vec3(
            c[0] * local.x + c[4] * local.y + c[8] * local.z,
            c[1] * local.x + c[5] * local.y + c[9] * local.z,
            c[2] * local.x + c[6] * local.y + c[10] * local.z,
        ).normalized()
        nrm_sph = where(c[SPH_FLIP] > 0.5, -nrm_sph, nrm_sph)
        uv_sph = sphere_texcoord(local.normalized())
        normal = where(is_sphere, nrm_sph, nrm_tri)
        uv = where2(is_sphere, uv_sph, uv_tri)
        mat_id = torch.where(is_sphere, c[SPH_MAT].to(torch.int32), mat_tri)
        emitter_id = torch.where(is_sphere, c[SPH_EMITTER].to(torch.int32), emit_tri)
    else:
        normal, uv, mat_id, emitter_id = nrm_tri, uv_tri, mat_tri, emit_tri

    if curve_count != 0:
        # round-curve hits (kind 2): rounded-cone normal from the hit
        # position (cone flank when 0 < y < d2, the sphere caps otherwise)
        is_curve = hit.kind == 2
        cp = torch.clamp(prim, max=scene.curves.packed.shape[0] - 1)
        cc = gather_cols(scene.curves.packed, cp, cols=tuple(range(CRV_UV1 + 1)))  # (11, N) of 12
        pa_ = Vec3(cc[CRV_P0.start], cc[CRV_P0.start + 1], cc[CRV_P0.start + 2])
        pb_ = Vec3(cc[CRV_P1.start], cc[CRV_P1.start + 1], cc[CRV_P1.start + 2])
        ra, rb = cc[CRV_R0], cc[CRV_R1]
        ba = pb_ - pa_
        pa = position - pa_
        rr = ra - rb
        m0 = ba.dot(ba)
        d2 = torch.clamp(m0 - rr * rr, min=1e-12)
        y = ba.dot(pa) - ra * rr
        n_cone = (pa * d2 - ba * y).normalized()
        n_a = pa * torch.reciprocal(torch.clamp(ra, min=1e-9))
        n_b = (position - pb_) * torch.reciprocal(torch.clamp(rb, min=1e-9))
        nrm_crv = where(y <= 0.0, n_a, where(y >= d2, n_b, n_cone))
        s = torch.clamp(y / d2, 0.0, 1.0)
        uv_crv = Vec2(
            cc[CRV_UV0] + s * (cc[CRV_UV1] - cc[CRV_UV0]),
            torch.full_like(s, 0.5),
        )
        normal = where(is_curve, nrm_crv.normalized(), normal)
        uv = where2(is_curve, uv_crv, uv)
        mat_id = torch.where(is_curve, cc[CRV_MAT].to(torch.int32), mat_id)
        emitter_id = torch.where(is_curve, -1, emitter_id)

    mat_id = torch.where(hit.hit_mask, mat_id, 0)
    emitter_id = torch.where(hit.hit_mask, emitter_id, -1)

    # twosided flip toward viewer (geometry.h:91-95)
    front = (-rd).dot(normal) >= 0.0
    twosided = gather_cols(scene.materials.packed, mat_id, cols=(MAT_TWOSIDED,))[0] > 0.5
    normal = where(~front & twosided, -normal, normal)

    return LocalGeometry(
        position=position,
        normal=normal,
        uv=uv,
        mat_id=mat_id,
        emitter_id=emitter_id,
        front=front,
    )
