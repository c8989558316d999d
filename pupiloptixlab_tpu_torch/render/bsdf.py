"""The seven BSDFs (plane layout).

Mirrors pupiloptixlab_tpu/render/bsdf.py (render/material/bsdf/*.h
parity). Local shading frame (z-up), ``wo`` toward the viewer, ``wi``
sampled/incident, ``f`` without the cosine. Sampling draws a fixed budget
of 3 uniforms per lane.

``evaluate`` and ``sample`` run their plain versions (``evaluate_plain``,
``sample_plain``: branchless dense-table dispatch, every type present in
``mat_types`` evaluated on all lanes and the lane's result selected by
``mtype``) for CPU tensors, and launch one kernel (csrc/bsdf.cu: K12
``bsdf_eval``, K13 ``bsdf_sample``) for CUDA tensors, where each lane runs
only its own type, with the same numbers bit for bit. Which type a lane
takes follows from ``mat_types`` alone (``_lane_rule``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel.gather import gather_cols
from pupiloptixlab_tpu_torch.flatten.types import (
    MAT_ANISO,
    MAT_DISPERSION,
    MAT_ETA,
    MAT_INT_FDR,
    MAT_NONLINEAR,
    MAT_SSW,
    MAT_TEX0,
    MAT_TWOSIDED,
    MAT_TYPE,
    SLOT_ALPHA,
    SLOT_ETA,
    SLOT_K,
    SLOT_REFLECTANCE,
    SLOT_SPECULAR,
    SLOT_TRANSMITTANCE,
    MaterialTable,
    TextureTable,
)
from pupiloptixlab_tpu_torch.render import fresnel, ggx
from pupiloptixlab_tpu_torch.render.sampling import (
    cosine_sample_hemisphere,
    reflect,
    reflect_z,
    refract,
    refract_z,
)
from pupiloptixlab_tpu_torch.render.texture import gather_texture, sample_texture_cols
from pupiloptixlab_tpu_torch.render.vec import Vec2, Vec3, where

# Material type ids (must match scene.materials.MatType).
DIFFUSE, DIELECTRIC, ROUGH_DIELECTRIC = 1, 2, 3
CONDUCTOR, ROUGH_CONDUCTOR, PLASTIC, ROUGH_PLASTIC = 4, 5, 6, 7
ALL_TYPES = (1, 2, 3, 4, 5, 6, 7)

# Lobe flags (bsdf/bsdf.h EBsdfLobeType).
LOBE_NONE = 0
LOBE_DIFFUSE_REFL = 1
LOBE_GLOSSY_REFL = 2
LOBE_DELTA_REFL = 4
LOBE_DIFFUSE_TRANS = 8
LOBE_GLOSSY_TRANS = 16
LOBE_DELTA_TRANS = 32
LOBE_DELTA = LOBE_DELTA_REFL | LOBE_DELTA_TRANS

_TINY = 1e-12


def _zeros3(like: torch.Tensor) -> Vec3:
    return Vec3.zeros(like.shape[0], device=like.device)


@dataclass
class LocalBsdf:
    """Per-lane shading params, textures sampled once at the hit uv
    (optix_material.h:95-107 GetLocalBsdf analog)."""

    mtype: torch.Tensor        # (N,) i32
    twosided: torch.Tensor     # (N,) bool
    reflectance: Vec3         # diffuse/plastic diffuse reflectance
    specular: Vec3
    transmittance: Vec3
    eta3: Vec3                # conductor eta
    k3: Vec3                  # conductor k
    alpha: torch.Tensor        # (N,) GGX alpha (alpha_u when anisotropic)
    alpha_v: torch.Tensor      # (N,) GGX alpha_v (== alpha when isotropic)
    eta: torch.Tensor          # (N,) scalar ior ratio
    int_fdr: torch.Tensor      # (N,)
    ssw: torch.Tensor          # (N,)
    nonlinear: torch.Tensor    # (N,) bool
    dispersion: torch.Tensor   # (N,) Cauchy B (um^2); spectral mode only


def get_local_bsdf(
    materials: MaterialTable,
    textures: TextureTable,
    mat_id: torch.Tensor,
    uv: Vec2,
    mat_types: tuple[int, ...] = ALL_TYPES,
    tex_kinds: tuple[int, ...] = (0, 1, 2),
    tex_filters: tuple[int, ...] = (0, 1),
) -> LocalBsdf:
    # one gather for all params: columns 0..MAT_DISPERSION, all it reads
    mcol = gather_cols(materials.packed, mat_id, cols=tuple(range(MAT_DISPERSION + 1)))
    zeros3 = _zeros3(mcol[0])

    def slot(idx, needed_by):
        if any(t in mat_types for t in needed_by):
            tex_id = mcol[MAT_TEX0 + idx].to(torch.int32)
            cols = gather_texture(textures, tex_id, tex_kinds, tex_filters)
            return sample_texture_cols(
                cols, textures.pool, uv, tex_kinds, tex_filters,
                textures.pool_bi,
            )
        return zeros3

    need_alpha = (ROUGH_DIELECTRIC, ROUGH_CONDUCTOR, ROUGH_PLASTIC)
    if any(t in mat_types for t in need_alpha):
        a_tex = slot(SLOT_ALPHA, need_alpha)
        alpha_u = a_tex.x
        # anisotropic materials carry (alpha_u, alpha_v) in the alpha
        # texture's r/g; isotropic alpha textures read r for both
        alpha_v = torch.where(mcol[MAT_ANISO] > 0.5, a_tex.y, a_tex.x)
    else:
        alpha_u = torch.zeros_like(mcol[0])
        alpha_v = alpha_u
    return LocalBsdf(
        mtype=mcol[MAT_TYPE].to(torch.int32),
        twosided=mcol[MAT_TWOSIDED] > 0.5,
        reflectance=slot(SLOT_REFLECTANCE, (DIFFUSE, PLASTIC, ROUGH_PLASTIC)),
        specular=slot(SLOT_SPECULAR, ALL_TYPES),
        transmittance=slot(SLOT_TRANSMITTANCE, (DIELECTRIC, ROUGH_DIELECTRIC)),
        eta3=slot(SLOT_ETA, (CONDUCTOR, ROUGH_CONDUCTOR)),
        k3=slot(SLOT_K, (CONDUCTOR, ROUGH_CONDUCTOR)),
        alpha=alpha_u,
        alpha_v=alpha_v,
        eta=mcol[MAT_ETA],
        int_fdr=mcol[MAT_INT_FDR],
        ssw=mcol[MAT_SSW],
        nonlinear=mcol[MAT_NONLINEAR] > 0.5,
        dispersion=mcol[MAT_DISPERSION],
    )


def albedo(b: LocalBsdf) -> Vec3:
    """AOV albedo (optix_material.h:69-87)."""
    use_spec = (
        (b.mtype == DIELECTRIC)
        | (b.mtype == ROUGH_DIELECTRIC)
        | (b.mtype == CONDUCTOR)
        | (b.mtype == ROUGH_CONDUCTOR)
    )
    return where(use_spec, b.specular, b.reflectance)


def _safe_div(a, d):
    return a / torch.where(torch.abs(d) < _TINY, torch.where(d < 0, -_TINY, _TINY), d)


def _cos_pdf(wi_z):
    return torch.where(wi_z > 0.0, wi_z / math.pi, 0.0)


def _spec_prob(b: LocalBsdf, f_o):
    """Plastic lobe-selection probability (plastic.h:47-51)."""
    num = f_o * b.ssw
    den = num + (1.0 - f_o) * (1.0 - b.ssw)
    return _safe_div(num, torch.clamp(den, min=_TINY))


def _plastic_diff(b: LocalBsdf, f_i, f_o, wi_z) -> Vec3:
    """Plastic diffuse term with internal-scattering compensation
    (plastic.h:38-39); includes the cosine-pdf/wi.z = 1/pi factor."""
    denom = (1.0 - b.int_fdr)
    diff_lin = b.reflectance * (1.0 / torch.clamp(denom, min=_TINY))
    denom_nl = Vec3(
        torch.clamp(1.0 - b.reflectance.x * b.int_fdr, min=_TINY),
        torch.clamp(1.0 - b.reflectance.y * b.int_fdr, min=_TINY),
        torch.clamp(1.0 - b.reflectance.z * b.int_fdr, min=_TINY),
    )
    diff_nl = b.reflectance / denom_nl
    diff = where(b.nonlinear, diff_nl, diff_lin)
    scale = (1.0 - f_i) * (1.0 - f_o) * _cos_pdf(wi_z) / (
        torch.clamp(b.eta, min=_TINY) ** 2 * torch.clamp(wi_z, min=_TINY)
    )
    return diff * scale


# ---------------------------------------------------------------------------
# per-type eval: f(wo, wi) and pdf(wo, wi) — GetBsdf + GetPdf
# ---------------------------------------------------------------------------

def _eval_diffuse(b, wo: Vec3, wi: Vec3):
    upper = (wi.z > 0.0) & (wo.z > 0.0)
    f = where(upper, b.reflectance * (1.0 / math.pi), _zeros3(wi.z))
    pdf = torch.where(upper, _cos_pdf(wi.z), 0.0)
    return f, pdf


def _eval_rough_conductor(b, wo: Vec3, wi: Vec3):
    """rough_conductor.h:20-38."""
    upper = (wi.z > 0.0) & (wo.z > 0.0)
    wh = (wi + wo).normalized()
    fr = fresnel.conductor_reflectance_rgb(b.eta3, b.k3, wo.dot(wh))
    scale = ggx.d(wh, b.alpha, b.alpha_v) * ggx.g(wi, wo, b.alpha, b.alpha_v) / torch.clamp(
        4.0 * wi.z * wo.z, min=_TINY)
    f = b.specular * fr * scale
    pdf = ggx.pdf(wo, wh, b.alpha, b.alpha_v) / torch.clamp(4.0 * wo.dot(wh), min=_TINY)
    zero = _zeros3(wi.z)
    return where(upper, f, zero), torch.where(upper, pdf, 0.0)


def _eval_plastic(b, wo: Vec3, wi: Vec3):
    """plastic.h:32-54."""
    upper = (wi.z > 0.0) & (wo.z > 0.0)
    f_o, _ = fresnel.dielectric_reflectance(b.eta, wo.z)
    f_i, _ = fresnel.dielectric_reflectance(b.eta, wi.z)
    f = where(upper, _plastic_diff(b, f_i, f_o, wi.z), _zeros3(wi.z))
    sp = _spec_prob(b, f_o)
    pdf = torch.where(upper, _cos_pdf(wi.z) * (1.0 - sp), 0.0)
    return f, pdf


def _eval_rough_plastic(b, wo: Vec3, wi: Vec3):
    """rough_plastic.h:30-61."""
    upper = (wi.z > 0.0) & (wo.z > 0.0)
    f_o, _ = fresnel.dielectric_reflectance(b.eta, wo.z)
    f_i, _ = fresnel.dielectric_reflectance(b.eta, wi.z)
    wh = (wi + wo).normalized()
    fr = fresnel.dielectric_reflectance(b.eta, wh.dot(wo))[0]
    spec_scale = fr * ggx.d(wh, b.alpha, b.alpha_v) * ggx.g(wi, wo, b.alpha, b.alpha_v) / torch.clamp(
        4.0 * wo.z * wi.z, min=_TINY)
    spec = b.specular * spec_scale
    denom_nl = Vec3(
        torch.clamp(1.0 - b.reflectance.x * b.int_fdr, min=_TINY),
        torch.clamp(1.0 - b.reflectance.y * b.int_fdr, min=_TINY),
        torch.clamp(1.0 - b.reflectance.z * b.int_fdr, min=_TINY),
    )
    diff_base = where(
        b.nonlinear,
        b.reflectance / denom_nl,
        b.reflectance * (1.0 / torch.clamp(1.0 - b.int_fdr, min=_TINY)),
    )
    diff = diff_base * (
        (1.0 - f_i) * (1.0 - f_o) / math.pi / torch.clamp(b.eta**2, min=_TINY)
    )
    f = where(upper, spec + diff, _zeros3(wi.z))
    sp = _spec_prob(b, f_o)
    pdf = sp * ggx.pdf(wo, wh, b.alpha, b.alpha_v) / torch.clamp(4.0 * wi.dot(wh), min=_TINY)
    pdf = pdf + (1.0 - sp) * _cos_pdf(wi.z)
    return f, torch.where(upper, pdf, 0.0)


def _rough_dielectric_wh(b, wo: Vec3, wi: Vec3):
    reflect_side = wo.z * wi.z > 0.0
    eta_w = torch.where(wo.z > 0.0, b.eta, 1.0 / torch.clamp(b.eta, min=_TINY))
    wh = where(reflect_side, wo + wi, wo + wi * eta_w).normalized()
    sign = torch.where(wh.z > 0.0, 1.0, -1.0)
    return wh * sign, reflect_side, eta_w


def _eval_rough_dielectric(b, wo: Vec3, wi: Vec3):
    """rough_dielectric.h:21-72."""
    wh, reflect_side, eta_w = _rough_dielectric_wh(b, wo, wi)

    f_term, _ = fresnel.dielectric_reflectance(b.eta, wo.dot(wh))
    g_val = ggx.g(wi, wo, b.alpha, b.alpha_v)
    d_val = ggx.d(wh, b.alpha, b.alpha_v)

    refl_scale = f_term * g_val * d_val / torch.clamp(
        4.0 * torch.abs(wi.z) * torch.abs(wo.z), min=_TINY)
    f_reflect = b.specular * refl_scale

    idoth = wi.dot(wh)
    odoth = wo.dot(wh)
    sqrt_denom = odoth + eta_w * idoth
    denom = sqrt_denom**2 * wi.z * wo.z
    denom = torch.where(torch.abs(denom) < _TINY, _TINY, denom)
    trans_scale = torch.abs((1.0 - f_term) * d_val * g_val * idoth * odoth / denom)
    f_transmit = b.transmittance * trans_scale

    f = where(reflect_side, f_reflect, f_transmit)
    f = where(torch.abs(wo.z) < 1e-6, _zeros3(wo.z), f)

    dwh_dwo_r = 1.0 / torch.where(torch.abs(4.0 * idoth) < _TINY, _TINY, 4.0 * idoth)
    dwh_dwo_t = (eta_w**2 * idoth) / torch.where(
        sqrt_denom**2 < _TINY, _TINY, sqrt_denom**2
    )
    dwh_dwo = torch.where(reflect_side, dwh_dwo_r, dwh_dwo_t)
    wo_up = wo * torch.where(wo.z > 0.0, 1.0, -1.0)
    pdf = torch.abs(
        ggx.pdf(wo_up, wh, b.alpha, b.alpha_v)
        * torch.where(reflect_side, f_term, 1.0 - f_term)
        * dwh_dwo
    )
    return f, pdf


_EVAL_FNS = {
    DIFFUSE: _eval_diffuse,
    ROUGH_CONDUCTOR: _eval_rough_conductor,
    ROUGH_DIELECTRIC: _eval_rough_dielectric,
    PLASTIC: _eval_plastic,
    ROUGH_PLASTIC: _eval_rough_plastic,
    # conductor / dielectric: delta lobes -> f = 0, pdf = 0 (no entry)
}


def evaluate_plain(b: LocalBsdf, wo: Vec3, wi: Vec3, mat_types: tuple[int, ...] = ALL_TYPES):
    """Plain version of K12 ``bsdf_eval``: (f Vec3, pdf (N,)). Delta
    materials return zeros."""
    f = _zeros3(wo.z)
    pdf = torch.zeros_like(wo.z)
    present = [t for t in mat_types if t in _EVAL_FNS]
    if len(present) == 1 and len(mat_types) == 1:
        return _EVAL_FNS[present[0]](b, wo, wi)
    for t in present:
        ft, pt = _EVAL_FNS[t](b, wo, wi)
        sel = b.mtype == t
        f = where(sel, ft, f)
        pdf = torch.where(sel, pt, pdf)
    return f, pdf


# ---------------------------------------------------------------------------
# per-type sample: (wi, f, pdf, lobe) from 3 uniforms
# ---------------------------------------------------------------------------

def _sample_diffuse(b, wo, u_lobe, u1, u2):
    wi = cosine_sample_hemisphere(u1, u2)
    f, pdf = _eval_diffuse(b, wo, wi)
    lobe = torch.full_like(wo.z, LOBE_DIFFUSE_REFL, dtype=torch.int32)
    return wi, f, pdf, lobe


def _sample_conductor(b, wo, u_lobe, u1, u2):
    """conductor.h:27-35 (perfect mirror, delta)."""
    wi = reflect_z(wo)
    fr = fresnel.conductor_reflectance_rgb(b.eta3, b.k3, wo.z)
    f = b.specular * fr * (1.0 / torch.clamp(torch.abs(wi.z), min=_TINY))
    pdf = torch.ones_like(wo.z)
    lobe = torch.full_like(wo.z, LOBE_DELTA_REFL, dtype=torch.int32)
    return wi, f, pdf, lobe


def _sample_dielectric(b, wo, u_lobe, u1, u2):
    """dielectric.h:28-44 (smooth glass, Fresnel lobe choice)."""
    f_term, cos_t = fresnel.dielectric_reflectance(b.eta, wo.z)
    take_refl = u_lobe < f_term
    wi = where(take_refl, reflect_z(wo), refract_z(wo, cos_t, b.eta))
    factor = torch.where(cos_t < 0.0, 1.0 / torch.clamp(b.eta, min=_TINY), b.eta)
    inv_wiz = 1.0 / torch.clamp(torch.abs(wi.z), min=_TINY)
    f = where(
        take_refl,
        b.specular * (f_term * inv_wiz),
        b.transmittance * ((1.0 - f_term) * factor * factor * inv_wiz),
    )
    pdf = torch.where(take_refl, f_term, 1.0 - f_term)
    lobe = torch.where(take_refl, LOBE_DELTA_REFL, LOBE_DELTA_TRANS).to(torch.int32)
    return wi, f, pdf, lobe


def _sample_rough_conductor(b, wo, u_lobe, u1, u2):
    wh = ggx.sample(wo, b.alpha, u1, u2, b.alpha_v)
    wi = reflect(wo, wh)
    f, pdf = _eval_rough_conductor(b, wo, wi)
    lobe = torch.full_like(wo.z, LOBE_GLOSSY_REFL, dtype=torch.int32)
    return wi, f, pdf, lobe


def _sample_rough_dielectric(b, wo, u_lobe, u1, u2):
    """rough_dielectric.h:74-97."""
    wo_up = wo * torch.where(wo.z > 0.0, 1.0, -1.0)
    wh = ggx.sample(wo_up, b.alpha, u1, u2, b.alpha_v)
    f_term, cos_t = fresnel.dielectric_reflectance(b.eta, wo.dot(wh))
    take_refl = u_lobe < f_term
    wi = where(take_refl, reflect(wo, wh), refract(wo, wh, cos_t, b.eta))
    valid = take_refl | ((torch.abs(cos_t) > 1e-6) & (wi.z * wo.z < 0.0))
    f, pdf = _eval_rough_dielectric(b, wo, wi)
    f = where(valid, f, _zeros3(wo.z))
    pdf = torch.where(valid, pdf, 0.0)
    lobe = torch.where(take_refl, LOBE_GLOSSY_REFL, LOBE_GLOSSY_TRANS).to(torch.int32)
    return wi, f, pdf, lobe


def _sample_plastic(b, wo, u_lobe, u1, u2):
    """plastic.h:56-85."""
    f_o, _ = fresnel.dielectric_reflectance(b.eta, wo.z)
    sp = _spec_prob(b, f_o)
    take_spec = u_lobe < sp
    wi = where(take_spec, reflect_z(wo), cosine_sample_hemisphere(u1, u2))
    f_i, _ = fresnel.dielectric_reflectance(b.eta, wi.z)
    f_spec = b.specular * (f_o / torch.clamp(wi.z, min=_TINY))
    f_diff = _plastic_diff(b, f_i, f_o, wi.z)
    f = where(take_spec, f_spec, f_diff)
    pdf = torch.where(take_spec, sp, _cos_pdf(wi.z) * (1.0 - sp))
    invalid = wo.z <= 0.0
    f = where(invalid, _zeros3(wo.z), f)
    pdf = torch.where(invalid, 0.0, pdf)
    lobe = torch.where(take_spec, LOBE_DELTA_REFL, LOBE_DIFFUSE_REFL).to(torch.int32)
    return wi, f, pdf, lobe


def _sample_rough_plastic(b, wo, u_lobe, u1, u2):
    """rough_plastic.h:63-86."""
    f_o, _ = fresnel.dielectric_reflectance(b.eta, wo.z)
    sp = _spec_prob(b, f_o)
    take_spec = u_lobe < sp
    wh = ggx.sample(wo, b.alpha, u1, u2, b.alpha_v)
    wi = where(take_spec, reflect(wo, wh), cosine_sample_hemisphere(u1, u2))
    f, pdf = _eval_rough_plastic(b, wo, wi)
    invalid = wo.z <= 0.0
    f = where(invalid, _zeros3(wo.z), f)
    pdf = torch.where(invalid, 0.0, pdf)
    lobe = torch.where(take_spec, LOBE_GLOSSY_REFL, LOBE_DIFFUSE_REFL).to(torch.int32)
    return wi, f, pdf, lobe


_SAMPLE_FNS = {
    DIFFUSE: _sample_diffuse,
    CONDUCTOR: _sample_conductor,
    DIELECTRIC: _sample_dielectric,
    ROUGH_CONDUCTOR: _sample_rough_conductor,
    ROUGH_DIELECTRIC: _sample_rough_dielectric,
    PLASTIC: _sample_plastic,
    ROUGH_PLASTIC: _sample_rough_plastic,
}


def sample_plain(
    b: LocalBsdf, wo: Vec3, u_lobe, u1, u2, mat_types: tuple[int, ...] = ALL_TYPES
):
    """Plain version of K13 ``bsdf_sample``: (wi Vec3, f Vec3, pdf (N,),
    lobe (N,) i32)."""
    present = [t for t in mat_types if t in _SAMPLE_FNS]
    if len(present) == 1:
        return _SAMPLE_FNS[present[0]](b, wo, u_lobe, u1, u2)
    wi = _zeros3(wo.z)
    f = _zeros3(wo.z)
    pdf = torch.zeros_like(wo.z)
    lobe = torch.zeros_like(wo.z, dtype=torch.int32)
    for t in present:
        wit, ft, pt, lt = _SAMPLE_FNS[t](b, wo, u_lobe, u1, u2)
        sel = b.mtype == t
        wi = where(sel, wit, wi)
        f = where(sel, ft, f)
        pdf = torch.where(sel, pt, pdf)
        lobe = torch.where(sel, lt, lobe)
    return wi, f, pdf, lobe


# ---------------------------------------------------------------------------
# K12 / K13: one kernel a call on the card
# ---------------------------------------------------------------------------

_rules: dict = {}  # (kind, mat_types) -> (force, mask)


def _lane_rule(kind: str, mat_types) -> tuple[int, int]:
    """(force, mask) of the plain version's selection, ``kind`` "eval" or
    "sample": with one type present (for "eval": exactly one type in
    ``mat_types``, and that type having an eval), every lane takes it
    (force) whatever its ``mtype``; otherwise (force 0) a lane takes its
    ``mtype`` when bit ``mtype`` of mask is set (the type is present and,
    for "eval", not a delta type) and zeros when not."""
    key = (kind, tuple(mat_types))
    rule = _rules.get(key)
    if rule is None:
        present = [t for t in mat_types if t in (_EVAL_FNS if kind == "eval" else _SAMPLE_FNS)]
        one = len(present) == 1 and (kind == "sample" or len(mat_types) == 1)
        rule = _rules[key] = (present[0] if one else 0, sum(1 << t for t in set(present)))
    return rule


def _launch_planes(name: str, b: LocalBsdf, lane_planes: tuple) -> tuple[list, list, int, int]:
    """The launcher's 28 planes (LocalBsdf's, then ``lane_planes``), each
    checked to be an (N,) tensor on one card of the dtype the kernel reads
    and made contiguous (a strided plane is copied): their data pointers,
    the tensors behind them (held until the launch is enqueued), N and the
    device index."""
    planes = (b.mtype, b.nonlinear, *b.reflectance, *b.specular, *b.transmittance,
              *b.eta3, *b.k3, b.alpha, b.alpha_v, b.eta, b.int_fdr, b.ssw, *lane_planes)
    ref = lane_planes[0]
    if ref.dim() != 1:
        raise ValueError(f"{name}: lanes must be (N,) planes, got {tuple(ref.shape)}")
    n, dev = ref.shape[0], ref.get_device()
    ptrs, held = [], []
    for k, p in enumerate(planes):
        want = torch.int32 if k == 0 else (torch.bool if k == 1 else torch.float32)
        if p.dtype is not want or p.get_device() != dev or p.shape != ref.shape:
            raise ValueError(f"{name}: plane {k} must be {want} ({n},) on {ref.device}, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")
        if not p.is_contiguous():
            p = p.contiguous()
        held.append(p)
        ptrs.append(p.data_ptr())
    return ptrs, held, n, dev


def evaluate(b: LocalBsdf, wo: Vec3, wi: Vec3, mat_types: tuple[int, ...] = ALL_TYPES):
    """Returns (f Vec3, pdf (N,)). Delta materials return zeros. The plain
    version for CPU tensors, one K12 launch for CUDA tensors."""
    if not wo.z.is_cuda:
        return evaluate_plain(b, wo, wi, mat_types)
    force, mask = _lane_rule("eval", mat_types)
    ptrs, _held, n, dev = _launch_planes("bsdf_eval", b, (*wo, *wi))
    out = torch.empty((4, n), dtype=torch.float32, device=wo.z.device)
    fn = kernels.launcher("bsdf_eval")
    kernels.LAUNCHES["bsdf_eval"] += 1
    rc = fn(*ptrs, n, force, mask, out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "bsdf_eval")
    return Vec3(out[0], out[1], out[2]), out[3]


def sample(
    b: LocalBsdf, wo: Vec3, u_lobe, u1, u2, mat_types: tuple[int, ...] = ALL_TYPES
):
    """Returns (wi Vec3, f Vec3, pdf (N,), lobe (N,) i32). The plain version
    for CPU tensors, one K13 launch for CUDA tensors."""
    if not wo.z.is_cuda:
        return sample_plain(b, wo, u_lobe, u1, u2, mat_types)
    force, mask = _lane_rule("sample", mat_types)
    ptrs, _held, n, dev = _launch_planes("bsdf_sample", b, (*wo, u_lobe, u1, u2))
    out = torch.empty((7, n), dtype=torch.float32, device=wo.z.device)
    lobe = torch.empty(n, dtype=torch.int32, device=wo.z.device)
    fn = kernels.launcher("bsdf_sample")
    kernels.LAUNCHES["bsdf_sample"] += 1
    rc = fn(*ptrs, n, force, mask, out.data_ptr(), lobe.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "bsdf_sample")
    return Vec3(out[0], out[1], out[2]), Vec3(out[3], out[4], out[5]), out[6], lobe
