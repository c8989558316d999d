"""Progressive path tracer with NEE + balance-heuristic MIS (RGB).

Copied from the port's render/integrator.py (``render_sample``, its
bounce, the primary rays and the progressive blend), with the lanes given
by the caller as pixel ids (``pix``) instead of the whole film in the
port's lane order, the seed a Python int or an (N,) integer tensor (one
seed a lane), and the port's batch, tile and slab machinery left out.
Every lane carries an ``active`` mask instead of branching; the RNG is
keyed by pixel id, so any subset of pixels traces exactly as in the whole
film.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from benchmark.reference.accel.gather import gather_cols
from benchmark.reference.accel.intersect import intersect_any, intersect_closest
from benchmark.reference.flatten.types import (
    EM_RAD_TEX,
    CameraBlock,
    RenderConfig,
    SceneData,
)
from benchmark.reference.render import bsdf as bsdf_mod
from benchmark.reference.render import emitter as emitter_mod
from benchmark.reference.render import rng
from benchmark.reference.render import spectral as sp
from benchmark.reference.render.camera import generate_rays_for
from benchmark.reference.render.geometry import get_local_geometry
from benchmark.reference.render.sampling import (
    MAX_DISTANCE,
    RAY_OFFSET,
    is_zero,
    mis_weight,
    to_local,
    to_world,
)
from benchmark.reference.render.texture import gather_texture, sample_texture_cols
from benchmark.reference.render.vec import Vec3, where
from benchmark.reference.utils.debug import finite_report

_TINY = 1e-12


def primary_rays(camera: CameraBlock, config: RenderConfig, seed, pix: torch.Tensor):
    """The camera rays of the lanes ``pix`` (pixel ids) at ``seed`` (an int, or a 0-dim integer tensor on the
    lanes' device: ``rng.tea_init``): each pixel's stream starts at (pixel id, seed)
    and its first two draws jitter the ray. Returns the streams' state after
    those draws and the rays (ro, rd, tmin, tmax), tmin = RAY_OFFSET,
    tmax = MAX_DISTANCE: what ``render_sample`` traces first, and what the
    cost model (parallel/balance.py) walks."""
    n = pix.shape[0]
    state = rng.tea_init(pix, seed)
    state, (jx, jy) = rng.next_floats(state, 2)
    ro, rd = generate_rays_for(camera, config.width, config.height, pix, jx, jy)
    tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=pix.device)
    tmax = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=pix.device)
    return state, (ro, rd, tmin, tmax)


def _first_hit_emission(scene, config, geo) -> Vec3:
    """GetRadiance at the hit uv (main.cu:87-92)."""
    em, tex = scene.emitters, scene.textures
    rad_tex = gather_cols(em.packed, torch.clamp(geo.emitter_id, min=0), cols=(EM_RAD_TEX,))
    trow = gather_texture(tex, rad_tex[0].to(torch.int32), config.em_tex_kinds,
                          config.em_tex_filters)
    return sample_texture_cols(
        trow, tex.pool, geo.uv, config.em_tex_kinds, config.em_tex_filters,
        tex.pool_bi,
    )


def _f32(x: float) -> float:
    """A Python float rounded to float32, for constants the reference
    computes in float32."""
    return float(np.float32(x))


def _apply_dispersion(local, lams: sp.Spec4):
    """Spectral mode: Cauchy-shift the dielectric ior ratio to the hero
    wavelength (the path's geometry follows the hero)."""
    return dataclasses.replace(local, eta=sp.eta_at(local.eta, local.dispersion, lams.s0))


def _bounce(scene, config, n, carry, depth, lams=None):
    """One NEE + BSDF-bounce iteration (the body of main.cu:103-184).

    ``lams`` (spectral mode only): the path's Spec4 wavelengths. Radiance,
    throughput and the escape throughput are then Spec4 planes, every RGB
    quantity lifts through ``spectral.lift`` at its use site, and the carry
    ends with the ``mono`` mask (lanes collapsed to their hero after a
    dispersive transmission)."""
    spectral = lams is not None
    if spectral:
        (state, active, radiance, throughput, wo_world, geo, local, esc, mono) = carry
        lift = functools.partial(sp.lift, lams=lams)
    else:
        state, active, radiance, throughput, wo_world, geo, local, esc = carry
        lift = _identity
    em, tex = scene.emitters, scene.textures
    dev = state.device
    zero_l = sp.Spec4.zeros(n, device=dev) if spectral else Vec3.zeros(n, device=dev)

    state, us = rng.next_floats(state, 7)
    u_rr, u_sel, u_l1, u_l2, u_b0, u_b1, u_b2 = us

    # Russian roulette (main.cu:108-111)
    rr = 0.95 if depth > 2 else 1.0
    active = active & (u_rr <= rr)
    throughput = where(active, throughput * _f32(np.float32(1.0) / np.float32(rr)),
                       throughput)

    # --- next-event estimation (main.cu:113-141) ----------------------------
    idx, use_env = emitter_mod.select_emitter(em, config, u_sel)
    es = emitter_mod.sample_direct(
        em, tex, config, idx, use_env, geo.position, geo.normal, u_l1, u_l2,
    )
    wo_local = to_local(wo_world, geo.normal)
    wi_local = to_local(es.wi, geo.normal)
    f_nee, pdf_bsdf = bsdf_mod.evaluate(local, wo_local, wi_local, config.mat_types)
    nol = geo.normal.dot(es.wi)
    nonzero = ~is_zero(f_nee * es.pdf)
    # shadow rays only where the NEE contribution can be nonzero; culled
    # lanes get an empty interval and cost the traversal nothing
    shadow_mask = active & nonzero & (nol > 0.0)
    tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
    occluded = intersect_any(
        geo.position, es.wi, tmin, es.distance - RAY_OFFSET, scene, config,
        mask=shadow_mask,
    )
    # the NEE density includes the selection probability (the reference
    # package's deliberate deviation from main.cu:135-137)
    pdf_light = es.pdf * es.select_prob
    mis = torch.where(es.is_delta, 1.0, mis_weight(pdf_light, pdf_bsdf))
    scale = nol * mis / torch.clamp(pdf_light, min=_TINY)
    contrib = throughput * lift(es.radiance) * lift(f_nee) * scale
    take = shadow_mask & ~occluded
    radiance = radiance + where(take, contrib, zero_l)
    del es, contrib, occluded

    # --- BSDF sampling + bounce (main.cu:142-183) ----------------------------
    wi_s, f_s, pdf_s, lobe = bsdf_mod.sample(
        local, wo_local, u_b0, u_b1, u_b2, config.mat_types
    )
    cos_term = torch.abs(wi_s.z)
    bad = is_zero(f_s * cos_term) | is_zero(pdf_s)
    active = active & ~bad
    weight = lift(f_s) * (cos_term / torch.clamp(pdf_s, min=_TINY))
    throughput = where(active, throughput * weight, throughput)
    if spectral:
        # hero collapse (Wilkie et al. 2014): a transmission through a
        # dispersive dielectric bends each wavelength differently; the
        # secondary wavelengths terminate and the hero takes the 4x MIS
        # compensation, once a path
        newly = (active & (wi_s.z * wo_local.z < 0.0) & (local.dispersion > 0.0)
                 & ~mono)
        throughput = sp.Spec4(
            torch.where(newly, throughput.s0 * sp.SPECTRAL_SAMPLES, throughput.s0),
            torch.where(newly, 0.0, throughput.s1),
            torch.where(newly, 0.0, throughput.s2),
            torch.where(newly, 0.0, throughput.s3),
        )
        mono = mono | newly

    new_rd = to_world(wi_s, geo.normal)
    new_ro = geo.position
    hit = intersect_closest(
        new_ro, new_rd, tmin, torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev),
        scene, config, mask=active,
    )

    # escape -> environment MIS, resolved once after the loop (a lane
    # escapes at most once); directions NEE can never produce (delta lobes,
    # below the shading normal) take MIS weight 1 on the BSDF side
    nee_blind = ((lobe & bsdf_mod.LOBE_DELTA) != 0) | (geo.normal.dot(new_rd) <= 0.0)
    if config.has_env:
        esc_mask, esc_dir, esc_tp, esc_pdf = esc
        escaped = active & ~hit.hit_mask
        esc_mask = esc_mask | escaped
        esc_dir = where(escaped, new_rd, esc_dir)
        esc_tp = where(escaped, throughput, esc_tp)
        # -1 = the same "un-weighted" sentinel as primary misses
        esc_pdf = torch.where(escaped, torch.where(nee_blind, -1.0, pdf_s), esc_pdf)
        esc = (esc_mask, esc_dir, esc_tp, esc_pdf)
    active = active & hit.hit_mask

    geo = get_local_geometry(scene, hit, new_ro, new_rd, config.sphere_count,
                             config.instanced, config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        scene.materials, tex, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    if spectral:
        local = _apply_dispersion(local, lams)
    wo_world = -new_rd

    # hit an emitter -> MIS-weighted emission (main.cu:171-183)
    emit_rad, emit_pdf, hit_sel_prob = emitter_mod.eval_hit_emitter(
        em, tex, config, geo.emitter_id, geo.position, geo.normal, geo.uv, new_ro
    )
    mis_hit = torch.where(nee_blind, 1.0, mis_weight(pdf_s, emit_pdf * hit_sel_prob))
    # emission is one-sided on the stored normal (geo.front)
    take_e = active & (geo.emitter_id >= 0) & ~is_zero(emit_pdf) & geo.front
    radiance = radiance + where(take_e, throughput * lift(emit_rad) * mis_hit, zero_l)
    out = (state, active, radiance, throughput, wo_world, geo, local, esc)
    return out + (mono,) if spectral else out


def _identity(v):
    return v


def render_sample(
    scene: SceneData,
    camera: CameraBlock,
    seed,
    config: RenderConfig,
    pix: torch.Tensor,
):
    """Trace one sample of the lanes ``pix`` (pixel ids) at ``seed`` (as
    ``primary_rays`` takes it); returns a dict of flat (N, *) buffers in
    the order of ``pix``: radiance, albedo, normal, test, and with
    ``config.debug_checks`` the sanitizer's report."""
    em, tex = scene.emitters, scene.textures
    dev = scene.tris.packed.device
    n = pix.shape[0]
    state, (ro, rd, tmin, tmax) = primary_rays(camera, config, seed, pix)
    spectral = config.spectral
    if spectral:
        # 4 stratified path wavelengths from one draw (hero + 3 rotations)
        state, (u_lam,) = rng.next_floats(state, 1)
        lams = sp.sample_wavelengths(u_lam)
        lift = functools.partial(sp.lift, lams=lams)
    else:
        lams = None
        lift = _identity
    hit = intersect_closest(ro, rd, tmin, tmax, scene, config)
    geo = get_local_geometry(scene, hit, ro, rd, config.sphere_count,
                             config.instanced, config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        scene.materials, tex, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    if spectral:
        local = _apply_dispersion(local, lams)

    active = hit.hit_mask
    zero3 = Vec3.zeros(n, device=dev)
    if spectral:
        radiance, throughput = sp.Spec4.zeros(n, device=dev), sp.Spec4.ones(n, device=dev)
        zero_l = radiance
    else:
        radiance, throughput = zero3, Vec3.ones(n, device=dev)
        zero_l = zero3

    # primary miss -> un-weighted env radiance, deferred to the single
    # post-loop eval_env (esc_pdf = -1 encodes "no MIS weight")
    esc = (
        (~active, rd,
         sp.Spec4.ones(n, device=dev) if spectral else Vec3.ones(n, device=dev),
         torch.full((n,), -1.0, dtype=torch.float32, device=dev))
        if config.has_env
        else None
    )

    # first-hit emission (main.cu:87-92), one-sided on the stored normal
    is_emitter = active & (geo.emitter_id >= 0) & geo.front
    emit0 = _first_hit_emission(scene, config, geo)
    radiance = radiance + where(is_emitter, lift(emit0), zero_l)

    # AOVs from the first hit (main.cu:94-99)
    albedo_aov = where(active, bsdf_mod.albedo(local), zero3)
    normal_aov = where(active, geo.normal, zero3)

    # the reference writes one RNG draw to the debug AOV (main.cu:101)
    state, test_aov = rng.next_float(state)

    primary_t = torch.where(hit.hit_mask, hit.t, 0.0) if config.debug_checks else None
    carry = (state, active, radiance, throughput, -rd, geo, local, esc)
    if spectral:
        carry = carry + (torch.zeros(n, dtype=torch.bool, device=dev),)  # mono
    del hit, emit0
    for depth in range(1, config.max_depth):
        carry = _bounce(scene, config, n, carry, depth, lams=lams)
    radiance, throughput, esc = carry[2], carry[3], carry[7]
    del carry

    # deferred environment resolve: one eval_env per sample
    if config.has_env:
        esc_mask, esc_dir, esc_tp, esc_pdf = esc
        env_rad, env_pdf = emitter_mod.eval_env(em, tex, config, esc_dir)
        mis_env = torch.where(
            esc_pdf < 0.0, 1.0, mis_weight(esc_pdf, env_pdf * em.env_select_prob),
        )
        radiance = radiance + where(esc_mask, esc_tp * lift(env_rad) * mis_env, zero_l)

    if spectral:
        # sensor: Monte-Carlo CMF integration over the path wavelengths
        radiance = sp.to_rgb(radiance, lams)

    out = {
        "radiance": radiance.to_array(),
        "albedo": albedo_aov.to_array(),
        "normal": normal_aov.to_array(),
        "test": test_aov,
    }
    if config.debug_checks:
        # radiance must be finite and non-negative; a negative throughput
        # catches bad BSDF weights even where they never reach the image
        out["sanitizer"] = finite_report({
            "radiance": (out["radiance"], 0.0),
            "albedo": (out["albedo"], 0.0),
            "normal": (out["normal"], None),
            "primary_t": (primary_t, 0.0),
            "throughput": (throughput.to_array(), 0.0),
        })
    return out


def blend(accum: torch.Tensor, radiance: torch.Tensor, sample_cnt: int,
          accumulate: bool) -> None:
    """The progressive 1/(n+1) blend of ``radiance`` into ``accum``, in
    place (main.cu:187-193); without accumulation ``accum`` takes it."""
    if accumulate and sample_cnt > 0:
        t = _f32(np.float32(1.0) / (np.float32(sample_cnt) + np.float32(1.0)))
        accum.add_((radiance - accum) * t)
    else:
        accum.copy_(radiance)
