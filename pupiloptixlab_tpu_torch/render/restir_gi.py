"""ReSTIR GI: reservoir resampling of one-bounce indirect path samples.

Mirrors pupiloptixlab_tpu/render/restir_gi.py (Ouyang et al. 2021 over
the DI machinery of render/restir.py). Per pixel and frame:

1. one BSDF continuation from the primary hit x finds a sample point y,
   whose outgoing radiance L(y -> x) is one NEE sample at y (the PT
   bounce's direct term);
2. (y, n_y, L) streams into a reservoir with target lum(f_x L cos_x cos_y
   / d^2) and the source pdf in the area measure (pdf_bsdf |cos_y| / d^2),
   so temporal and spatial merges reuse DI's ``merge`` as they are;
3. the winner is shaded with one visibility ray x -> y.

Continuations that cannot ride a position reservoir (env escapes, delta
lobes at x, a delta vertex at y) add their radiance to the frame directly.
Temporal reuse is motion-warped when the previous camera is given: the
previous reservoirs are fetched at the camera-reprojected pixel
(``denoise/atrous.py::camera_motion_vectors``).
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch.accel.intersect import intersect_any, intersect_closest
from pupiloptixlab_tpu_torch.denoise.atrous import camera_motion_vectors
from pupiloptixlab_tpu_torch.flatten.types import RenderConfig, SceneData
from pupiloptixlab_tpu_torch.render import bsdf as bsdf_mod
from pupiloptixlab_tpu_torch.render import emitter as emitter_mod
from pupiloptixlab_tpu_torch.render import rng
from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
from pupiloptixlab_tpu_torch.render.integrator import _first_hit_emission, blend
from pupiloptixlab_tpu_torch.render.restir import (
    Reservoir,
    _GBuf,
    _eval_target,
    _pack,
    _unpack,
    merge,
    pixel_xy,
    primary_gbuffer,
    shade,
    similarity,
    spatial_taps_rows,
)
from pupiloptixlab_tpu_torch.render.sampling import (
    MAX_DISTANCE,
    RAY_OFFSET,
    mis_weight,
    to_local,
    to_world,
)
from pupiloptixlab_tpu_torch.render.vec import Vec3, where

_TINY = 1e-12


def gi_initial_sample(scene: SceneData, config: RenderConfig, gb, local, state, hit):
    """One BSDF continuation + direct light at the secondary vertex.
    Returns (state', y_pos, y_nrm, y_rad (radiance toward x), pdf_area,
    valid, extra_rad), extra_rad the frame's own radiance of the
    continuations that cannot ride a reservoir (env escapes, delta lobes)."""
    em, tex = scene.emitters, scene.textures
    n = gb.position.x.shape[0]
    dev = gb.position.x.device
    zero3 = Vec3.zeros(n, device=dev)
    tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)

    state, us = rng.next_floats(state, 3)
    wo_local = to_local(gb.wo_world, gb.normal)
    wi_s, f_s, pdf_s, lobe = bsdf_mod.sample(local, wo_local, *us, config.mat_types)
    rd = to_world(wi_s, gb.normal)
    live = hit.hit_mask & (pdf_s > _TINY)
    hit2 = intersect_closest(gb.position, rd, tmin, tmax, scene, config, mask=live)
    geo2 = get_local_geometry(scene, hit2, gb.position, rd, config.sphere_count,
                              config.instanced, config.curve_count)
    local2 = bsdf_mod.get_local_bsdf(
        scene.materials, tex, geo2.mat_id, geo2.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    valid = live & hit2.hit_mask

    # escaped continuations carry indirect env light (direction-
    # parameterised, so no position reservoir): the frame's own term
    esc_rad = zero3
    if config.has_env:
        escaped = live & ~hit2.hit_mask
        env_rad, _ = emitter_mod.eval_env(em, tex, config, rd)
        wgt = f_s * (torch.abs(wi_s.z) / torch.clamp(pdf_s, min=_TINY))
        esc_rad = where(escaped, env_rad * wgt, esc_rad)

    # outgoing radiance at y toward x: one NEE sample at y. Emission at y
    # is left out: x's own direct estimator covers x -> emitter paths
    y_rad = zero3
    if config.emitter_count > 0 or config.has_env:
        state, (u_sel, u1, u2) = rng.next_floats(state, 3)
        idx, use_env = emitter_mod.select_emitter(em, config, u_sel)
        es = emitter_mod.sample_direct(em, tex, config, idx, use_env, geo2.position,
                                       geo2.normal, u1, u2)
        wo2 = to_local(rd * -1.0, geo2.normal)
        wl2 = to_local(es.wi, geo2.normal)
        f2, pdf_b2 = bsdf_mod.evaluate(local2, wo2, wl2, config.mat_types)
        nol2 = geo2.normal.dot(es.wi)
        smask = valid & (nol2 > 0.0) & (es.pdf > 0.0)
        occ = intersect_any(geo2.position, es.wi, tmin, es.distance - RAY_OFFSET, scene,
                            config, mask=smask)
        pdf_l = es.pdf * es.select_prob
        mis = torch.where(es.is_delta, 1.0, mis_weight(pdf_l, pdf_b2))
        nee = es.radiance * f2 * (nol2 * mis / torch.clamp(pdf_l, min=_TINY))
        y_rad = y_rad + where(smask & ~occ, nee, zero3)

    # source pdf in the area measure at y
    d = geo2.position - gb.position
    d2 = torch.clamp(d.dot(d), min=_TINY)
    cos_y = torch.abs(geo2.normal.dot(d.normalized()))
    pdf_area = pdf_s * cos_y / d2
    # a delta secondary vertex (mirror, glass): continue one segment
    # through its lobe and take the emission at z (a depth-3 PT's
    # transport for such paths); the sample is x-specific, so it is not
    # reused (routed into the frame's own term below)
    y_blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    if any(t in config.mat_types for t in (bsdf_mod.DIELECTRIC, bsdf_mod.CONDUCTOR)):
        y_delta_rad = zero3
        y_is_delta = valid & (
            (geo2.mat_id >= 0)
            & ((local2.mtype == bsdf_mod.DIELECTRIC) | (local2.mtype == bsdf_mod.CONDUCTOR))
        )
        state, us2 = rng.next_floats(state, 3)
        wo2l = to_local(rd * -1.0, geo2.normal)
        wi2, f2s, pdf2s, _ = bsdf_mod.sample(local2, wo2l, *us2, config.mat_types)
        rd2 = to_world(wi2, geo2.normal)
        w2 = f2s * (torch.abs(wi2.z) / torch.clamp(pdf2s, min=_TINY))
        hit3 = intersect_closest(geo2.position, rd2, tmin, tmax, scene, config,
                                 mask=y_is_delta)
        geo3 = get_local_geometry(scene, hit3, geo2.position, rd2, config.sphere_count,
                                  config.instanced, config.curve_count)
        if config.emitter_count > 0:
            is_em_z = y_is_delta & hit3.hit_mask & (geo3.emitter_id >= 0) & geo3.front
            y_delta_rad = y_delta_rad + where(
                is_em_z, w2 * _first_hit_emission(scene, config, geo3), zero3)
        if config.has_env:
            env2, _ = emitter_mod.eval_env(em, tex, config, rd2)
            y_delta_rad = y_delta_rad + where(y_is_delta & ~hit3.hit_mask, w2 * env2, zero3)
        y_rad = y_rad + y_delta_rad
        y_blocked = y_is_delta

    # delta lobes at x cannot ride reservoirs either (a reconnection
    # through a delta lobe is 0): their one-bounce contribution, BSDF
    # weight x (emission at y + the NEE estimate at y), goes to the frame
    is_delta = (lobe & bsdf_mod.LOBE_DELTA) != 0
    w_bsdf = f_s * (torch.abs(wi_s.z) / torch.clamp(pdf_s, min=_TINY))
    emis_y = zero3
    if config.emitter_count > 0:
        is_em_y = valid & (geo2.emitter_id >= 0) & geo2.front
        emis_y = where(is_em_y, _first_hit_emission(scene, config, geo2), emis_y)
    delta_rad = where(valid & is_delta, w_bsdf * (y_rad + emis_y), zero3)
    # a diffuse x whose continuation landed on a delta y: the frame's own term
    routed = where(valid & ~is_delta & y_blocked, w_bsdf * y_rad, zero3)
    valid = valid & ~is_delta & ~y_blocked & (pdf_area > _TINY)
    return (state, geo2.position, geo2.normal, y_rad, pdf_area, valid,
            esc_rad + delta_rad + routed)


def reproject_pixels(motion: torch.Tensor, width: int, height: int):
    """Nearest-pixel reprojection from (h, w, 2) motion vectors (dx, dy to
    the previous frame's pixel); returns ((N,) index, (N,) valid)."""
    dev = motion.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    sx = xs + motion[..., 0]
    sy = ys + motion[..., 1]
    valid = (sx >= 0) & (sx <= width - 1) & (sy >= 0) & (sy <= height - 1)
    xi = torch.clamp(torch.round(sx), 0, width - 1).to(torch.int32)
    yi = torch.clamp(torch.round(sy), 0, height - 1).to(torch.int32)
    return (yi * width + xi).reshape(-1), valid.reshape(-1)


@torch.inference_mode()
def restir_gi_frame(
    scene: SceneData,
    camera,
    seed: int,
    prev_packed: torch.Tensor,
    accum: torch.Tensor,
    sample_cnt: int,
    config: RenderConfig,
    spatial_taps: int = 2,
    spatial_radius: int = 16,
    m_cap: float = 20.0,
    prev_camera=None,
):
    """One ReSTIR-GI frame: emission + direct light (one NEE sample) + the
    GI reservoir's one-bounce indirect. ``prev_camera`` (optional) warps
    temporal reuse by the camera's motion (static scene) instead of
    reusing in place.

    ``prev_packed`` ((N, 19)) is read and not written; ``accum`` is blended
    in place, as ``render_frame`` does. Returns (accum, packed', frame_rgb),
    packed' a new tensor."""
    em, tex = scene.emitters, scene.textures
    w, h = config.width, config.height
    n = w * h
    state, rd, hit, geo, local, tmin = primary_gbuffer(scene, camera, seed, config)
    dev = rd.x.device
    zero3 = Vec3.zeros(n, device=dev)
    active = hit.hit_mask
    gb = _GBuf(position=geo.position, normal=geo.normal, wo_world=-rd)
    radiance = zero3

    # emission + env on primary
    if config.has_env:
        env_rad0, _ = emitter_mod.eval_env(em, tex, config, rd)
        radiance = radiance + where(~active, env_rad0, zero3)
    is_em = active & (geo.emitter_id >= 0) & geo.front
    radiance = radiance + where(is_em, _first_hit_emission(scene, config, geo), zero3)

    # direct light: one plain NEE sample (DI reservoirs are the DI
    # pass's; this keeps the GI estimator self-contained)
    if config.emitter_count > 0 or config.has_env:
        state, (u_sel, u1, u2) = rng.next_floats(state, 3)
        idx, use_env = emitter_mod.select_emitter(em, config, u_sel)
        es = emitter_mod.sample_direct(em, tex, config, idx, use_env, geo.position,
                                       geo.normal, u1, u2)
        wo_l = to_local(-rd, geo.normal)
        wi_l = to_local(es.wi, geo.normal)
        f_d, _ = bsdf_mod.evaluate(local, wo_l, wi_l, config.mat_types)
        nol = geo.normal.dot(es.wi)
        smask = active & (nol > 0.0) & (es.pdf > 0.0)
        occ = intersect_any(geo.position, es.wi, tmin, es.distance - RAY_OFFSET, scene,
                            config, mask=smask)
        pdf_l = es.pdf * es.select_prob
        direct = es.radiance * f_d * (nol / torch.clamp(pdf_l, min=_TINY))
        radiance = radiance + where(smask & ~occ, direct, zero3)

    # --- GI reservoir -------------------------------------------------
    state, y_pos, y_nrm, y_rad, pdf_area, valid, esc_rad = gi_initial_sample(
        scene, config, gb, local, state, hit)
    radiance = radiance + esc_rad
    r = Reservoir.zeros(n, device=dev)
    phat0, _, _, _ = _eval_target(gb, local, config.mat_types, y_pos, y_nrm, y_rad)
    state, (u0,) = rng.next_floats(state, 1)
    w0 = torch.where(valid, phat0 / torch.clamp(pdf_area, min=_TINY), 0.0)
    r = r.update(u0, y_pos, y_nrm, y_rad, pdf_area, w0, phat0, valid.to(torch.float32))

    # temporal merge (motion-warped when prev_camera is given)
    state, (u_t,) = rng.next_floats(state, 1)
    if prev_camera is not None:
        wp = geo.position.to_array().reshape(h, w, 3)
        motion = camera_motion_vectors(wp, hit.hit_mask.reshape(h, w), prev_camera, w, h)
        src_idx, in_frame = reproject_pixels(motion, w, h)
        rows_prev = prev_packed[src_idx.long()]
    else:
        in_frame = torch.ones(n, dtype=torch.bool, device=dev)
        rows_prev = prev_packed
    r_prev, p_pos, p_nrm = _unpack(rows_prev)
    ok_t = similarity(gb, p_pos, p_nrm) & active & (r_prev.m > 0.0) & in_frame
    r = merge(r, r_prev, gb, local, config.mat_types, u_t, ok_t, m_cap)

    # spatial merges; the tap radius shrinks with the receiver's
    # glossiness (a narrow target lobe wastes far taps)
    packed0 = _pack(r, gb)
    rough = (
        (local.mtype == bsdf_mod.ROUGH_DIELECTRIC)
        | (local.mtype == bsdf_mod.ROUGH_CONDUCTOR)
        | (local.mtype == bsdf_mod.ROUGH_PLASTIC)
    )
    radius = spatial_radius * torch.where(
        rough, torch.clamp(local.alpha / 0.3, 0.1, 1.0), 1.0)
    px, py = pixel_xy(config, dev)
    for _ in range(spatial_taps):
        state, (u1s, u2s, u3s) = rng.next_floats(state, 3)
        rows = spatial_taps_rows(packed0, px, py, u1s, u2s, radius, w, h)
        r_n, n_pos, n_nrm = _unpack(rows)
        ok_s = similarity(gb, n_pos, n_nrm) & active & (r_n.m > 0.0)
        r = merge(r, r_n, gb, local, config.mat_types, u3s, ok_s, m_cap)

    radiance = radiance + shade(scene, config, r, gb, local, active)
    out_packed = _pack(r, gb)

    rad = radiance.to_array()
    blend(accum, rad, sample_cnt, config.accumulate)
    return accum, out_packed, rad
