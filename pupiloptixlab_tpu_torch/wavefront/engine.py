"""Wavefront path tracer: a persistent ray pool with continuous refill.

Mirrors pupiloptixlab_tpu/wavefront/engine.py: a pool of one film's worth
of lanes is traced one bounce an iteration, and lanes whose paths end are
refilled with fresh camera paths in the same iteration, so the pool stays
full whatever the paths' lengths. The estimator is the integrator's (NEE
+ MIS + Russian roulette); a path's radiance lands in the film when it
dies. Total work is spp * width * height paths a call.

The reference's ``lax.while_loop`` is a Python loop here. The next path's
index stays a host integer; each iteration reads one count from the
device (the pool's live lanes: the loop's exit test and the refill's
size), which is one host sync an iteration (``render_wavefront`` reports
the iterations and syncs in its result).

The film scatter is deterministic on every device: lanes of one pixel add
in lane order, one round per rank of a lane among its pixel's lanes (a
pixel has at most spp lanes in the pool), each round with distinct
targets. With spp 1 every pixel has one lane and there is one round.
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch.accel.intersect import intersect_any, intersect_closest
from pupiloptixlab_tpu_torch.flatten.types import CameraBlock, RenderConfig, SceneData
from pupiloptixlab_tpu_torch.render import bsdf as bsdf_mod
from pupiloptixlab_tpu_torch.render import emitter as emitter_mod
from pupiloptixlab_tpu_torch.render import rng
from pupiloptixlab_tpu_torch.render.camera import generate_rays_for
from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
from pupiloptixlab_tpu_torch.render.integrator import _first_hit_emission
from pupiloptixlab_tpu_torch.render.sampling import (
    MAX_DISTANCE,
    RAY_OFFSET,
    is_zero,
    mis_weight,
    to_local,
    to_world,
)
from pupiloptixlab_tpu_torch.render.vec import Vec3, where

_TINY = 1e-12

def _pixel_ranks(pixel: torch.Tensor) -> torch.Tensor:
    """(N,) rank of each lane among the lanes of its pixel, in lane order."""
    n = pixel.shape[0]
    order = torch.argsort(pixel, stable=True)
    sp = pixel[order]
    lane = torch.arange(n, dtype=torch.int64, device=pixel.device)
    first = torch.ones(n, dtype=torch.bool, device=pixel.device)
    first[1:] = sp[1:] != sp[:-1]
    start = torch.cummax(torch.where(first, lane, 0), 0).values
    rank = torch.empty_like(lane)
    rank[order] = lane - start
    return rank


def _scatter_rgb(film: torch.Tensor, pixel: torch.Tensor, value: Vec3, mask: torch.Tensor,
                 ranks: torch.Tensor | None, rounds: int) -> None:
    """film (N + 1, 3) += value where mask, in place. Lanes of one pixel add
    in lane order: round r takes the lanes of rank r among their pixel's
    lanes (``ranks``, None when every pixel has one lane), whose targets
    are distinct; row N takes the lanes outside the round."""
    n = film.shape[0] - 1
    v = torch.where(mask[:, None], value.to_array(), 0.0)
    if ranks is None:
        film.index_put_((pixel,), film[pixel] + v)
        return
    for r in range(rounds):
        t = torch.where(ranks == r, pixel, n)
        film.index_put_((t,), film[t] + v)


@torch.inference_mode()
def render_wavefront(
    scene: SceneData,
    camera: CameraBlock,
    seed: int,
    config: RenderConfig,
    spp: int = 1,
):
    """Render spp samples a pixel with a persistent pool. Returns a dict with
    film (N, 3) mean radiance, the albedo/normal AOV means, and the loop's
    ``iterations`` and host ``syncs``."""
    w, h = config.width, config.height
    n = w * h
    pool = n  # one film's worth of lanes
    total_paths = n * spp
    em, tex = scene.emitters, scene.textures
    dev = scene.tris.packed.device
    tmin_c = torch.full((pool,), RAY_OFFSET, dtype=torch.float32, device=dev)
    tmax_c = torch.full((pool,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    zero3 = Vec3.zeros(pool, device=dev)
    lane = torch.arange(pool, dtype=torch.int64, device=dev)

    # films with one spare row for the lanes a scatter round leaves out
    film = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)
    albedo = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)
    normal = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)

    # pool state: a path between two surface events
    ro, rd = zero3, Vec3.full(pool, 0.0, 0.0, 1.0, device=dev)
    radiance, throughput = zero3, Vec3.ones(pool, device=dev)
    state = torch.zeros(pool, dtype=torch.int64, device=dev)
    pixel = lane.clone()  # distinct until the first refill
    depth = torch.zeros(pool, dtype=torch.int32, device=dev)  # bounces completed
    pdf_prev = torch.zeros(pool, dtype=torch.float32, device=dev)
    delta_prev = torch.zeros(pool, dtype=torch.bool, device=dev)
    alive = torch.zeros(pool, dtype=torch.bool, device=dev)
    next_path = 0  # host integer: the next path index to spawn
    # with spp 1 every pixel has one path, so one lane; above, a pixel
    # has at most spp lanes (its paths' indices are distinct)
    ranks = None if spp == 1 else torch.zeros(pool, dtype=torch.int64, device=dev)
    iterations = syncs = 0

    while True:
        n_alive = int(torch.count_nonzero(alive))  # the iteration's one sync
        syncs += 1
        if not (next_path < total_paths or n_alive > 0):
            break
        iterations += 1
        # flush lanes that died last iteration into the film, then refill
        dead = ~alive
        _scatter_rgb(film, pixel, radiance, dead, ranks, spp)
        radiance = where(dead, zero3, radiance)

        # refill: dead lanes take the next paths in lane order (the queue
        # append: a lane's rank among the dead lanes)
        order = torch.cumsum(dead.to(torch.int64), 0) - 1
        path_idx = next_path + order
        fresh = dead & (path_idx < total_paths)
        spawned = min(pool - n_alive, total_paths - next_path)
        pixel_new = path_idx % n
        st_new = rng.tea_init(path_idx, seed)
        st_new, (jx, jy) = rng.next_floats(st_new, 2)
        ro_new, rd_new = generate_rays_for(camera, w, h, pixel_new, jx, jy)
        ro = where(fresh, ro_new, ro)
        rd = where(fresh, rd_new, rd)
        radiance = where(fresh, zero3, radiance)
        throughput = where(fresh, Vec3.ones(pool, device=dev), throughput)
        state = torch.where(fresh, st_new, state)
        pixel = torch.where(fresh, pixel_new, pixel)
        depth = torch.where(fresh, 0, depth)
        pdf_prev = torch.where(fresh, 0.0, pdf_prev)
        delta_prev = delta_prev & ~fresh
        alive = alive | fresh
        next_path += spawned
        if ranks is not None and spawned > 0:
            ranks = _pixel_ranks(pixel)

        # ---- trace the in-flight ray ---------------------------------------
        hit = intersect_closest(ro, rd, tmin_c, tmax_c, scene, config, mask=alive)
        geo = get_local_geometry(scene, hit, ro, rd, config.sphere_count, config.instanced,
                                 config.curve_count)
        local = bsdf_mod.get_local_bsdf(
            scene.materials, tex, geo.mat_id, geo.uv, config.mat_types,
            config.mat_tex_kinds, config.mat_tex_filters,
        )

        # ---- escaped -> environment ------------------------------------------
        env_rad, env_pdf = emitter_mod.eval_env(em, tex, config, rd)
        escaped = alive & ~hit.hit_mask
        # primary rays add env unweighted (main.cu:84); bounced rays MIS
        # against the previous BSDF pdf (main.cu:166-169)
        mis_env = torch.where(fresh, 1.0, mis_weight(pdf_prev, env_pdf * em.env_select_prob))
        radiance = radiance + where(escaped, throughput * env_rad * mis_env, zero3)
        alive = alive & hit.hit_mask

        # ---- emission at the hit ---------------------------------------------
        emit_rad, emit_pdf, hit_sel_prob = emitter_mod.eval_hit_emitter(
            em, tex, config, geo.emitter_id, geo.position, geo.normal, geo.uv, ro,
        )
        is_emissive = alive & (geo.emitter_id >= 0) & geo.front
        # fresh hit: GetRadiance (main.cu:87-92; the reference engine's
        # _first_emit_radiance is the integrator's first-hit term); bounced:
        # MIS (171-183)
        direct_emit = _first_hit_emission(scene, config, geo)
        mis_hit = torch.where(delta_prev, 1.0, mis_weight(pdf_prev, emit_pdf * hit_sel_prob))
        bounced_ok = is_emissive & ~fresh & ~is_zero(emit_pdf)
        radiance = radiance + where(bounced_ok, throughput * emit_rad * mis_hit, zero3)
        radiance = radiance + where(is_emissive & fresh, direct_emit, zero3)

        # ---- AOVs on primary hits --------------------------------------------
        first = alive & fresh
        _scatter_rgb(albedo, pixel, bsdf_mod.albedo(local), first, ranks, spp)
        _scatter_rgb(normal, pixel, geo.normal, first, ranks, spp)

        # ---- bounce: RR + NEE + BSDF sample ------------------------------------
        state, us = rng.next_floats(state, 7)
        u_rr, u_sel, u_l1, u_l2, u_b0, u_b1, u_b2 = us

        depth = depth + 1  # entering bounce #depth (main.cu:104)
        within = depth < config.max_depth
        rr = torch.where(depth > 2, 0.95, 1.0)
        alive = alive & within & (u_rr <= rr)
        throughput = where(alive, throughput * (1.0 / rr), throughput)

        idx, use_env = emitter_mod.select_emitter(em, config, u_sel)
        es = emitter_mod.sample_direct(em, tex, config, idx, use_env, geo.position,
                                       geo.normal, u_l1, u_l2)
        wo_local = to_local(-rd, geo.normal)
        wi_local = to_local(es.wi, geo.normal)
        f_nee, pdf_bsdf = bsdf_mod.evaluate(local, wo_local, wi_local, config.mat_types)
        nol = geo.normal.dot(es.wi)
        # the selection probability is in the NEE density on both MIS
        # sides (the integrator's documented deviation)
        pdf_light = es.pdf * es.select_prob
        mis = torch.where(es.is_delta, 1.0, mis_weight(pdf_light, pdf_bsdf))
        contrib = throughput * es.radiance * f_nee * (
            nol * mis / torch.clamp(pdf_light, min=_TINY))
        shadow = alive & ~is_zero(f_nee * es.pdf) & (nol > 0.0)
        occluded = intersect_any(geo.position, es.wi, tmin_c, es.distance - RAY_OFFSET,
                                 scene, config, mask=shadow)
        radiance = radiance + where(shadow & ~occluded, contrib, zero3)

        wi_s, f_s, pdf_s, lobe = bsdf_mod.sample(local, wo_local, u_b0, u_b1, u_b2,
                                                  config.mat_types)
        cos_term = torch.abs(wi_s.z)
        alive = alive & ~(is_zero(f_s * cos_term) | is_zero(pdf_s))
        throughput = where(
            alive, throughput * f_s * (cos_term / torch.clamp(pdf_s, min=_TINY)), throughput)

        ro = geo.position
        rd = to_world(wi_s, geo.normal)
        pdf_prev = pdf_s
        delta_prev = (lobe & bsdf_mod.LOBE_DELTA) != 0
        del hit, geo, local, es

    # flush the radiance of the last generation of paths
    _scatter_rgb(film, pixel, radiance, torch.ones_like(alive), ranks, spp)
    inv = 1.0 / spp
    return {
        "film": film[:n] * inv,
        "albedo": albedo[:n] * inv,
        "normal": normal[:n] * inv,
        "iterations": iterations,
        "syncs": syncs,
    }
