"""Progressive path tracer with NEE + balance-heuristic MIS (RGB).

Mirrors pupiloptixlab_tpu/render/integrator.py: camera rays -> closest
hit -> [NEE shadow ray + BSDF bounce] x (max_depth - 1) -> one deferred
env evaluation -> progressive 1/(n+1) blend. Every lane carries an
``active`` mask instead of branching; the reference's ``lax.scan`` over
``_bounce`` is a Python loop here, and the frame runs under
``torch.inference_mode()``.

BVH scenes with block-divisible films generate primary rays in (8 x 128)
pixel blocks exactly as the reference does (lanes are decoded back to
row-major pixels at the end); the per-pixel RNG is keyed by pixel id, so
lane order never changes the image.

Multi-device frames (parallel/): ``tile_perm`` reorders the 1024-pixel
tiles of the block lane order before tracing (chunk-sweep scenes keep
row-major lanes and ignore it), and ``slab=(k, d)`` traces only the k-th of
d equal, contiguous slabs of that lane order: whole tiles on the block
route, whole pixel rows on the row-major route. A slab's buffers stay in
its lane order (``lane_pixels`` names their pixels); ``lanes_to_pixels``
turns the whole lane order back into row-major pixels. Since the RNG is
keyed by pixel id, a slab's lanes equal the same lanes of the whole frame,
bit for bit, under any permutation.

Spectral transport (``config.spectral``, render/spectral.py): one extra
draw right after the pixel jitter picks the path's 4 wavelengths;
radiance and throughput become Spec4 planes, every RGB quantity lifts at
its use site, a dispersive transmission collapses the path to its hero,
and the sensor integrates back to RGB before the AOVs are written. The
value sanitizer (``config.debug_checks``, utils/debug.py) adds a report
of per-stage counts of bad values to the buffers.

The offline renderer (``render``) goes through ``render_frame_batch``, the
counterpart of the reference's single-dispatch batch: on the card one
sample, seed and count read from 0-dim device tensors that the sample
itself advances, is captured into a CUDA graph and replayed once a sample,
and the traversal kernels' fault flags are read once, after the last
replay. ``render_frame``, which the passes call once a frame, stays eager.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel import bvh_traverse
from pupiloptixlab_tpu_torch.accel.gather import gather_cols
from pupiloptixlab_tpu_torch.accel.intersect import intersect_any, intersect_closest
from pupiloptixlab_tpu_torch.flatten.types import (
    EM_RAD_TEX,
    CameraBlock,
    RenderConfig,
    SceneData,
)
from pupiloptixlab_tpu_torch.render import bsdf as bsdf_mod
from pupiloptixlab_tpu_torch.render import emitter as emitter_mod
from pupiloptixlab_tpu_torch.render import rng
from pupiloptixlab_tpu_torch.render import spectral as sp
from pupiloptixlab_tpu_torch.render.camera import generate_rays_for
from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
from pupiloptixlab_tpu_torch.render.sampling import (
    MAX_DISTANCE,
    RAY_OFFSET,
    is_zero,
    mis_weight,
    to_local,
    to_world,
)
from pupiloptixlab_tpu_torch.render.texture import gather_texture, sample_texture_cols
from pupiloptixlab_tpu_torch.render.vec import Vec3, where
from pupiloptixlab_tpu_torch.utils.debug import finite_report

_TINY = 1e-12
_BLOCK_H, _BLOCK_W = 8, 128


def uses_blocks(config) -> bool:
    """Whether a frame traces in (8 x 128)-block lane order (the BVH route
    on a film of whole blocks) rather than row-major."""
    return (
        config.bvh_nodes > 0
        and config.width % _BLOCK_W == 0
        and config.height % _BLOCK_H == 0
    )


def _block_pix(width: int, height: int, device) -> torch.Tensor:
    """(n,) int32 pixel ids in (8 x 128)-block lane order, made on
    ``device`` (no host copy, which a captured CUDA graph could not hold)."""
    hb, wb = height // _BLOCK_H, width // _BLOCK_W
    ids = torch.arange(height * width, dtype=torch.int32, device=device)
    return ids.reshape(hb, _BLOCK_H, wb, _BLOCK_W).permute(0, 2, 1, 3).reshape(-1)


def _block_decode(v: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Lane order -> row-major pixel order (reshape + permute only)."""
    hb, wb = height // _BLOCK_H, width // _BLOCK_W
    rest = tuple(v.shape[1:])
    v4 = v.reshape(hb, wb, _BLOCK_H, _BLOCK_W, *rest)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    return v4.permute(*perm).reshape(height * width, *rest)


_TILE = _BLOCK_H * _BLOCK_W  # lanes per tile of the block lane order


def lane_pixels(config, tile_perm=None, slab=None, *, device) -> torch.Tensor:
    """(n,) pixel ids of the lanes a frame traces, in lane order, on
    ``device``: every pixel of the film, or slab ``(k, d)`` of them. Block route: the
    (8 x 128)-block order, its tiles reordered by ``tile_perm``; row-major
    route: pixel order (``tile_perm`` ignored, as the reference does)."""
    w, h = config.width, config.height
    n = w * h
    if uses_blocks(config):
        pix = _block_pix(w, h, device)
        if tile_perm is not None:
            perm = torch.as_tensor(tile_perm, device=device).long()
            if perm.shape != (n // _TILE,):
                raise ValueError(f"tile_perm: expected ({n // _TILE},) tile indices, "
                                 f"got {tuple(perm.shape)}")
            pix = pix.reshape(-1, _TILE)[perm].reshape(-1)
        quantum = _TILE
    else:
        pix = torch.arange(n, dtype=torch.int64, device=device)
        quantum = w
    if slab is None:
        return pix
    k, d = slab
    if not (0 <= k < d) or n % (d * quantum):
        unit = "tiles of 1024 pixels" if quantum == _TILE else f"rows of {w} pixels"
        raise ValueError(f"slab {k} of {d}: the film's {n // quantum} {unit} do not "
                         f"split into {d} equal slabs")
    size = n // d
    return pix[k * size:(k + 1) * size]


def lanes_to_pixels(v: torch.Tensor, config, tile_perm=None) -> torch.Tensor:
    """(N, *) buffers in the whole frame's lane order -> row-major pixel
    order: tiles un-permuted (one 1024-row move per tile), then the block
    decode (reshape + permute only). The identity on the row-major route."""
    if not uses_blocks(config):
        return v
    w, h = config.width, config.height
    if tile_perm is not None:
        perm = torch.as_tensor(tile_perm, device=v.device).long()
        inv = torch.argsort(perm)
        v = v.reshape(-1, _TILE, *v.shape[1:])[inv].reshape(v.shape)
    return _block_decode(v, w, h)


def primary_rays(camera: CameraBlock, config: RenderConfig, seed, pix: torch.Tensor):
    """The camera rays of the lanes ``pix`` (pixel ids, as ``lane_pixels``
    gives them) at ``seed`` (an int, or a 0-dim integer tensor on the
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
    tile_perm=None,
    slab=None,
):
    """Trace one sample per pixel at ``seed`` (as ``primary_rays`` takes
    it); returns a dict of flat (N, *) buffers:
    radiance, albedo, normal, test, in row-major pixel order, and with
    ``config.debug_checks`` the sanitizer's report. With ``slab`` (k, d)
    only the lanes ``lane_pixels(config, tile_perm, slab)`` are traced, and
    the buffers are (N / d, *) in their lane order."""
    em, tex = scene.emitters, scene.textures
    dev = scene.tris.packed.device
    pix = lane_pixels(config, tile_perm, slab, device=dev)
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
    if slab is None:
        out = {k: lanes_to_pixels(v, config, tile_perm) for k, v in out.items()}
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


def render_frame(
    scene: SceneData,
    camera: CameraBlock,
    seed: int,
    sample_cnt: int,
    accum: torch.Tensor,
    config: RenderConfig,
    tile_perm=None,
    slab=None,
):
    """One progressive frame: trace + accumulate (main.cu:187-193).

    ``accum`` ((N, 3) float32) is updated in place, as the reference
    donates it. Returns (accum, buffers) where buffers holds the
    displayable AOVs (frame, albedo, normal, test) and, with
    ``config.debug_checks``, the sanitizer's report (0-dim int32 counts on
    the frame's device). ``tile_perm`` and
    ``slab`` as in ``render_sample``: with a slab, ``accum`` and the
    buffers hold that slab's lanes only, in lane order."""
    with torch.inference_mode():
        out = render_sample(scene, camera, seed, config, tile_perm, slab)
        blend(accum, out["radiance"], sample_cnt, config.accumulate)
        buffers = {
            "frame": accum,
            "albedo": out["albedo"],
            "normal": out["normal"],
            "test": out["test"],
        }
        if config.debug_checks:
            buffers["sanitizer"] = out["sanitizer"]
    return accum, buffers


def blend_weight(cnt: torch.Tensor) -> torch.Tensor:
    """The blend weight ``1 / (float32(cnt) + 1)`` of integer sample
    counts, on their device. Float32 division is correctly rounded on the
    host and on the card, so it equals ``blend``'s host weight bit for bit
    at every count."""
    return torch.reciprocal(cnt.to(torch.float32) + 1.0)


def _blend_on_device(accum: torch.Tensor, radiance: torch.Tensor, cnt: torch.Tensor,
                     accumulate: bool) -> None:
    """``blend`` with the sample count a 0-dim integer tensor on accum's
    device, in the reference's form (its integrator.py:560-567):
    ``where(cnt > 0, acc + (radiance - acc) * blend_weight(cnt),
    radiance)``; bit-equal to ``blend`` at the same count."""
    if accumulate:
        t = blend_weight(cnt)
        accum.copy_(torch.where(cnt > 0, accum + (radiance - accum) * t, radiance))
    else:
        accum.copy_(radiance)


def _batch_sample(scene, camera, seed, cnt, accum, config) -> dict:
    """One sample of ``render_frame_batch`` at ``seed``, blended into
    ``accum`` at count ``cnt`` (0-dim int64 tensors on accum's device,
    read by the kernels), then ``seed`` and ``cnt`` one up for the next
    sample. Returns the sample's albedo, normal and test buffers."""
    out = render_sample(scene, camera, seed, config)
    _blend_on_device(accum, out["radiance"], cnt, config.accumulate)
    seed.add_(1)
    cnt.add_(1)
    return {"albedo": out["albedo"], "normal": out["normal"], "test": out["test"]}


# what the last render_frame_batch on the card did, filled once its replays
# are issued: their number, the host ms of its warm-up, capture and
# instantiation, the graph's nodes, one replay's launches; after the flag
# read (which waits for the card) the replays' host ms
BATCH_STATS: dict = {}


def _replay_batch(scene, camera, seed, cnt, accum, config, spp) -> dict:
    """``spp`` samples on the card: one warm-up sample, eager on a side
    stream into a scratch accum (it builds the kernels and their tables and
    fills the allocator), then one sample captured into a CUDA graph and
    replayed ``spp`` times. The graph advances ``seed`` and ``cnt`` itself,
    so replay i is sample i. The traversal wrappers defer their fault flags
    to one batch flag (``bvh_traverse.deferred_flags``), warm-up included,
    read once after the last replay; one replay's launches count ``spp``
    times. Nothing falls back: a failed capture or replay raises. Returns
    clones of the last sample's buffers, so that nothing returned lives in
    the graph's memory pool, which is released here."""
    dev = accum.device
    t0 = time.perf_counter()
    with bvh_traverse.deferred_flags(dev) as flags:
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _batch_sample(scene, camera, seed.clone(), cnt.clone(), accum.clone(), config)
        torch.cuda.current_stream(dev).wait_stream(side)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with kernels.captured_launches() as per_sample:
            with torch.cuda.graph(graph):
                t2 = time.perf_counter()
                bufs = _batch_sample(scene, camera, seed, cnt, accum, config)
        t3 = time.perf_counter()
        graph.instantiate()
        t4 = time.perf_counter()
        nodes = kernels.graph_nodes(graph.raw_cuda_graph())
        for _ in range(spp):
            graph.replay()
        kernels.add_launches(per_sample, spp)
    BATCH_STATS.clear()
    BATCH_STATS.update(replays=spp, warmup_ms=(t1 - t0) * 1e3, capture_ms=(t3 - t2) * 1e3,
                       instantiate_ms=(t4 - t3) * 1e3, nodes=nodes,
                       launches_per_sample=dict(per_sample))
    bvh_traverse.raise_on_flags(flags)
    BATCH_STATS["replay_ms"] = (time.perf_counter() - t4) * 1e3
    bufs = {k: v.clone() for k, v in bufs.items()}
    graph.reset()
    return bufs


def render_frame_batch(
    scene: SceneData,
    camera: CameraBlock,
    seed0,
    sample_cnt,
    accum: torch.Tensor,
    config: RenderConfig,
    spp: int,
):
    """``spp`` progressive samples (the reference's one-dispatch batch, its
    integrator.py:544-583). Sample i traces at seed ``(seed0 + i) mod
    2^32`` and blends at count ``sample_cnt + i`` (at a count <= 0 the
    accum takes the sample as it is); ``accum`` ((N, 3) float32) is updated
    in place, as the reference donates it. Returns (accum, buffers): the
    last sample's frame (= accum), albedo, normal and test, and no
    sanitizer report (``config.debug_checks`` is ignored, as the
    reference's batch carries none).

    On the card the samples are one captured CUDA graph replayed ``spp``
    times (``_replay_batch``: a traversal fault raises after the last
    replay, naming its kernel); on the CPU the same sample runs ``spp``
    times eagerly. Either way each sample is render_frame's, bit for bit."""
    dev = accum.device
    if config.debug_checks:
        config = dataclasses.replace(config, debug_checks=False)
    with torch.inference_mode():
        seed = torch.tensor(int(seed0) & rng.M32, dtype=torch.int64, device=dev)
        cnt = torch.tensor(int(sample_cnt), dtype=torch.int64, device=dev)
        if spp <= 0:
            bufs = {"albedo": torch.zeros_like(accum), "normal": torch.zeros_like(accum),
                    "test": torch.zeros(accum.shape[0], dtype=torch.float32, device=dev)}
        elif dev.type == "cuda":
            bufs = _replay_batch(scene, camera, seed, cnt, accum, config, spp)
        else:
            for _ in range(spp):
                bufs = _batch_sample(scene, camera, seed, cnt, accum, config)
    return accum, {"frame": accum, **bufs}


def render(
    scene: SceneData,
    camera: CameraBlock,
    config: RenderConfig,
    spp: int,
    seed0: int = 0,
):
    """Render ``spp`` progressive samples; returns (h, w, 3) radiance,
    through ``render_frame_batch`` from count 0 as the reference's does (on
    the card every sample is one replay of one captured graph). Equal, bit
    for bit, to a loop of render_frame calls at seeds seed0 + i and counts
    i."""
    n = config.width * config.height
    with torch.inference_mode():
        accum = torch.zeros((n, 3), dtype=torch.float32, device=scene.tris.packed.device)
        render_frame_batch(scene, camera, seed0, 0, accum, config, spp)
    return accum.reshape(config.height, config.width, 3)
