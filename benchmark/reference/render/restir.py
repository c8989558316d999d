"""ReSTIR DI (Bitterli, Wyman, Pharr, Shirley, Lefohn and Jarosz,
"Spatiotemporal reservoir resampling for real-time ray tracing with
dynamic direct lighting", ACM TOG 39(4), 2020), one frame worked out again
at a set of pixels, in plain float32 over the reference's own loader,
flatten, brute sweep and gathers.

A pixel's frame takes the steps of the paper's Algorithms 3-5 in the order
the program takes them: its primary hit; M candidate lights streamed
through a weighted reservoir (resampled importance sampling towards the
target p_hat); the previous frame's reservoir of the same pixel merged in
(temporal reuse); k neighbours' reservoirs merged in (spatial reuse); one
shadow ray for the winner, weighted by the unbiased contribution weight
W = w_sum / (M p_hat(y)). Each pixel draws from its own random stream,
keyed by its pixel id and the frame's seed, in a fixed order (2 jitter
draws, 4 a candidate, 1 for the temporal merge, 3 a spatial tap, 2 for the
environment), so a pixel and the neighbours it taps are worked out alone,
exactly as in the whole film: ``restir_pixels`` computes the checked
pixels and the pre-spatial reservoirs (after the temporal merge) of the
neighbours they tap, from the frame's input rows.

Departures from the paper, all of them the program's:

- p_hat is the luminance of the unshadowed contribution f * L * G in the
  area measure, where the paper leaves the choice of target open; merges
  re-evaluate it at the receiving pixel in the area measure, where they
  need no Jacobian.
- Candidates are area lights alone, the emitter chosen by the scene's
  power-times-area table (the environment's share squeezed out) and a
  point uniform on it; the environment adds one ordinary NEE sample on
  top, outside the reservoirs.
- The temporal merge takes the same pixel (no motion vectors: the camera
  rests, and a camera step resets the history) when the two G-buffer
  points are similar: normals within ~25 degrees and squared distance
  within 1% of |x|^2 (the paper: 25 degrees, 10% of depth). Each merged
  reservoir's count is capped at 20 M.
- One spatial pass (the paper's biased variant runs two) of k taps, each a
  random offset in the square of half-width ``radius`` (the paper: a disk)
  clamped to the film, merged with the biased 1/M combination and no
  visibility reuse.
- A reservoir row is 19 floats: the winner's position, normal and
  radiance, its source pdf in area measure, w_sum, M, p_hat, and the
  G-buffer point and normal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.accel.intersect import intersect_any, intersect_closest
from benchmark.reference.render import bsdf as bsdf_mod
from benchmark.reference.render import emitter as emitter_mod
from benchmark.reference.render import rng
from benchmark.reference.render.geometry import get_local_geometry
from benchmark.reference.render.integrator import _first_hit_emission, primary_rays
from benchmark.reference.render.sampling import MAX_DISTANCE, RAY_OFFSET, luminance, to_local
from benchmark.reference.render.vec import Vec3, where

_TINY = 1e-12
N_PACK = 19


@dataclass
class Reservoir:
    y_pos: Vec3
    y_nrm: Vec3
    y_rad: Vec3
    y_parea: torch.Tensor
    w_sum: torch.Tensor
    m: torch.Tensor
    phat: torch.Tensor

    @staticmethod
    def zeros(n: int, device) -> "Reservoir":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        z3 = Vec3.zeros(n, device=device)
        return Reservoir(z3, z3, z3, z, z, z, z)

    def update(self, u, pos, nrm, rad, parea, w, phat, count) -> "Reservoir":
        """Stream one sample of weight w into the reservoir (Algorithm 2):
        it replaces the winner with probability w / w_sum."""
        w_sum = self.w_sum + w
        take = (u * torch.clamp(w_sum, min=_TINY)) < w
        return Reservoir(
            where(take, pos, self.y_pos), where(take, nrm, self.y_nrm),
            where(take, rad, self.y_rad), torch.where(take, parea, self.y_parea),
            w_sum, self.m + count, torch.where(take, phat, self.phat))

    @property
    def ucw(self) -> torch.Tensor:
        """W = w_sum / (M p_hat(y))."""
        return self.w_sum / torch.clamp(self.m * self.phat, min=_TINY)


@dataclass
class _Pixels:
    """The primary hits of a set of lanes and their random streams."""

    pix: torch.Tensor
    state: torch.Tensor
    rd: Vec3
    hit: object
    geo: object
    local: object


def _target(geo, wo_world: Vec3, local, mat_types, y_pos, y_nrm, y_rad):
    """p_hat at the lanes' points: (p_hat, contribution, wi, distance)."""
    delta = y_pos - geo.position
    d2 = torch.clamp(delta.dot(delta), min=_TINY)
    dist = torch.sqrt(d2)
    wi = delta * (1.0 / dist)
    f, _ = bsdf_mod.evaluate(local, to_local(wo_world, geo.normal), to_local(wi, geo.normal),
                             mat_types)
    cos_x = torch.clamp(geo.normal.dot(wi), min=0.0)
    cos_l = torch.clamp(y_nrm.dot(-wi), min=0.0)
    contrib = f * y_rad * (cos_x * cos_l / d2)
    return luminance(contrib), contrib, wi, dist


def _merge(r, other, px: _Pixels, config, u, ok, cap):
    """Merge another reservoir into r (Algorithm 4): its sample weighted by
    p_hat here times its W and its count (capped, zero where ``ok`` fails)."""
    m_o = torch.clamp(other.m, max=cap) * ok.to(torch.float32)
    phat, _, _, _ = _target(px.geo, -px.rd, px.local, config.mat_types, other.y_pos,
                            other.y_nrm, other.y_rad)
    return r.update(u, other.y_pos, other.y_nrm, other.y_rad, other.y_parea,
                    phat * other.ucw * m_o, phat, m_o)


def _similar(geo, pos: Vec3, nrm: Vec3) -> torch.Tensor:
    d = geo.position - pos
    scale = torch.clamp(geo.position.dot(geo.position), min=1.0)
    return (geo.normal.dot(nrm) > 0.906) & (d.dot(d) < 0.01 * scale)


def _pack(r: Reservoir, geo) -> torch.Tensor:
    return torch.stack([r.y_pos.x, r.y_pos.y, r.y_pos.z, r.y_nrm.x, r.y_nrm.y, r.y_nrm.z,
                        r.y_rad.x, r.y_rad.y, r.y_rad.z, r.y_parea, r.w_sum, r.m, r.phat,
                        geo.position.x, geo.position.y, geo.position.z,
                        geo.normal.x, geo.normal.y, geo.normal.z], dim=1)


def _unpack(rows: torch.Tensor):
    c = [rows[:, i] for i in range(N_PACK)]
    r = Reservoir(Vec3(c[0], c[1], c[2]), Vec3(c[3], c[4], c[5]), Vec3(c[6], c[7], c[8]),
                  c[9], c[10], c[11], c[12])
    return r, Vec3(c[13], c[14], c[15]), Vec3(c[16], c[17], c[18])


def _primary(data, config, camera, seed: int, pix: torch.Tensor) -> _Pixels:
    state, (ro, rd, tmin, tmax) = primary_rays(camera, config, seed, pix)
    hit = intersect_closest(ro, rd, tmin, tmax, data, config)
    geo = get_local_geometry(data, hit, ro, rd, config.sphere_count, config.instanced,
                             config.curve_count)
    local = bsdf_mod.get_local_bsdf(data.materials, data.textures, geo.mat_id, geo.uv,
                                    config.mat_types, config.mat_tex_kinds,
                                    config.mat_tex_filters)
    return _Pixels(pix, state, rd, hit, geo, local)


def _candidates(data, config, px: _Pixels, m_candidates: int) -> Reservoir:
    """M area-light candidates streamed into a fresh reservoir (Algorithm 3)."""
    em, tex, geo = data.emitters, data.textures, px.geo
    n = px.pix.shape[0]
    dev = px.pix.device
    area_mass = torch.clamp(1.0 - em.env_select_prob, min=_TINY) if config.has_env else 1.0
    no_env = torch.zeros(n, dtype=torch.bool, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    r = Reservoir.zeros(n, dev)
    for _ in range(m_candidates):
        px.state, (u_sel, u1, u2, u_res) = rng.next_floats(px.state, 4)
        idx, _ = emitter_mod.select_emitter(em, config, u_sel * area_mass)
        es = emitter_mod.sample_direct(em, tex, config, idx, no_env, geo.position, geo.normal,
                                       u1, u2, allow_env=False)
        y_pos = geo.position + es.wi * es.distance
        cos_l = torch.clamp(es.light_normal.dot(-es.wi), min=0.0)
        parea = (es.pdf * (es.select_prob / area_mass) * cos_l
                 / torch.clamp(es.distance * es.distance, min=_TINY))
        phat, _, _, _ = _target(geo, -px.rd, px.local, config.mat_types, y_pos,
                                es.light_normal, es.radiance)
        valid = (es.pdf > 0.0) & (parea > _TINY)
        w = torch.where(valid, phat / torch.clamp(parea, min=_TINY), 0.0)
        r = r.update(u_res, y_pos, es.light_normal, es.radiance, parea, w, phat, ones)
    return r


def _round(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """x as the control holds it: rounded to bfloat16 (float32 otherwise)."""
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def _tap_ids(pix, seed, config, m_candidates, spatial_taps, spatial_radius):
    """The pixels each spatial tap of ``pix`` reads, and its draw u3 (the
    draws after a pixel's 2 jitter, 4 M candidate and 1 temporal draws)."""
    w, h = config.width, config.height
    state, _ = rng.next_floats(rng.tea_init(pix, seed), 2 + 4 * m_candidates + 1)
    x, y = pix % w, torch.div(pix, w, rounding_mode="floor")
    taps = []
    for _ in range(spatial_taps):
        state, (u1, u2, u3) = rng.next_floats(state, 3)
        dx = torch.floor((u1 * 2.0 - 1.0) * spatial_radius).to(torch.int64)
        dy = torch.floor((u2 * 2.0 - 1.0) * spatial_radius).to(torch.int64)
        taps.append((torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1), u3))
    return taps


def restir_pixels(data, config, camera, seed: int, prev_rows: torch.Tensor, pix,
                  m_candidates: int, spatial_taps: int, spatial_radius: int,
                  m_cap: float = 20.0, lowp: bool = False) -> dict:
    """One ReSTIR DI frame at pixels ``pix`` (ids on the film, row-major
    from the film's row 0) at ``seed``, from the frame's input rows
    ``prev_rows`` ((W*H, 19), the previous frame's output; None: zeros, as
    after a reset). Returns the pixels' radiance ``(P, 3)``, output rows
    ``(P, 19)`` and whether each has a primary hit (``hit``). With ``lowp``
    every reservoir row read or written and the radiance are held in
    bfloat16 (the comparison's control)."""
    em, tex = data.emitters, data.textures
    dev = data.tris.packed.device
    pix = torch.as_tensor(np.asarray(pix), dtype=torch.int64, device=dev)
    n = pix.shape[0]
    cap = m_cap * float(m_candidates)
    zero3 = Vec3.zeros(n, device=dev)
    areas = config.emitter_count > 0

    # with area lights, the pre-spatial reservoirs of the pixels and of
    # every pixel they tap, worked out once
    taps = _tap_ids(pix, seed, config, m_candidates, spatial_taps, spatial_radius) \
        if areas else []
    px = _primary(data, config, camera, seed, pix)
    geo, active = px.geo, px.hit.hit_mask

    radiance = zero3
    if config.has_env:
        env_rad0, _ = emitter_mod.eval_env(em, tex, config, px.rd)
        radiance = radiance + where(~active, env_rad0, zero3)
    radiance = radiance + where(active & (geo.emitter_id >= 0) & geo.front,
                                _first_hit_emission(data, config, geo), zero3)

    if areas:
        lanes = torch.unique(torch.cat([pix] + [t for t, _ in taps]))
        px_all = _primary(data, config, camera, seed, lanes)
        r_all = _candidates(data, config, px_all, m_candidates)
        px_all.state, (u_t,) = rng.next_floats(px_all.state, 1)
        prev = (torch.zeros((lanes.shape[0], N_PACK), dtype=torch.float32, device=dev)
                if prev_rows is None else prev_rows[lanes])
        r_prev, p_pos, p_nrm = _unpack(_round(prev, lowp))
        ok = _similar(px_all.geo, p_pos, p_nrm) & px_all.hit.hit_mask & (r_prev.m > 0.0)
        r_all = _merge(r_all, r_prev, px_all, config, u_t, ok, cap)
        rows = _round(_pack(r_all, px_all.geo), lowp)

        # spatial reuse: each tap merges a neighbour's pre-spatial reservoir
        r, _, _ = _unpack(rows[torch.searchsorted(lanes, pix)])
        for t, u3 in taps:
            r_n, n_pos, n_nrm = _unpack(rows[torch.searchsorted(lanes, t)])
            ok = _similar(geo, n_pos, n_nrm) & active & (r_n.m > 0.0)
            r = _merge(r, r_n, px, config, u3, ok, cap)
        out_rows = _round(_pack(r, geo), lowp)

        # the winner: one shadow ray
        phat, contrib, wi, dist = _target(geo, -px.rd, px.local, config.mat_types, r.y_pos,
                                          r.y_nrm, r.y_rad)
        live = active & (r.w_sum > 0.0) & (phat > _TINY)
        tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
        occluded = intersect_any(geo.position, wi, tmin, dist - RAY_OFFSET, data, config,
                                 mask=live)
        radiance = radiance + where(live & ~occluded, contrib * r.ucw, zero3)
        # the pixels' streams past their candidate, temporal and tap draws
        px.state, _ = rng.next_floats(px.state, 4 * m_candidates + 1 + 3 * spatial_taps)
    else:
        out_rows = (torch.zeros((n, N_PACK), dtype=torch.float32, device=dev)
                    if prev_rows is None else _round(prev_rows[pix], lowp))

    if config.has_env:
        px.state, (u1, u2) = rng.next_floats(px.state, 2)
        es = emitter_mod._env_sample_direct(em, tex, config, geo.position, geo.normal, u1, u2)
        f, _ = bsdf_mod.evaluate(px.local, to_local(-px.rd, geo.normal),
                                 to_local(es["wi"], geo.normal), config.mat_types)
        nol = geo.normal.dot(es["wi"])
        need = active & (es["pdf"] > 0.0) & (nol > 0.0)
        tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
        tmax = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
        occ = intersect_any(geo.position, es["wi"], tmin, tmax, data, config, mask=need)
        scale = nol / torch.clamp(es["pdf"], min=_TINY)
        radiance = radiance + where(need & ~occ, es["radiance"] * f * scale, zero3)
    return {"radiance": _round(radiance.to_array(), lowp), "rows": out_rows, "hit": active}


def blend_frames(frames, lowp: bool = False) -> torch.Tensor:
    """The progressive 1/(n+1) blend of a run of frames' radiance from count
    0 (in bfloat16 with ``lowp``)."""
    dtype = torch.bfloat16 if lowp else torch.float32
    acc = frames[0].to(dtype).clone()
    for n, rad in enumerate(frames[1:], start=1):
        t = float(np.float32(1.0) / (np.float32(n) + np.float32(1.0)))
        acc = acc + (rad.to(dtype) - acc) * t
    return acc.float()
