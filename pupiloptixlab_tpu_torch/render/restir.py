"""ReSTIR direct illumination (reservoir spatio-temporal resampling).

Mirrors pupiloptixlab_tpu/render/restir.py (Bitterli et al. 2020 over
plane tensors): a Reservoir is a handful of dense (N,) planes; M
area-light candidates a pixel stream through it (a Python loop over the
static M), the previous frame's reservoir merges in (identity warp,
similarity-gated, M-capped), K random neighbours merge in, and only the
winner traces a shadow ray. Merges re-evaluate the target at the
receiving pixel in the area measure, where they need no Jacobian. An
environment light, when present, adds one ordinary NEE sample on top.

Rays go through ``intersect_closest`` / ``intersect_any`` (the traversal
and sweep kernels), table lookups through the gather and count kernels;
the rest is elementwise plain PyTorch. The reference's sort hint for its
Pallas sweeps (``origin_sort_prim``) has no counterpart: the port's
intersection takes none.

``restir_frame``'s stages are profiler ranges (``restir.gbuffer``,
``restir.candidates``, ``restir.temporal``, ``restir.spatial``,
``restir.shade``, ``restir.env``, ``restir.blend``). ``RESTIR_STATS``
counts a frame's work and times its stages while its ``"enabled"`` is set
(off by default; then a frame issues no event, synchronisation or
operation for it).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

from pupiloptixlab_tpu_torch.accel.intersect import intersect_any, intersect_closest
from pupiloptixlab_tpu_torch.flatten.types import RenderConfig, SceneData
from pupiloptixlab_tpu_torch.render import bsdf as bsdf_mod
from pupiloptixlab_tpu_torch.render import emitter as emitter_mod
from pupiloptixlab_tpu_torch.render import rng
from pupiloptixlab_tpu_torch.render.camera import generate_rays
from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
from pupiloptixlab_tpu_torch.render.integrator import _first_hit_emission, blend
from pupiloptixlab_tpu_torch.render.sampling import (
    MAX_DISTANCE,
    RAY_OFFSET,
    luminance,
    to_local,
)
from pupiloptixlab_tpu_torch.render.vec import Vec3, where
from pupiloptixlab_tpu_torch.utils.profiling import annotate

_TINY = 1e-12

# The last restir_frame's work while ``RESTIR_STATS["enabled"]``: the
# candidates streamed (pixels x M), the merges tried (pixels x (1 + taps)),
# the winners' shadow rays and the environment sample's shadow rays issued
# (lanes their masks let through), and ``stage_ms``, each stage's ms on the
# stream's clock (a CUDA event pair a stage, read once the frame has ended,
# which costs the frame a synchronisation; the host's clock on the CPU).
RESTIR_STATS: dict = {"enabled": False}

STAGES = ("restir.gbuffer", "restir.candidates", "restir.temporal", "restir.spatial",
          "restir.shade", "restir.env", "restir.blend")


class _StageClock:
    """The stage times and counts of one frame while RESTIR_STATS is on."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: dict = {}    # stage -> (start, end): events, or host seconds
        self.counts: dict = {}   # name -> int, or a 0-dim device tensor until read

    @contextlib.contextmanager
    def span(self, name: str):
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self.marks[name] = (start, end)

    def publish(self) -> None:
        """Read every event and count (after the frame's last operation)
        into RESTIR_STATS."""
        if self.cuda:
            torch.cuda.current_stream().synchronize()
            ms = {k: s.elapsed_time(e) for k, (s, e) in self.marks.items()}
        else:
            ms = {k: (e - s) * 1e3 for k, (s, e) in self.marks.items()}
        RESTIR_STATS.clear()
        RESTIR_STATS.update({k: int(v) for k, v in self.counts.items()},
                            enabled=True, stage_ms=ms)


@contextlib.contextmanager
def _stage(name: str, clock: _StageClock | None):
    """A profiler range over one stage of the frame, timed while the stats
    are on."""
    with annotate(name):
        if clock is None:
            yield
        else:
            with clock.span(name):
                yield


@dataclass
class Reservoir:
    """Per-pixel weighted reservoir (all (N,) planes)."""

    y_pos: Vec3      # winning light sample position
    y_nrm: Vec3      # its stored surface normal
    y_rad: Vec3      # its radiance toward the receiver
    y_parea: torch.Tensor  # its source pdf in area measure (incl. select prob)
    w_sum: torch.Tensor    # running sum of resampling weights
    m: torch.Tensor        # candidate count seen
    phat: torch.Tensor     # target value of y at the owning pixel

    @staticmethod
    def zeros(n: int, device=None) -> "Reservoir":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        z3 = Vec3.zeros(n, device=device)
        return Reservoir(y_pos=z3, y_nrm=z3, y_rad=z3, y_parea=z, w_sum=z, m=z, phat=z)

    def update(self, u, pos, nrm, rad, parea, w, phat, count):
        """Stream one candidate (weight w, target phat) into the
        reservoir; ``count`` is how many effective candidates it
        represents (1 for fresh samples, r.m for merges)."""
        w_sum = self.w_sum + w
        take = (u * torch.clamp(w_sum, min=_TINY)) < w
        return Reservoir(
            y_pos=where(take, pos, self.y_pos),
            y_nrm=where(take, nrm, self.y_nrm),
            y_rad=where(take, rad, self.y_rad),
            y_parea=torch.where(take, parea, self.y_parea),
            w_sum=w_sum,
            m=self.m + count,
            phat=torch.where(take, phat, self.phat),
        )

    @property
    def ucw(self) -> torch.Tensor:
        """Unbiased contribution weight W = w_sum / (m * phat(y))."""
        return self.w_sum / torch.clamp(self.m * self.phat, min=_TINY)


@dataclass
class _GBuf:
    position: Vec3
    normal: Vec3
    wo_world: Vec3


def _eval_target(geo, local, mat_types, y_pos: Vec3, y_nrm: Vec3, y_rad: Vec3):
    """p_hat(x, y) = lum(f * L * cos_x * cos_L / d^2) in area measure, and
    the pieces shading needs. Unshadowed (visibility is the winner's)."""
    delta = y_pos - geo.position
    d2 = torch.clamp(delta.dot(delta), min=_TINY)
    dist = torch.sqrt(d2)
    wi = delta * (1.0 / dist)
    wo_local = to_local(geo.wo_world, geo.normal)
    wi_local = to_local(wi, geo.normal)
    f, _ = bsdf_mod.evaluate(local, wo_local, wi_local, mat_types)
    cos_x = torch.clamp(geo.normal.dot(wi), min=0.0)
    cos_l = torch.clamp(y_nrm.dot(-wi), min=0.0)
    g = cos_x * cos_l / d2
    contrib = f * y_rad * g
    return luminance(contrib), contrib, wi, dist


def _draw4(state):
    return rng.next_floats(state, 4)


def initial_candidates(scene: SceneData, config: RenderConfig, geo, local, wo_world: Vec3,
                       state, m_candidates: int):
    """M area-light candidates a pixel streamed into a fresh reservoir.
    Returns (state', reservoir, gbuf)."""
    em, tex = scene.emitters, scene.textures
    n = geo.position.x.shape[0]
    dev = geo.position.x.device
    gb = _GBuf(position=geo.position, normal=geo.normal, wo_world=wo_world)
    r = Reservoir.zeros(n, device=dev)
    # candidates are area lights only, so the selection is the conditional
    # area distribution: u_sel squeezed into the area CDF's range
    # [0, 1 - env_select_prob), the select probability divided by the area mass
    area_mass = (torch.clamp(1.0 - em.env_select_prob, min=_TINY)
                 if config.has_env else 1.0)
    no_env = torch.zeros(n, dtype=torch.bool, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(m_candidates):
        state, (u_sel, u1, u2, u_res) = _draw4(state)
        idx, _ = emitter_mod.select_emitter(em, config, u_sel * area_mass)
        es = emitter_mod.sample_direct(
            em, tex, config, idx, no_env, geo.position, geo.normal, u1, u2,
            allow_env=False,
        )
        # solid angle -> area measure: p_area = p_solid * cos_L / d^2
        y_pos = geo.position + es.wi * es.distance
        y_nrm = es.light_normal
        cos_l = torch.clamp(y_nrm.dot(-es.wi), min=0.0)
        sel_prob = es.select_prob / area_mass
        parea = es.pdf * sel_prob * cos_l / torch.clamp(es.distance * es.distance, min=_TINY)
        phat, _, _, _ = _eval_target(gb, local, config.mat_types, y_pos, y_nrm, es.radiance)
        valid = (es.pdf > 0.0) & (parea > _TINY)
        w = torch.where(valid, phat / torch.clamp(parea, min=_TINY), 0.0)
        r = r.update(u_res, y_pos, y_nrm, es.radiance, parea, w, phat, ones)
    return state, r, gb


def merge(r: Reservoir, other: Reservoir, gb: _GBuf, local, mat_types, u: torch.Tensor,
          ok: torch.Tensor, m_cap: float) -> Reservoir:
    """Merge ``other`` (a neighbour's or last frame's reservoir) into ``r``,
    re-evaluating the target at r's pixel (Bitterli alg. 4). ``ok`` masks
    dissimilar neighbours; ``m_cap`` clamps the history length."""
    m_o = torch.clamp(other.m, max=m_cap) * ok.to(torch.float32)
    phat_here, _, _, _ = _eval_target(gb, local, mat_types, other.y_pos, other.y_nrm,
                                      other.y_rad)
    w = phat_here * other.ucw * m_o
    return r.update(u, other.y_pos, other.y_nrm, other.y_rad, other.y_parea, w,
                    phat_here, m_o)


def shade(scene: SceneData, config: RenderConfig, r: Reservoir, gb: _GBuf, local,
          hit_mask: torch.Tensor, clock: _StageClock | None = None) -> Vec3:
    """Shade the reservoir's winner with one shadow ray a pixel (counted
    on ``clock`` where one is given)."""
    n = r.w_sum.shape[0]
    dev = r.w_sum.device
    phat, contrib, wi, dist = _eval_target(gb, local, config.mat_types, r.y_pos, r.y_nrm,
                                           r.y_rad)
    live = hit_mask & (r.w_sum > 0.0) & (phat > _TINY)
    tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
    occluded = intersect_any(gb.position, wi, tmin, dist - RAY_OFFSET, scene, config,
                             mask=live)
    if clock is not None:
        clock.counts["shadow_rays"] = live.sum()
    take = live & ~occluded
    return where(take, contrib * r.ucw, Vec3.zeros(n, device=dev))


def similarity(gb: _GBuf, n_pos: Vec3, n_nrm: Vec3) -> torch.Tensor:
    """Geometric similarity gate of spatial/temporal reuse: normals within
    ~25 degrees and distance within 10% of the scene scale proxy (|x|)."""
    ndot = gb.normal.dot(n_nrm)
    dp = gb.position - n_pos
    d2 = dp.dot(dp)
    scale = torch.clamp(gb.position.dot(gb.position), min=1.0)
    return (ndot > 0.906) & (d2 < 0.01 * scale)


# -- full-frame ReSTIR-DI estimator ------------------------------------------

N_PACK = 19  # packed reservoir row: 13 reservoir + 3 gb pos + 3 gb normal


def _pack(r: Reservoir, gb: _GBuf) -> torch.Tensor:
    """Reservoir + G-buffer as one (N, 19) row table, so that a spatial or
    temporal tap is one row gather."""
    return torch.stack(
        [
            r.y_pos.x, r.y_pos.y, r.y_pos.z,
            r.y_nrm.x, r.y_nrm.y, r.y_nrm.z,
            r.y_rad.x, r.y_rad.y, r.y_rad.z,
            r.y_parea, r.w_sum, r.m, r.phat,
            gb.position.x, gb.position.y, gb.position.z,
            gb.normal.x, gb.normal.y, gb.normal.z,
        ],
        dim=1,
    )


def _unpack(rows: torch.Tensor):
    c = [rows[:, i] for i in range(N_PACK)]
    r = Reservoir(
        y_pos=Vec3(c[0], c[1], c[2]),
        y_nrm=Vec3(c[3], c[4], c[5]),
        y_rad=Vec3(c[6], c[7], c[8]),
        y_parea=c[9], w_sum=c[10], m=c[11], phat=c[12],
    )
    return r, Vec3(c[13], c[14], c[15]), Vec3(c[16], c[17], c[18])


def primary_gbuffer(scene: SceneData, camera, seed: int, config: RenderConfig):
    """Row-major camera rays at ``seed`` (two jitter draws a pixel), their
    closest hits and shading frames: (state, rd, hit, geo, local, tmin)."""
    w, h = config.width, config.height
    n = w * h
    dev = scene.tris.packed.device
    state = rng.tea_init(torch.arange(n, dtype=torch.int64, device=dev), seed)
    state, (jx, jy) = rng.next_floats(state, 2)
    ro, rd = generate_rays(camera, w, h, jx, jy)
    tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    hit = intersect_closest(ro, rd, tmin, tmax, scene, config)
    geo = get_local_geometry(scene, hit, ro, rd, config.sphere_count, config.instanced,
                             config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        scene.materials, scene.textures, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    return state, rd, hit, geo, local, tmin


def pixel_xy(config: RenderConfig, device):
    """(N,) int32 column and row of each row-major pixel."""
    w = config.width
    idx = torch.arange(config.width * config.height, dtype=torch.int32, device=device)
    return idx % w, torch.div(idx, w, rounding_mode="floor")


def spatial_taps_rows(packed0: torch.Tensor, px, py, u1, u2, radius, w: int, h: int):
    """One spatial tap a pixel: the packed rows at a random offset within
    ``radius`` (a number or an (N,) tensor), clamped to the film."""
    dx = torch.floor((u1 * 2.0 - 1.0) * radius).to(torch.int32)
    dy = torch.floor((u2 * 2.0 - 1.0) * radius).to(torch.int32)
    nx = torch.clamp(px + dx, 0, w - 1)
    ny = torch.clamp(py + dy, 0, h - 1)
    return packed0[(ny * w + nx).long()]


@torch.inference_mode()
def restir_frame(
    scene: SceneData,
    camera,
    seed: int,
    prev_packed: torch.Tensor,
    accum: torch.Tensor,
    sample_cnt: int,
    config: RenderConfig,
    m_candidates: int = 8,
    spatial_taps: int = 3,
    spatial_radius: int = 16,
    m_cap: float = 20.0,
):
    """One ReSTIR-DI frame: primary hit -> M candidates -> temporal merge
    -> K spatial merges -> 1 winner shadow ray -> shade + accumulate.

    ``prev_packed`` ((N, 19), last frame's packed reservoirs) is read and
    not written; ``accum`` ((N, 3)) is blended in place, as ``render_frame``
    does (the reference donates both). Returns (accum, packed', frame_rgb):
    packed' is a new tensor, or ``prev_packed`` itself on a scene without
    area lights. Temporal reuse is identity-warped (static camera); the
    pass resets the history on camera or scene edits."""
    em, tex = scene.emitters, scene.textures
    w, h = config.width, config.height
    n = w * h
    dev = scene.tris.packed.device
    clock = _StageClock(dev) if RESTIR_STATS["enabled"] else None
    with _stage("restir.gbuffer", clock):
        state, rd, hit, geo, local, tmin = primary_gbuffer(scene, camera, seed, config)
        zero3 = Vec3.zeros(n, device=dev)
        active = hit.hit_mask
        radiance = zero3

        # directly visible lights / environment (as the PT first hit)
        if config.has_env:
            env_rad0, _ = emitter_mod.eval_env(em, tex, config, rd)
            radiance = radiance + where(~active, env_rad0, zero3)
        is_emitter = active & (geo.emitter_id >= 0) & geo.front
        radiance = radiance + where(is_emitter, _first_hit_emission(scene, config, geo), zero3)

    cap = m_cap * float(m_candidates)
    if config.emitter_count > 0:
        with _stage("restir.candidates", clock):
            state, r, gb = initial_candidates(scene, config, geo, local, -rd, state,
                                              m_candidates)

        # temporal merge (identity warp; similarity-gated, M-capped)
        with _stage("restir.temporal", clock):
            state, (u_t,) = rng.next_floats(state, 1)
            r_prev, p_pos, p_nrm = _unpack(prev_packed)
            ok_t = similarity(gb, p_pos, p_nrm) & active & (r_prev.m > 0.0)
            r = merge(r, r_prev, gb, local, config.mat_types, u_t, ok_t, cap)

        # spatial merges: per-pixel random neighbour taps
        with _stage("restir.spatial", clock):
            packed0 = _pack(r, gb)
            px, py = pixel_xy(config, dev)
            for _ in range(spatial_taps):
                state, (u1, u2, u3) = rng.next_floats(state, 3)
                rows = spatial_taps_rows(packed0, px, py, u1, u2, spatial_radius, w, h)
                r_n, n_pos, n_nrm = _unpack(rows)
                ok_s = similarity(gb, n_pos, n_nrm) & active & (r_n.m > 0.0)
                r = merge(r, r_n, gb, local, config.mat_types, u3, ok_s, cap)
            del packed0
            out_packed = _pack(r, gb)

        with _stage("restir.shade", clock):
            radiance = radiance + shade(scene, config, r, gb, local, active, clock)
        if clock is not None:
            clock.counts.update(candidates=n * m_candidates, merges=n * (1 + spatial_taps))
    else:
        out_packed = prev_packed

    # environment light: one plain NEE sample on top
    if config.has_env:
        with _stage("restir.env", clock):
            state, (u1, u2) = rng.next_floats(state, 2)
            es = emitter_mod._env_sample_direct(em, tex, config, geo.position, geo.normal,
                                                u1, u2)
            wi, pdf = es["wi"], es["pdf"]
            wo_local = to_local(-rd, geo.normal)
            wi_local = to_local(wi, geo.normal)
            f, _ = bsdf_mod.evaluate(local, wo_local, wi_local, config.mat_types)
            nol = geo.normal.dot(wi)
            need = active & (pdf > 0.0) & (nol > 0.0)
            occ = intersect_any(
                geo.position, wi, tmin,
                torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev),
                scene, config, mask=need,
            )
            # the env sample is drawn at every pixel (not selected), so the
            # estimator divides by the raw env pdf only
            scale = nol / torch.clamp(pdf, min=_TINY)
            radiance = radiance + where(need & ~occ, es["radiance"] * f * scale, zero3)
            if clock is not None:
                clock.counts["env_rays"] = need.sum()

    with _stage("restir.blend", clock):
        rad = radiance.to_array()
        blend(accum, rad, sample_cnt, config.accumulate)
    if clock is not None:
        clock.publish()
    return accum, out_packed, rad
