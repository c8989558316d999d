"""Device emitter sampling/eval over the flattened EmitterTable (planes).

Mirrors pupiloptixlab_tpu/render/emitter.py (render/emitter.h +
emitter/{area,sphere,env}.h parity): selection by the per-emitter CDF
with environment fallback, triangle-area / sphere / point / directional
SampleDirect and Eval, envmap importance sampling over the row and column
CDFs (both inverted by ``count_less``: the row CDF shared by every lane,
the column CDF in the sampled row), and the constant env with its true
1/2pi sampling density.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark.reference.accel.gather import count_less, gather_cols, gather_fields
from benchmark.reference.flatten.types import (
    EM_AREA,
    EM_ETYPE,
    EM_RAD_TEX,
    EM_RADIUS,
    EM_SELECT_PROB,
    EM_V0N,
    EM_V0P,
    EM_V0T,
    EM_V1N,
    EM_V1P,
    EM_V1T,
    EM_V2N,
    EM_V2P,
    EM_V2T,
    TEX_OFFSET,
    EmitterTable,
    RenderConfig,
    TextureTable,
)
from benchmark.reference.render.sampling import (
    MAX_DISTANCE,
    luminance,
    sphere_texcoord,
    to_world,
    uniform_hemisphere_pdf,
    uniform_sample_hemisphere,
    uniform_sample_sphere,
    uniform_sample_triangle,
)
from benchmark.reference.render.texture import gather_texture, sample_texture_cols
from benchmark.reference.render.vec import Vec2, Vec3, where, where2


@dataclass
class EmitterSample:
    """EmitterSampleRecord analog (per-lane)."""

    wi: Vec3                   # direction toward the light
    distance: torch.Tensor     # (N,)
    radiance: Vec3
    pdf: torch.Tensor          # (N,) solid-angle pdf (0 when invalid)
    select_prob: torch.Tensor  # (N,)
    is_delta: torch.Tensor     # (N,) bool
    light_normal: Vec3         # sampled light-surface normal (-wi for env/delta)


def select_emitter(em: EmitterTable, config: RenderConfig, u: torch.Tensor):
    """CDF walk: first i with u <= cdf[i]; env if beyond all areas.
    Returns (index (N,) into areas, use_env (N,) bool)."""
    n_area = config.emitter_count
    if n_area == 0:
        idx = torch.zeros_like(u, dtype=torch.int32)
        use_env = torch.full_like(u, config.has_env, dtype=torch.bool)
        return idx, use_env
    cdf = em.select_cdf[:n_area]
    idx = count_less(cdf, u)
    overflow = idx >= n_area
    use_env = overflow if config.has_env else torch.zeros_like(overflow)
    idx = torch.clamp(idx, max=n_area - 1)
    return idx, use_env


def _vec(row, s: slice) -> Vec3:
    return Vec3(row[s.start], row[s.start + 1], row[s.start + 2])


def sample_direct(
    em: EmitterTable,
    tex: TextureTable,
    config: RenderConfig,
    idx: torch.Tensor,
    use_env: torch.Tensor,
    hit_pos: Vec3,
    hit_normal: Vec3,
    u1: torch.Tensor,
    u2: torch.Tensor,
    allow_env: bool = True,
) -> EmitterSample:
    """``allow_env=False`` promises every lane has use_env=False and skips
    the env CDF inversion."""
    has_env = config.has_env and allow_env
    # one gather for the emitter record: columns 0..EM_ETYPE, all it reads
    row = gather_cols(em.packed, idx, cols=tuple(range(EM_ETYPE + 1)))
    select_prob = row[EM_SELECT_PROB]
    if config.emitter_count == 0 or has_env:
        select_prob = torch.where(use_env, em.env_select_prob, select_prob)

    # --- triangle area emitter (area.h:17-35) -------------------------------
    bary = uniform_sample_triangle(u1, u2)
    pos = _vec(row, EM_V0P) * bary.x + _vec(row, EM_V1P) * bary.y + _vec(row, EM_V2P) * bary.z
    nrm = (
        _vec(row, EM_V0N) * bary.x + _vec(row, EM_V1N) * bary.y + _vec(row, EM_V2N) * bary.z
    ).normalized()
    uv = Vec2(
        row[EM_V0T.start] * bary.x + row[EM_V1T.start] * bary.y + row[EM_V2T.start] * bary.z,
        row[EM_V0T.start + 1] * bary.x
        + row[EM_V1T.start + 1] * bary.y
        + row[EM_V2T.start + 1] * bary.z,
    )

    if config.has_sphere_emitter:
        # --- sphere emitter (sphere.h:15-33) ---------------------------------
        is_tri = row[EM_ETYPE] == 0.0
        sph_dir = uniform_sample_sphere(u1, u2)
        pos_sph = sph_dir * row[EM_RADIUS] + _vec(row, EM_V0P)
        uv_sph = sphere_texcoord(sph_dir)
        pos = where(is_tri, pos, pos_sph)
        nrm = where(is_tri, nrm, sph_dir)
        uv = where2(is_tri, uv, uv_sph)

    tex_cols = gather_texture(tex, row[EM_RAD_TEX].to(torch.int32), config.em_tex_kinds,
                              config.em_tex_filters)
    radiance = sample_texture_cols(
        tex_cols, tex.pool, uv, config.em_tex_kinds, config.em_tex_filters,
        tex.pool_bi,
    )
    delta = pos - hit_pos
    dist = delta.length()
    wi = delta * torch.reciprocal(torch.clamp(dist, min=1e-20))
    nol = hit_normal.dot(wi)
    lnol = nrm.dot(-wi)
    valid = (nol > 0.0) & (lnol > 0.0)
    pdf = torch.where(
        valid, dist * dist / torch.clamp(lnol * row[EM_AREA], min=1e-20), 0.0
    )

    # --- delta lights: point (etype 2) / directional (etype 3) -------------
    is_delta = torch.zeros_like(u1, dtype=torch.bool)
    if config.has_point_emitter:
        isp = row[EM_ETYPE] == 2.0
        # radiance slot holds the radiant intensity (W/sr) -> I / r^2
        ppos = _vec(row, EM_V0P)
        pd = ppos - hit_pos
        pdist = pd.length()
        wi = where(isp, pd * torch.reciprocal(torch.clamp(pdist, min=1e-20)), wi)
        dist = torch.where(isp, pdist, dist)
        radiance = where(
            isp, radiance * torch.reciprocal(torch.clamp(pdist * pdist, min=1e-20)),
            radiance,
        )
        pdf = torch.where(isp, 1.0, pdf)
        is_delta = is_delta | isp
    if config.has_directional_emitter:
        isd = row[EM_ETYPE] == 3.0
        # EM_V0N is the light's travel direction -> wi points against it
        wi = where(isd, -_vec(row, EM_V0N), wi)
        dist = torch.where(isd, MAX_DISTANCE, dist)
        pdf = torch.where(isd, 1.0, pdf)
        is_delta = is_delta | isd

    # --- environment ----------------------------------------------------------
    if has_env:
        env = _env_sample_direct(em, tex, config, hit_pos, hit_normal, u1, u2)
        wi = where(use_env, env["wi"], wi)
        dist = torch.where(use_env, env["distance"], dist)
        radiance = where(use_env, env["radiance"], radiance)
        pdf = torch.where(use_env, env["pdf"], pdf)
        if config.has_point_emitter or config.has_directional_emitter:
            is_delta = is_delta & ~use_env

    if has_env:
        nrm = where(use_env, -wi, nrm)
    return EmitterSample(
        wi=wi,
        distance=dist,
        radiance=radiance,
        pdf=pdf,
        select_prob=select_prob,
        is_delta=is_delta,
        light_normal=where(is_delta, -wi, nrm) if (
            config.has_point_emitter or config.has_directional_emitter
        ) else nrm,
    )


def _env_sample_direct(em, tex, config, hit_pos: Vec3, hit_normal: Vec3, u1, u2):
    w, h = config.env_size
    n = u1.shape[0]
    if w == 0:  # const env (env.h:69-79)
        local = uniform_sample_hemisphere(u1, u2)
        wi = to_world(local, hit_normal)
        return {
            "wi": wi,
            "distance": torch.full_like(u1, MAX_DISTANCE),
            "radiance": Vec3.broadcast(em.env_color, n),
            "pdf": uniform_hemisphere_pdf(local),
        }
    # envmap importance sampling (env.h:24-48): the row CDF with u1, then
    # that row's column CDF with u2, each a count of the entries below the
    # draw (the column count searches each lane's own row of the (h, w+1)
    # table; every row is nondecreasing)
    row = torch.clamp(count_less(em.env_row_cdf, u1) - 1, 0, h - 1)
    col = torch.clamp(count_less(em.env_col_cdf, u2, rows=row) - 1, 0, w - 1)

    phi = col.to(torch.float32) * (2.0 * math.pi / w)
    theta = row.to(torch.float32) * (math.pi / h)
    row_c = torch.clamp(row, 0, h - 1)
    sin_t = torch.sin(theta)
    local_wi = Vec3(
        sin_t * torch.sin(math.pi - phi), torch.cos(theta), sin_t * torch.cos(math.pi - phi)
    )
    m = em.env_to_world
    wi = Vec3(
        m[0, 0] * local_wi.x + m[0, 1] * local_wi.y + m[0, 2] * local_wi.z,
        m[1, 0] * local_wi.x + m[1, 1] * local_wi.y + m[1, 2] * local_wi.z,
        m[2, 0] * local_wi.x + m[2, 1] * local_wi.y + m[2, 2] * local_wi.z,
    )
    # radiance of the CDF-chosen texel straight from the pixel pool, so
    # radiance and pdf refer to the same texel
    offset = gather_cols(tex.packed, em.env_radiance_tex.reshape(1), cols=(TEX_OFFSET,))[0]
    texel = offset.to(torch.int32) + row_c * w + col
    pool_cols = gather_cols(tex.pool, texel)
    radiance = Vec3(pool_cols[0], pool_cols[1], pool_cols[2]) * em.env_scale
    row_w = gather_cols(em.env_row_weight[:, None], row_c)[0]
    pdf = (
        luminance(radiance)
        * row_w
        * em.env_normalization
        / torch.clamp(torch.abs(sin_t), min=1e-4)
    )
    return {
        "wi": wi,
        "distance": torch.full_like(u1, MAX_DISTANCE),
        "radiance": radiance,
        "pdf": torch.clamp(pdf, min=0.0),
    }


def eval_hit_emitter(
    em: EmitterTable,
    tex: TextureTable,
    config: RenderConfig,
    emitter_id: torch.Tensor,
    hit_pos: Vec3,
    hit_normal: Vec3,
    hit_uv: Vec2,
    scatter_pos: Vec3,
):
    """Area-emitter Eval at a BSDF-sampled hit (area.h:37-46); returns
    (radiance Vec3, pdf (N,), select_prob (N,)); valid where
    emitter_id >= 0."""
    idx = torch.clamp(emitter_id, min=0)
    row = gather_fields(em.packed, idx, (EM_AREA, EM_SELECT_PROB, EM_RAD_TEX))
    dir_to_scatter = (scatter_pos - hit_pos).normalized()
    lnol = hit_normal.dot(dir_to_scatter)
    dist = (scatter_pos - hit_pos).length()
    pdf = torch.where(
        lnol > 0.0, dist * dist / torch.clamp(lnol * row[EM_AREA], min=1e-20), 0.0
    )
    tex_cols = gather_texture(tex, row[EM_RAD_TEX].to(torch.int32), config.em_tex_kinds,
                              config.em_tex_filters)
    radiance = sample_texture_cols(
        tex_cols, tex.pool, hit_uv, config.em_tex_kinds, config.em_tex_filters,
        tex.pool_bi,
    )
    ok = emitter_id >= 0
    return (
        where(ok, radiance, Vec3.zeros(idx.shape[0], device=idx.device)),
        torch.where(ok, pdf, 0.0),
        row[EM_SELECT_PROB],
    )


def eval_env(
    em: EmitterTable,
    tex: TextureTable,
    config: RenderConfig,
    ray_dir: Vec3,
):
    """Environment Eval along escaped rays (env.h:51-64 / 81-85); returns
    (radiance Vec3, pdf (N,))."""
    n = ray_dir.x.shape[0]
    dev = ray_dir.x.device
    if not config.has_env:
        return Vec3.zeros(n, device=dev), torch.zeros(n, dtype=torch.float32, device=dev)
    w, h = config.env_size
    if w == 0:  # const env: the true uniform-hemisphere density 1/2pi
        return (
            Vec3.broadcast(em.env_color, n),
            torch.full((n,), 0.5 / math.pi, dtype=torch.float32, device=dev),
        )
    m = em.env_to_local
    d = Vec3(
        m[0, 0] * ray_dir.x + m[0, 1] * ray_dir.y + m[0, 2] * ray_dir.z,
        m[1, 0] * ray_dir.x + m[1, 1] * ray_dir.y + m[1, 2] * ray_dir.z,
        m[2, 0] * ray_dir.x + m[2, 1] * ray_dir.y + m[2, 2] * ray_dir.z,
    )
    phi = math.pi - torch.atan2(d.x, d.z)
    theta = torch.acos(torch.clamp(d.y, -1.0, 1.0))
    uv = Vec2(phi * 0.5 / math.pi, theta / math.pi)
    tex_cols = gather_texture(tex, em.env_radiance_tex.reshape(1), (2,), (config.env_filter,),
                              n=n)
    radiance = (
        sample_texture_cols(
            tex_cols, tex.pool, uv, (2,), (config.env_filter,), tex.pool_bi
        )
        * em.env_scale
    )
    rowf = uv.y * h
    row = torch.clamp(rowf.to(torch.int32), 0, h - 2)
    frac = rowf - row.to(torch.float32)
    if h > 1:
        pairs = em.env_row_weight.unfold(0, 2, 1)  # (h-1, 2) view: rows i, i+1
        w_pair = gather_cols(pairs, row)
        weight = w_pair[0] * (1.0 - frac) + w_pair[1] * frac
    else:
        weight = em.env_row_weight[0].expand(n)
    pdf = (
        luminance(radiance)
        * weight
        * em.env_normalization
        / torch.clamp(torch.abs(torch.sin(theta)), min=1e-4)
    )
    return radiance, pdf
