"""Device texture sampling over the dense TextureTable (plane layout).

Mirrors pupiloptixlab_tpu/render/texture.py (cuda::Texture::Sample
parity): uv transform, RGB passthrough, the reference's checkerboard
fract logic, and bitmap fetch with wrap/clamp/mirror addressing and
point/bilinear filtering. Descriptor and pixel fetches are plane gathers
(accel/gather.py). ``kinds``/``filters`` restrict the work to the
texture kinds and filter modes reachable at the call site.
"""

from __future__ import annotations

import torch

import functools

from benchmark.reference.accel.gather import Fields, gather_cols, gather_fields
from benchmark.reference.flatten.types import (
    TEX_ADDRESS,
    TEX_FILTER,
    TEX_H,
    TEX_KIND,
    TEX_OFFSET,
    TEX_OFFSET_BI,
    TEX_PATCH2,
    TEX_RGB,
    TEX_UVT,
    TEX_W,
    TextureTable,
)
from benchmark.reference.render.vec import Vec2, Vec3, where

ALL_KINDS = (0, 1, 2)  # rgb, checkerboard, bitmap


def _address(coord, mode):
    """Normalized-coordinate addressing: 0 wrap, 1 clamp, 2 mirror."""
    wrapped = coord - torch.floor(coord)
    clamped = torch.clamp(coord, 0.0, 1.0)
    m = coord - 2.0 * torch.floor(coord * 0.5)  # period-2 sawtooth in [0,2)
    mirrored = torch.where(m > 1.0, 2.0 - m, m)
    return torch.where(mode == 0, wrapped, torch.where(mode == 1, clamped, mirrored))


def _fetch(pool, offset, w, h, ix, iy) -> Vec3:
    ix = torch.minimum(torch.clamp(ix, min=0), torch.clamp(w - 1, min=0))
    iy = torch.minimum(torch.clamp(iy, min=0), torch.clamp(h - 1, min=0))
    flat = offset + iy * w + ix
    cols = gather_cols(pool, flat)  # (3, N)
    return Vec3(cols[0], cols[1], cols[2])


@functools.lru_cache(maxsize=None)
def texture_cols(kinds: tuple[int, ...] = ALL_KINDS, filters: tuple[int, ...] = (0, 1),
                 quads: bool = True) -> tuple[int, ...]:
    """The TextureTable.packed columns ``sample_texture_cols`` reads for
    these kinds and filters (``quads``: the quad pool is in use), in order:
    all a constant-colour call site reads is TEX_RGB, 3 of 24 columns."""
    cols = set(range(TEX_RGB.start, TEX_RGB.stop))
    if tuple(kinds) != (0,):
        cols |= {TEX_KIND, *range(TEX_UVT.start, TEX_UVT.stop)}
        if 1 in kinds:
            cols |= set(range(TEX_PATCH2.start, TEX_PATCH2.stop))
        if 2 in kinds:
            cols |= {TEX_W, TEX_H, TEX_ADDRESS, TEX_OFFSET}
            if 1 in filters and quads:
                cols.add(TEX_OFFSET_BI)
            if 0 in filters and 1 in filters:
                cols.add(TEX_FILTER)
    return tuple(sorted(cols))


def gather_texture(tex: TextureTable, tex_id: torch.Tensor, kinds: tuple[int, ...],
                   filters: tuple[int, ...], n: int | None = None) -> Fields:
    """The descriptor columns of textures ``tex_id`` that
    ``sample_texture_cols`` reads for ``kinds`` and ``filters``, one K3
    launch; with ``n``, ``tex_id`` is one id that n lanes share."""
    cols = texture_cols(tuple(kinds), tuple(filters), tex.pool_bi.shape[0] > 1)
    return gather_fields(tex.packed, tex_id, cols, n)


def sample_texture_cols(
    cols: torch.Tensor | Fields,
    pool: torch.Tensor,
    uv: Vec2,
    kinds: tuple[int, ...] = ALL_KINDS,
    filters: tuple[int, ...] = (0, 1),
    pool_bi: torch.Tensor | None = None,
) -> Vec3:
    """Sample from pre-gathered packed descriptor columns: (TEX_COLS, N)
    planes, or the ``Fields`` of ``gather_texture`` (``cols[c]`` is column
    c's plane either way).

    ``pool_bi``: the flattener's (Q, 12) quad pool — when present (Q > 1)
    a bilinear fetch is one gather of the packed 2x2 footprint instead of
    four pool gathers; texel values and blend order match the four-fetch
    path bit for bit."""
    rgb = Vec3(cols[TEX_RGB.start], cols[TEX_RGB.start + 1], cols[TEX_RGB.start + 2])
    if tuple(kinds) == (0,):
        return rgb  # constant-color-only call site

    kind = cols[TEX_KIND]
    a, b, c = cols[TEX_UVT.start], cols[TEX_UVT.start + 1], cols[TEX_UVT.start + 2]
    d, e, f = cols[TEX_UVT.start + 3], cols[TEX_UVT.start + 4], cols[TEX_UVT.start + 5]
    u = a * uv.x + b * uv.y + c
    v = d * uv.x + e * uv.y + f

    out = rgb
    if 1 in kinds:
        # checkerboard (cuda/texture.h:42-50): truncate toward 0, wrap
        fu = u - torch.where(u > 0.0, torch.floor(u), torch.ceil(u))
        fv = v - torch.where(v > 0.0, torch.floor(v), torch.ceil(v))
        fu = torch.where(fu < 0.0, fu + 1.0, fu)
        fv = torch.where(fv < 0.0, fv + 1.0, fv)
        patch2 = Vec3(
            cols[TEX_PATCH2.start], cols[TEX_PATCH2.start + 1], cols[TEX_PATCH2.start + 2]
        )
        checker = where((fu > 0.5) == (fv > 0.5), rgb, patch2)
        out = where(kind == 1.0, checker, out)

    if 2 in kinds:
        w = cols[TEX_W]
        h = cols[TEX_H]
        mode = cols[TEX_ADDRESS]
        offset = cols[TEX_OFFSET].to(torch.int32)
        au = _address(u, mode)
        av = _address(v, mode)
        wf = torch.clamp(w, min=1.0)
        hf = torch.clamp(h, min=1.0)
        wi = wf.to(torch.int32)
        hi = hf.to(torch.int32)

        point = linear = None
        if 0 in filters:
            ix = torch.floor(au * wf).to(torch.int32)
            iy = torch.floor(av * hf).to(torch.int32)
            point = _fetch(pool, offset, wi, hi, ix, iy)
        if 1 in filters:
            x = au * wf - 0.5
            y = av * hf - 0.5
            x0 = torch.floor(x)
            y0 = torch.floor(y)
            fx = x - x0
            fy = y - y0
            x0i = x0.to(torch.int32)
            y0i = y0.to(torch.int32)
            if pool_bi is not None and pool_bi.shape[0] > 1:
                offset_bi = cols[TEX_OFFSET_BI].to(torch.int32)
                xq = torch.minimum(torch.clamp(x0i, min=-1), wi - 1) + 1
                yq = torch.minimum(torch.clamp(y0i, min=-1), hi - 1) + 1
                q = gather_cols(pool_bi, offset_bi + yq * (wi + 1) + xq)
                c00 = Vec3(q[0], q[1], q[2])
                c10 = Vec3(q[3], q[4], q[5])
                c01 = Vec3(q[6], q[7], q[8])
                c11 = Vec3(q[9], q[10], q[11])
            else:
                c00 = _fetch(pool, offset, wi, hi, x0i, y0i)
                c10 = _fetch(pool, offset, wi, hi, x0i + 1, y0i)
                c01 = _fetch(pool, offset, wi, hi, x0i, y0i + 1)
                c11 = _fetch(pool, offset, wi, hi, x0i + 1, y0i + 1)
            linear = (
                c00 * ((1 - fx) * (1 - fy))
                + c10 * (fx * (1 - fy))
                + c01 * ((1 - fx) * fy)
                + c11 * (fx * fy)
            )
        if point is None:
            bitmap = linear
        elif linear is None:
            bitmap = point
        else:
            bitmap = where(cols[TEX_FILTER] == 1.0, linear, point)
        out = where(kind == 2.0, bitmap, out)

    return out


def sample_texture(
    tex: TextureTable,
    tex_id: torch.Tensor,
    uv: Vec2,
    kinds: tuple[int, ...] = ALL_KINDS,
    filters: tuple[int, ...] = (0, 1),
) -> Vec3:
    """Sample texture ``tex_id`` (N,) at ``uv`` -> Vec3 linear rgb."""
    cols = gather_texture(tex, tex_id, kinds, filters)
    return sample_texture_cols(cols, tex.pool, uv, kinds, filters, tex.pool_bi)
