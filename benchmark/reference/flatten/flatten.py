"""Scene -> SceneData: host-side flattening to device tables.

Copied from the port's flatten/flatten.py (the world-space triangle soup,
dense material/texture tables, per-triangle area emitters with their
selection probabilities, envmap CDF tables with the env-scale fix in
``env_norm``, Morton order), with the BVH, the instanced tables and the
refit records left out: the reference intersects by brute force, so its
triangle table stays in Morton order. Every table is float32, int32 or
bool, emitted on ``device``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference.scene.emitters import EmitterType
from benchmark.reference.scene.materials import Material, MatType
from benchmark.reference.scene.scene import Scene
from benchmark.reference.scene.shapes import ShapeType
from benchmark.reference.scene.textures import Texture, TextureType
from benchmark.reference.utils.camera import Camera, CameraDesc
from benchmark.reference.utils.math import transform_normals, transform_points
from benchmark.reference.flatten.types import (
    N_SLOTS,
    SLOT_ALPHA,
    SLOT_ETA,
    SLOT_K,
    SLOT_REFLECTANCE,
    SLOT_SPECULAR,
    SLOT_TRANSMITTANCE,
    CameraBlock,
    EmitterTable,
    MaterialTable,
    RenderConfig,
    SceneData,
    Spheres,
    TextureTable,
    TriSoup,
)

_DTYPES = {
    np.dtype(np.float64): torch.float32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _t(a, dtype=None, *, device) -> torch.Tensor:
    """numpy/Python value -> tensor on ``device`` with the reference's
    dtype (64-bit floats and ints narrow to 32 bits, as jnp.asarray does
    with x64 off)."""
    arr = np.asarray(a, dtype=dtype)
    tdt = _DTYPES[arr.dtype]
    return torch.as_tensor(np.array(arr, order="C")).to(device=device, dtype=tdt)


def _luminance(c) -> float:
    return float(0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2])


def _diffuse_fresnel_reflectance(eta: float) -> float:
    """Hemispherical diffuse Fresnel reflectance fits
    (render/material/fresnel.h:58-85: Egan-Hilgeman / d'Eon-Irving)."""
    if eta < 1.0:
        return -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 / eta
    ie = 1.0 / eta
    return (
        0.919317
        - 3.4793 * ie
        + 6.75335 * ie**2
        - 7.80989 * ie**3
        + 4.98554 * ie**4
        - 1.36881 * ie**5
    )


def _quad_pack(pixels: np.ndarray) -> np.ndarray:
    """(h, w, 3) image -> ((h+1)*(w+1), 12) quad rows: row (yq, xq) holds
    the border-clamped 2x2 bilinear footprint [c00 c10 c01 c11] whose
    origin texel is (xq-1, yq-1). Matches render/texture.py's clamped
    four-fetch bit for bit (same texels, same order)."""
    h, w = pixels.shape[:2]
    x0 = np.clip(np.arange(-1, w), 0, w - 1)
    x1 = np.clip(np.arange(-1, w) + 1, 0, w - 1)
    y0 = np.clip(np.arange(-1, h), 0, h - 1)
    y1 = np.clip(np.arange(-1, h) + 1, 0, h - 1)
    c00 = pixels[y0[:, None], x0[None, :]]
    c10 = pixels[y0[:, None], x1[None, :]]
    c01 = pixels[y1[:, None], x0[None, :]]
    c11 = pixels[y1[:, None], x1[None, :]]
    return np.concatenate([c00, c10, c01, c11], axis=-1).reshape(-1, 12)


# Above this many quad rows (~192 MB f32) the quad pool is dropped and
# bilinear fetches fall back to four pool gathers.
_MAX_QUAD_ROWS = 4 * 1024 * 1024


class _TextureBuilder:
    def __init__(self):
        self.kind: list[int] = []
        self.rgb: list[np.ndarray] = []
        self.patch2: list[np.ndarray] = []
        self.uvt: list[np.ndarray] = []
        self.offset: list[int] = []
        self.width: list[int] = []
        self.height: list[int] = []
        self.filter: list[int] = []
        self.address: list[int] = []
        self.pool: list[np.ndarray] = []
        self._pool_size = 0
        self._bitmap_cache: dict[int, int] = {}  # id(data) -> pool offset
        # 2x2 quad pool: one gather per bilinear fetch instead of four
        # (render/texture.py). 3x the pixel memory; capped below.
        self.pool_bi: list[np.ndarray] = []
        self._pool_bi_size = 0
        self._bitmap_bi_cache: dict[int, int] = {}  # id(data) -> quad offset
        self.offset_bi: list[int] = []

    def add(self, tex: Texture) -> int:
        idx = len(self.kind)
        self.kind.append(int(tex.type))
        uvt = np.zeros((2, 3), np.float32)
        uvt[:, :2] = tex.transform.matrix[:2, :2]
        uvt[:, 2] = tex.transform.matrix[:2, 3]
        self.uvt.append(uvt)
        if tex.type == TextureType.RGB:
            self.rgb.append(np.asarray(tex.rgb, np.float32))
            self.patch2.append(np.zeros(3, np.float32))
            self.offset.append(0)
            self.width.append(0)
            self.height.append(0)
            self.filter.append(0)
            self.address.append(0)
            self.offset_bi.append(0)
        elif tex.type == TextureType.CHECKERBOARD:
            self.rgb.append(np.asarray(tex.patch1, np.float32))
            self.patch2.append(np.asarray(tex.patch2, np.float32))
            self.offset.append(0)
            self.width.append(0)
            self.height.append(0)
            self.filter.append(0)
            self.address.append(0)
            self.offset_bi.append(0)
        else:  # bitmap: dedupe pixel blocks by array identity
            key = id(tex.data)
            if key not in self._bitmap_cache:
                self._bitmap_cache[key] = self._pool_size
                pixels = np.ascontiguousarray(tex.data[..., :3], np.float32)
                self.pool.append(pixels.reshape(-1, 3))
                self._pool_size += pixels.shape[0] * pixels.shape[1]
                self._bitmap_bi_cache[key] = self._pool_bi_size
                quads = _quad_pack(pixels)
                self.pool_bi.append(quads)
                self._pool_bi_size += quads.shape[0]
            self.rgb.append(np.zeros(3, np.float32))
            self.patch2.append(np.zeros(3, np.float32))
            self.offset.append(self._bitmap_cache[key])
            self.width.append(tex.width)
            self.height.append(tex.height)
            self.filter.append(int(tex.filter_mode))
            self.address.append(int(tex.address_mode))
            self.offset_bi.append(self._bitmap_bi_cache[key])
        return idx

    def build(self, device) -> TextureTable:
        n = max(len(self.kind), 1)
        if not self.kind:
            self.add(Texture())
        pool = (
            np.concatenate(self.pool, axis=0)
            if self.pool
            else np.zeros((1, 3), np.float32)
        )
        pool_bi = (
            np.concatenate(self.pool_bi, axis=0)
            if self.pool_bi and self._pool_bi_size <= _MAX_QUAD_ROWS
            else np.zeros((1, 12), np.float32)
        )
        from benchmark.reference.flatten.types import (
            TEX_ADDRESS, TEX_COLS, TEX_FILTER, TEX_H, TEX_KIND, TEX_OFFSET,
            TEX_OFFSET_BI, TEX_PATCH2, TEX_RGB, TEX_UVT, TEX_W,
        )

        k = len(self.kind)
        packed = np.zeros((k, TEX_COLS), np.float32)
        packed[:, TEX_KIND] = self.kind
        packed[:, TEX_RGB] = np.stack(self.rgb)
        packed[:, TEX_PATCH2] = np.stack(self.patch2)
        packed[:, TEX_UVT] = np.stack(self.uvt).reshape(k, 6)
        packed[:, TEX_OFFSET] = self.offset
        packed[:, TEX_W] = self.width
        packed[:, TEX_H] = self.height
        packed[:, TEX_FILTER] = self.filter
        packed[:, TEX_ADDRESS] = self.address
        packed[:, TEX_OFFSET_BI] = self.offset_bi
        return TextureTable(
            packed=_t(packed, device=device),
            kind=_t(self.kind, np.int32, device=device),
            rgb=_t(np.stack(self.rgb), np.float32, device=device),
            patch2=_t(np.stack(self.patch2), np.float32, device=device),
            uv_transform=_t(np.stack(self.uvt), np.float32, device=device),
            offset=_t(self.offset, np.int32, device=device),
            width=_t(self.width, np.int32, device=device),
            height=_t(self.height, np.int32, device=device),
            filter_mode=_t(self.filter, np.int32, device=device),
            address_mode=_t(self.address, np.int32, device=device),
            pool=_t(pool, np.float32, device=device),  # (P, 3) rows
            pool_bi=_t(pool_bi, np.float32, device=device),  # (Q, 12) quads
        )


class _MaterialBuilder:
    def __init__(self, textures: _TextureBuilder):
        self.textures = textures
        self.mtype: list[int] = []
        self.twosided: list[bool] = []
        self.tex: list[list[int]] = []
        self.eta: list[float] = []
        self.int_fdr: list[float] = []
        self.ssw: list[float] = []
        self.nonlinear: list[bool] = []
        self.aniso: list[bool] = []
        self.dispersion: list[float] = []
        # texture ids actually referenced by a material slot (slot
        # defaults of 0 are never read for the material's type, so they
        # must not widen the specialization set)
        self.used_tex_ids: set[int] = set()

    def add(self, mat: Material) -> int:
        idx = len(self.mtype)
        slots = [0] * N_SLOTS
        eta = 1.0
        int_fdr = 0.0
        ssw = 0.0
        t = self.textures

        def assign(slot: int, texture) -> None:
            tid = t.add(texture)
            slots[slot] = tid
            self.used_tex_ids.add(tid)

        if mat.type == MatType.DIFFUSE:
            assign(SLOT_REFLECTANCE, mat.reflectance)
        elif mat.type in (MatType.DIELECTRIC, MatType.ROUGH_DIELECTRIC):
            eta = mat.int_ior / mat.ext_ior
            assign(SLOT_SPECULAR, mat.specular_reflectance)
            assign(SLOT_TRANSMITTANCE, mat.specular_transmittance)
            if mat.type == MatType.ROUGH_DIELECTRIC:
                assign(SLOT_ALPHA, mat.alpha)
        elif mat.type in (MatType.CONDUCTOR, MatType.ROUGH_CONDUCTOR):
            assign(SLOT_ETA, mat.eta)
            assign(SLOT_K, mat.k)
            assign(SLOT_SPECULAR, mat.specular_reflectance)
            if mat.type == MatType.ROUGH_CONDUCTOR:
                assign(SLOT_ALPHA, mat.alpha)
        elif mat.type in (MatType.PLASTIC, MatType.ROUGH_PLASTIC):
            eta = mat.int_ior / mat.ext_ior
            assign(SLOT_REFLECTANCE, mat.diffuse_reflectance)
            assign(SLOT_SPECULAR, mat.specular_reflectance)
            if mat.type == MatType.ROUGH_PLASTIC:
                assign(SLOT_ALPHA, mat.alpha)
            # Precompute (optix_material.cpp:87-118).
            dl = _luminance(mat.diffuse_reflectance.average_rgb())
            sl = _luminance(mat.specular_reflectance.average_rgb())
            ssw = sl / (sl + dl) if (sl + dl) > 0 else 0.0
            int_fdr = _diffuse_fresnel_reflectance(1.0 / eta)
        self.mtype.append(int(mat.type))
        self.twosided.append(bool(mat.twosided))
        self.tex.append(slots)
        self.eta.append(eta)
        self.int_fdr.append(int_fdr)
        self.ssw.append(ssw)
        self.nonlinear.append(bool(mat.nonlinear))
        self.aniso.append(bool(getattr(mat, "anisotropic", False)))
        self.dispersion.append(float(getattr(mat, "dispersion", 0.0)))
        return idx

    def build(self, device) -> MaterialTable:
        if not self.mtype:
            self.add(Material(type=MatType.DIFFUSE))
        from benchmark.reference.flatten.types import (
            MAT_ANISO, MAT_COLS, MAT_DISPERSION, MAT_ETA, MAT_INT_FDR,
            MAT_NONLINEAR, MAT_SSW, MAT_TEX0, MAT_TWOSIDED, MAT_TYPE,
        )

        m = len(self.mtype)
        packed = np.zeros((m, MAT_COLS), np.float32)
        packed[:, MAT_TYPE] = self.mtype
        packed[:, MAT_TWOSIDED] = self.twosided
        packed[:, MAT_ETA] = self.eta
        packed[:, MAT_INT_FDR] = self.int_fdr
        packed[:, MAT_SSW] = self.ssw
        packed[:, MAT_NONLINEAR] = self.nonlinear
        packed[:, MAT_ANISO] = self.aniso
        packed[:, MAT_DISPERSION] = self.dispersion
        packed[:, MAT_TEX0 : MAT_TEX0 + 6] = self.tex
        return MaterialTable(
            packed=_t(packed, device=device),
            mtype=_t(self.mtype, np.int32, device=device),
            twosided=_t(self.twosided, np.bool_, device=device),
            tex=_t(self.tex, np.int32, device=device),
            eta=_t(self.eta, np.float32, device=device),
            int_fdr=_t(self.int_fdr, np.float32, device=device),
            ssw=_t(self.ssw, np.float32, device=device),
            nonlinear=_t(self.nonlinear, np.bool_, device=device),
        )


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


def _tessellate_curve(pts: np.ndarray, basis: str, subdiv: int = 8):
    """Control vertices (P, 4) [x y z r] -> polyline (M, 4) whose pairs
    become rounded-cone segments — the flatten-time analog of the four
    optix builtin curve intersection modules (module.h:20-29). The
    spline math lives in scene/curves.py (linear / quadratic b-spline /
    cubic b-spline / catmull-rom, OptiX window semantics)."""
    from benchmark.reference.scene.curves import tessellate

    return tessellate(pts, basis, subdiv)


def flatten_scene(scene: Scene, pad_tris_to: int = 64, *, device):
    """Scene -> (SceneData, RenderConfig) with every table on ``device``."""
    device = torch.device(device)
    textures = _TextureBuilder()
    materials = _MaterialBuilder(textures)

    # triangle soup accumulators
    tp = {k: [] for k in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")}
    t_mat: list[int] = []
    t_emit: list[int] = []
    t_inst: list[int] = []     # instance index per triangle
    t_urow: list[int] = []     # unique object-space row per triangle
    unique_rows: list[np.ndarray] = []  # (nf, 18) blocks per unique shape
    unique_base: dict[str, int] = {}    # shape key -> base row
    unique_count = 0
    # device-side instancing capture (flatten/instanced.py)
    shape_store: dict[str, dict] = {}
    inst_meta: list[dict] = []
    em_base_w: list[float] = []         # per emitter: radiance weight basis
    sphere_inst: list[int] = []         # instance index per sphere row
    c_rows: list[np.ndarray] = []       # curve segment rows (CRV_COLS)
    # spheres
    s_o2w, s_w2o, s_mat, s_emit, s_flip = [], [], [], [], []
    # emitters
    e = {
        k: []
        for k in (
            "etype", "v0p", "v1p", "v2p", "v0n", "v1n", "v2n",
            "v0t", "v1t", "v2t", "radius", "area", "weight", "rad_tex",
        )
    }

    def add_area_tri_emitters(world_p, world_n, uv, idx, radiance_tex_id, weight_scale):
        """Per-triangle flatten (world/emitter.cpp:169-222)."""
        base = len(e["etype"])
        for f in range(idx.shape[0]):
            i0, i1, i2 = idx[f]
            p0, p1, p2 = world_p[i0], world_p[i1], world_p[i2]
            area = 0.5 * float(np.linalg.norm(np.cross(p1 - p0, p2 - p0)))
            e["etype"].append(0)
            e["v0p"].append(p0); e["v1p"].append(p1); e["v2p"].append(p2)
            e["v0n"].append(world_n[i0]); e["v1n"].append(world_n[i1]); e["v2n"].append(world_n[i2])
            e["v0t"].append(uv[i0]); e["v1t"].append(uv[i1]); e["v2t"].append(uv[i2])
            e["radius"].append(0.0)
            e["area"].append(area)
            e["weight"].append(weight_scale * area)
            e["rad_tex"].append(radiance_tex_id)
        return base

    for inst_i, ins in enumerate(scene.shape_instances):
        if ins.shape is None or ins.shape.type == ShapeType.UNKNOWN:
            continue
        # Hidden instances stay in every table with the SAME row counts —
        # geometry is degenerated so nothing hits it and emitter weights
        # drop to zero. This keeps tri_count/emitter_count (static jit
        # args) identical across visibility toggles, so a toggle never
        # retraces the frame program (the IAS visibility-mask analog).
        hidden = getattr(ins, "visibility_mask", 255) == 0
        mat_id = materials.add(ins.material)
        m = ins.transform.matrix

        if ins.shape.type == ShapeType.SPHERE:
            emitter_id = -1
            if ins.is_emitter:
                # Sphere area emitter (world/emitter.cpp:224-243): world
                # center + radius from a transformed surface point.
                rad_tex = textures.add(ins.emitter.radiance)
                c = transform_points(np.zeros((1, 3), np.float32), m)[0]
                p = transform_points(np.array([[1.0, 0, 0]], np.float32), m)[0]
                radius = float(np.linalg.norm(c - p))
                area = 4.0 * np.pi * radius * radius
                weight = ins.emitter.radiance.max_channel_weight() * area
                emitter_id = len(e["etype"])
                e["etype"].append(1)
                e["v0p"].append(c)
                for k in ("v1p", "v2p", "v0n", "v1n", "v2n"):
                    e[k].append(np.zeros(3, np.float32))
                for k in ("v0t", "v1t", "v2t"):
                    e[k].append(np.zeros(2, np.float32))
                e["radius"].append(radius)
                e["area"].append(area)
                e["weight"].append(0.0 if hidden else weight)
                e["rad_tex"].append(rad_tex)
            if hidden:
                # zeroed transforms: a = |d'|^2 = 0 fails the quadratic's
                # a > eps guard, so no ray ever hits the sphere
                s_o2w.append(np.zeros((3, 4), np.float32))
                s_w2o.append(np.zeros((3, 4), np.float32))
            else:
                s_o2w.append(m[:3, :4])
                s_w2o.append(np.linalg.inv(m)[:3, :4].astype(np.float32))
            s_mat.append(mat_id)
            s_emit.append(emitter_id)
            s_flip.append(bool(ins.flip_normals))
            sphere_inst.append(inst_i)
            if emitter_id >= 0:
                em_base_w.append(ins.emitter.radiance.max_channel_weight())
            continue

        if ins.shape.type == ShapeType.CURVE:
            # round curves -> world-space rounded-cone segment rows
            poly = _tessellate_curve(
                ins.shape.curve_points,
                getattr(ins.shape, "curve_basis", "linear"),
            )
            wp = transform_points(poly[:, :3], m).astype(np.float32)
            # radius scales by the mean axis scale of the transform
            rscale = float(np.linalg.norm(m[:3, :3], axis=0).mean())
            wr = (poly[:, 3] * rscale).astype(np.float32)
            if hidden:
                wr = np.zeros_like(wr)  # r <= 0 segments never hit
            seglen = np.linalg.norm(wp[1:] - wp[:-1], axis=1)
            cum = np.concatenate([[0.0], np.cumsum(seglen)])
            total = max(float(cum[-1]), 1e-9)
            for si in range(wp.shape[0] - 1):
                c_rows.append(np.concatenate([
                    wp[si], [wr[si]], wp[si + 1], [wr[si + 1]],
                    [mat_id, cum[si] / total, cum[si + 1] / total, 0.0],
                ]).astype(np.float32))
            continue

        mesh = ins.shape.mesh
        world_p = transform_points(mesh.positions, m).astype(np.float32)
        if hidden:
            # collapse to the centroid: every triangle degenerates
            # (det ~ 0 in Moller-Trumbore), emitter weights zeroed below
            world_p = np.broadcast_to(
                world_p.mean(axis=0), world_p.shape
            ).astype(np.float32)
        if mesh.normals is not None and len(mesh.normals):
            obj_n = mesh.normals
        else:
            # Face-normal fallback (render/geometry.h:66-69), splatted to
            # vertices per-face below via indexing of a per-face array.
            obj_n = None
        if obj_n is not None:
            world_n = transform_normals(obj_n, m).astype(np.float32)
        if ins.flip_normals and obj_n is not None:
            world_n = -world_n

        uv = (
            mesh.texcoords.astype(np.float32)
            if mesh.texcoords is not None
            else np.zeros((len(world_p), 2), np.float32)
        )
        if ins.flip_tex_coords and mesh.texcoords is not None:
            uv = uv.copy()
            uv[:, 1] = 1.0 - uv[:, 1]

        idx = mesh.indices.astype(np.int64)
        emitter_base = -1
        if ins.is_emitter:
            rad_tex = textures.add(ins.emitter.radiance)
            weight_scale = (
                0.0 if hidden else ins.emitter.radiance.max_channel_weight()
            )
            if obj_n is None:
                fn = np.cross(
                    world_p[idx[:, 1]] - world_p[idx[:, 0]],
                    world_p[idx[:, 2]] - world_p[idx[:, 0]],
                )
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
                wn_for_emit = np.zeros_like(world_p)
                wn_for_emit[idx[:, 0]] = fn
                wn_for_emit[idx[:, 1]] = fn
                wn_for_emit[idx[:, 2]] = fn
            else:
                wn_for_emit = world_n
            emitter_base = add_area_tri_emitters(
                world_p, wn_for_emit, uv, idx, rad_tex, weight_scale
            )
            em_base_w.extend(
                [ins.emitter.radiance.max_channel_weight()] * idx.shape[0]
            )

        f0, f1, f2 = idx[:, 0], idx[:, 1], idx[:, 2]
        tp["p0"].append(world_p[f0]); tp["p1"].append(world_p[f1]); tp["p2"].append(world_p[f2])
        if obj_n is not None:
            tp["n0"].append(world_n[f0]); tp["n1"].append(world_n[f1]); tp["n2"].append(world_n[f2])
        else:
            fn = np.cross(world_p[f1] - world_p[f0], world_p[f2] - world_p[f0])
            fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
            if ins.flip_normals:
                fn = -fn
            tp["n0"].append(fn); tp["n1"].append(fn); tp["n2"].append(fn)
        tp["uv0"].append(uv[f0]); tp["uv1"].append(uv[f1]); tp["uv2"].append(uv[f2])
        nf = idx.shape[0]
        t_mat.extend([mat_id] * nf)
        t_inst.extend([inst_i] * nf)
        # unique OBJECT-space rows per shape, stored once: the baked refit's
        # unique table and the instanced tables' per-shape blocks
        # (flatten/instanced.py). Normals unflipped: the refit and the
        # instance rows apply per-instance signs.
        key = ins.shape.key or f"anon-{inst_i}"
        if key not in unique_base:
            op = mesh.positions.astype(np.float32)
            op0, op1, op2 = op[f0], op[f1], op[f2]
            if obj_n is not None:
                on = mesh.normals.astype(np.float32)
                on0, on1, on2 = on[f0], on[f1], on[f2]
            else:
                ofn = np.cross(op1 - op0, op2 - op0)
                ofn /= np.maximum(
                    np.linalg.norm(ofn, axis=-1, keepdims=True), 1e-20
                )
                on0 = on1 = on2 = ofn
            uv_raw = (
                mesh.texcoords.astype(np.float32)
                if mesh.texcoords is not None
                else np.zeros((len(op), 2), np.float32)
            )
            shape_store[key] = dict(
                p0=op0, e1=op1 - op0, e2=op2 - op0,
                n0=on0, n1=on1, n2=on2,
                uv0=uv_raw[f0], uv1=uv_raw[f1], uv2=uv_raw[f2],
            )
            blk = shape_store[key]
            unique_base[key] = unique_count
            unique_rows.append(np.concatenate(
                [blk[c] for c in ("p0", "e1", "e2", "n0", "n1", "n2")], axis=1))
            unique_count += nf
        t_urow.extend(range(unique_base[key], unique_base[key] + nf))
        if emitter_base >= 0:
            t_emit.extend(range(emitter_base, emitter_base + nf))
        else:
            t_emit.extend([-1] * nf)
        inst_meta.append(dict(
            key=key, matrix=np.asarray(m, np.float64), mat_id=mat_id,
            emitter_base=emitter_base, flip=bool(ins.flip_normals),
            uv_flip=bool(ins.flip_tex_coords and mesh.texcoords is not None),
            hidden=bool(hidden), scene_idx=inst_i,
        ))

    # -- delta lights (point / directional) ----------------------------------
    # The reference parses these but never flattens them (the TODO at
    # world/emitter.cpp:314-316); here they join the same packed table:
    # etype 2 = point (EM_V0P = position, radiance tex = intensity),
    # etype 3 = directional (EM_V0N = travel direction, radiance tex =
    # irradiance). Sampling treats them as delta lights (pdf 1, MIS 1).
    from benchmark.reference.scene.textures import rgb_texture

    for gem in scene.emitters:
        if gem.type not in (EmitterType.POINT, EmitterType.DIRECTIONAL):
            continue
        is_point = gem.type == EmitterType.POINT
        ir, ig, ib = (float(v) for v in np.asarray(gem.intensity).reshape(3))
        rad_tex = textures.add(rgb_texture(ir, ig, ib))
        e["etype"].append(2 if is_point else 3)
        e["v0p"].append(
            np.asarray(gem.position, np.float32)
            if is_point
            else np.zeros(3, np.float32)
        )
        e["v0n"].append(
            np.zeros(3, np.float32)
            if is_point
            else np.asarray(gem.direction, np.float32)
        )
        for k in ("v1p", "v2p", "v1n", "v2n"):
            e[k].append(np.zeros(3, np.float32))
        for k in ("v0t", "v1t", "v2t"):
            e[k].append(np.zeros(2, np.float32))
        e["radius"].append(0.0)
        e["area"].append(1.0)
        e["weight"].append(float(np.max(gem.intensity)))
        e["rad_tex"].append(rad_tex)
        em_base_w.append(float(np.max(gem.intensity)))

    # -- selection probabilities (emitter.cpp:321-337) ----------------------
    n_area = len(e["etype"])
    weights = np.asarray(e["weight"], np.float32)
    env = next(
        (em for em in scene.emitters if em.type in (EmitterType.CONST_ENV, EmitterType.ENV_MAP)),
        None,
    )
    emitter_num = n_area + (1 if env is not None else 0)
    if n_area > 0 and weights.sum() > 0:
        probs = weights / weights.sum() * n_area / max(emitter_num, 1)
    else:
        probs = np.zeros(n_area, np.float32)
    env_prob = 1.0 / emitter_num if env is not None else 0.0

    # -- environment emitter -------------------------------------------------
    aabb = scene.aabb
    center = aabb.center if aabb.valid else np.zeros(3, np.float32)
    env_type = 0
    env_color = np.zeros(3, np.float32)
    env_to_world = np.eye(3, dtype=np.float32)
    env_to_local = np.eye(3, dtype=np.float32)
    env_rad_tex = 0
    env_row_cdf = np.zeros(1, np.float32)
    env_col_cdf = np.zeros((1, 1), np.float32)
    env_joint_cdf = np.zeros(1, np.float32)
    env_row_weight = np.zeros(1, np.float32)
    env_norm = 0.0
    env_scale = 1.0
    env_size = (0, 0)
    if env is not None and env.type == EmitterType.CONST_ENV:
        env_type = 1
        env_color = np.asarray(env.color, np.float32)
    elif env is not None:
        env_type = 2
        env_rad_tex = textures.add(env.radiance)
        env_scale = float(env.scale)
        env_to_world = env.transform.matrix[:3, :3].astype(np.float32)
        env_to_local = np.linalg.inv(env.transform.matrix)[:3, :3].astype(np.float32)
        data = env.radiance.data
        h, w = data.shape[:2]
        env_size = (w, h)
        lum = (
            0.2126 * data[..., 0] + 0.7152 * data[..., 1] + 0.0722 * data[..., 2]
        ).astype(np.float64)
        # Per-row column CDF over (w+1) entries starting at 0
        # (emitter.cpp:113-131).
        col_sums = lum.sum(axis=1)  # (h,)
        col_cdf = np.zeros((h, w + 1), np.float64)
        col_cdf[:, 1:] = np.cumsum(lum, axis=1)
        safe = np.maximum(col_sums, 1e-30)[:, None]
        col_cdf[:, 1:-1] /= safe  # last entry forced to 1
        col_cdf[:, -1] = 1.0
        row_weight = np.sin((np.arange(h) + 0.5) * np.pi / h)
        row_vals = col_sums * row_weight
        row_sum = row_vals.sum()
        row_cdf = np.zeros(h + 1, np.float64)
        row_cdf[1:] = np.cumsum(row_vals)
        row_cdf[1:-1] /= max(row_sum, 1e-30)
        row_cdf[-1] = 1.0
        env_row_cdf = row_cdf.astype(np.float32)
        env_col_cdf = col_cdf.astype(np.float32)
        env_row_weight = row_weight.astype(np.float32)
        joint = (lum * row_weight[:, None]).reshape(-1)
        env_joint_cdf = (np.cumsum(joint) / max(joint.sum(), 1e-30)).astype(
            np.float32
        )
        env_joint_cdf[-1] = 1.0
        # The CDF tables are built from UNSCALED pixel luminance, but
        # both pdf sites (emitter.py:_env_sample_direct / eval_env)
        # multiply luminance(radiance * env_scale) by this factor — so
        # fold 1/scale in here to report the TRUE sampling density.
        # Without it, env NEE under-contributes and BSDF-side MIS
        # underweights by exactly `scale` (r5: big_env scale=2.5 read
        # 0.73x the brute-force oracle on every lit surface while the
        # escape path matched 1.000; scale=1 scenes were unaffected,
        # which is why mesh_env's gate never saw it).
        env_norm = float(
            1.0 / (row_sum * (2.0 * np.pi / w) * (np.pi / h))
            / max(env_scale, 1e-30)
        )

    # -- pad + pack ----------------------------------------------------------
    def cat3(key):
        return (
            np.concatenate(tp[key], axis=0)
            if tp[key]
            else np.zeros((0, 3 if not key.startswith("uv") else 2), np.float32)
        )

    tri_count = len(t_mat)
    bvh_tcl = 0
    t_pad = _round_up(tri_count, max(pad_tris_to, bvh_tcl))

    # --- Morton-order triangles (LBVH-lite): sorting by centroid code
    # groups spatially-local triangles into the same sweep chunk so the
    # per-chunk AABBs (computed in the Pallas wrapper) cull effectively.
    if tri_count > pad_tris_to:
        cat_p0 = np.concatenate(tp["p0"], axis=0)
        cat_p1 = np.concatenate(tp["p1"], axis=0)
        cat_p2 = np.concatenate(tp["p2"], axis=0)
        centroid = (cat_p0 + cat_p1 + cat_p2) / 3.0
        lo = centroid.min(axis=0)
        hi = centroid.max(axis=0)
        q = ((centroid - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint32)
        q = np.clip(q, 0, 1023)

        def _expand_bits(v):
            v = (v | (v << 16)) & 0x030000FF
            v = (v | (v << 8)) & 0x0300F00F
            v = (v | (v << 4)) & 0x030C30C3
            v = (v | (v << 2)) & 0x09249249
            return v

        morton = (
            (_expand_bits(q[:, 0]) << 2)
            | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2])
        )
        order = np.argsort(morton, kind="stable")
        for key in tp:
            cat = np.concatenate(tp[key], axis=0)
            tp[key] = [cat[order]]
        t_mat = list(np.asarray(t_mat)[order])
        t_emit = list(np.asarray(t_emit)[order])
        t_inst = list(np.asarray(t_inst)[order])
        t_urow = list(np.asarray(t_urow)[order])

    def pad_rows(a, n, width):
        out = np.zeros((n, width), np.float32)
        out[: a.shape[0]] = a
        return out

    p0_np = pad_rows(cat3("p0"), t_pad, 3)
    p1_np = pad_rows(cat3("p1"), t_pad, 3)
    p2_np = pad_rows(cat3("p2"), t_pad, 3)
    packed = np.concatenate(
        [p0_np, p1_np - p0_np, p2_np - p0_np, np.zeros((t_pad, 3), np.float32)],
        axis=1,
    )
    from benchmark.reference.flatten.types import (
        TRI_ATTR_COLS, TRI_EMITTER, TRI_MAT,
        TRI_N0, TRI_N1, TRI_N2, TRI_UV0, TRI_UV1, TRI_UV2,
    )

    attrs = np.zeros((t_pad, TRI_ATTR_COLS), np.float32)
    attrs[:, TRI_N0] = pad_rows(cat3("n0"), t_pad, 3)
    attrs[:, TRI_N1] = pad_rows(cat3("n1"), t_pad, 3)
    attrs[:, TRI_N2] = pad_rows(cat3("n2"), t_pad, 3)
    attrs[:, TRI_UV0] = pad_rows(cat3("uv0"), t_pad, 2)
    attrs[:, TRI_UV1] = pad_rows(cat3("uv1"), t_pad, 2)
    attrs[:, TRI_UV2] = pad_rows(cat3("uv2"), t_pad, 2)
    attrs[:, TRI_MAT] = np.pad(t_mat, (0, t_pad - tri_count))
    attrs[:, TRI_EMITTER] = np.pad(
        t_emit, (0, t_pad - tri_count), constant_values=-1
    )
    # mirror p0/e1/e2 for the in-geometry barycentric recompute (see
    # flatten/types.py TRI_P0); attrs and packed reorder together below
    attrs[:, 17:26] = packed[:, 0:9]

    p1w = p0_np + packed[:, 3:6]
    p2w = p0_np + packed[:, 6:9]
    valid = np.zeros(t_pad, bool)
    valid[:tri_count] = True
    # refit row maps (padding rows -> instance 0, unique row 0, invalid)
    tri_inst_np = np.zeros(t_pad, np.int32)
    tri_inst_np[:tri_count] = t_inst
    t_urow_np = np.zeros(t_pad, np.int32)
    t_urow_np[:tri_count] = t_urow

    bvh_ch = bvh_ax = np.zeros(8, np.int32)
    bvh_bx = np.zeros((8, 8), np.float32)
    bvh_nodes = 0
    # per-chunk AABBs over valid triangles only; all-padding chunks get
    # inverted never-hit boxes (accel/pallas_intersect.py culling input)
    tc = pad_tris_to
    n_chunks = t_pad // tc
    boxes = np.zeros((n_chunks, 8), np.float32)
    lo_all = np.minimum(np.minimum(p0_np, p1w), p2w)
    hi_all = np.maximum(np.maximum(p0_np, p1w), p2w)
    lo_all[~valid] = 1e30   # big-finite: inf breeds NaN in the slab test
    hi_all[~valid] = -1e30
    boxes[:, 0:3] = lo_all.reshape(n_chunks, tc, 3).min(axis=1)
    boxes[:, 3:6] = hi_all.reshape(n_chunks, tc, 3).max(axis=1)

    chunk_boxes = _t(boxes, device=device)
    packed_t = _t(packed, device=device)
    tris = TriSoup(
        packed=packed_t,
        chunk_boxes=chunk_boxes,
        sweep_boxes=torch.zeros((0, 8), dtype=torch.float32, device=device),
        attrs=_t(attrs, device=device),
        mat_id=_t(attrs[:, TRI_MAT].astype(np.int32), device=device),
        emitter_id=_t(attrs[:, TRI_EMITTER].astype(np.int32), device=device),
        bvh_child=_t(bvh_ch, device=device),
        bvh_axis=_t(bvh_ax, device=device),
        bvh_boxes=_t(bvh_bx, device=device),
        leaf_start=torch.zeros(1, dtype=torch.int32, device=device),
        leaf_inst=torch.zeros(1, dtype=torch.int32, device=device),
        inst_w2o=torch.zeros((1, 12), dtype=torch.float32, device=device),
        inst_packed=torch.zeros((1, 16), dtype=torch.float32, device=device),
        subleaf_boxes=torch.zeros((0, 8), dtype=torch.float32, device=device),
        subleaf_rows=torch.zeros(0, dtype=torch.uint8, device=device),
        bvh_depth=0,
    )

    sphere_count = len(s_mat)
    s_pad = max(sphere_count, 1)
    o2w = np.zeros((s_pad, 3, 4), np.float32)
    w2o = np.zeros((s_pad, 3, 4), np.float32)
    if sphere_count:
        o2w[:sphere_count] = np.stack(s_o2w)
        w2o[:sphere_count] = np.stack(s_w2o)
    from benchmark.reference.flatten.types import SPH_COLS, SPH_EMITTER, SPH_FLIP, SPH_MAT

    sph_attrs = np.zeros((s_pad, SPH_COLS), np.float32)
    sph_attrs[:, 0:12] = w2o.reshape(s_pad, 12)
    sph_attrs[:, SPH_MAT] = np.pad(s_mat, (0, s_pad - sphere_count))
    sph_attrs[:, SPH_EMITTER] = np.pad(
        s_emit, (0, s_pad - sphere_count), constant_values=-1
    )
    sph_attrs[:, SPH_FLIP] = np.pad(s_flip, (0, s_pad - sphere_count))
    spheres = Spheres(
        attrs=_t(sph_attrs, device=device),
        o2w=_t(o2w, device=device),
        w2o=_t(w2o, device=device),
        mat_id=_t(np.pad(s_mat, (0, s_pad - sphere_count)), np.int32, device=device),
        emitter_id=_t(np.pad(s_emit, (0, s_pad - sphere_count), constant_values=-1), np.int32, device=device),
        flip_normal=_t(np.pad(s_flip, (0, s_pad - sphere_count)).astype(bool), device=device),
    )

    e_pad = max(n_area, 1)

    def epack(key, width=None):
        rows = e[key]
        if width is None:
            arr = np.zeros(e_pad, np.float32)
            if rows:
                arr[:n_area] = np.asarray(rows, np.float32)
            return arr
        arr = np.zeros((e_pad, width), np.float32)
        if rows:
            arr[:n_area] = np.stack(rows)
        return arr

    select_prob = np.zeros(e_pad, np.float32)
    select_prob[:n_area] = probs
    select_cdf = np.cumsum(select_prob).astype(np.float32)

    from benchmark.reference.flatten.types import (
        EM_AREA, EM_COLS, EM_ETYPE, EM_RAD_TEX, EM_RADIUS, EM_SELECT_PROB,
        EM_V0N, EM_V0P, EM_V0T, EM_V1N, EM_V1P, EM_V1T, EM_V2N, EM_V2P, EM_V2T,
    )

    em_packed = np.zeros((e_pad, EM_COLS), np.float32)
    em_packed[:, EM_V0P] = epack("v0p", 3)
    em_packed[:, EM_V1P] = epack("v1p", 3)
    em_packed[:, EM_V2P] = epack("v2p", 3)
    em_packed[:, EM_V0N] = epack("v0n", 3)
    em_packed[:, EM_V1N] = epack("v1n", 3)
    em_packed[:, EM_V2N] = epack("v2n", 3)
    em_packed[:, EM_V0T] = epack("v0t", 2)
    em_packed[:, EM_V1T] = epack("v1t", 2)
    em_packed[:, EM_V2T] = epack("v2t", 2)
    em_packed[:, EM_RADIUS] = epack("radius")
    em_packed[:, EM_AREA] = epack("area")
    em_packed[:, EM_SELECT_PROB] = select_prob
    if n_area:
        em_packed[:n_area, EM_RAD_TEX] = e["rad_tex"]
        em_packed[:n_area, EM_ETYPE] = e["etype"]

    emitters = EmitterTable(
        packed=_t(em_packed, device=device),
        etype=_t(np.pad(e["etype"], (0, e_pad - n_area)) if n_area else np.zeros(e_pad), np.int32, device=device),
        v0p=_t(epack("v0p", 3), device=device),
        v1p=_t(epack("v1p", 3), device=device),
        v2p=_t(epack("v2p", 3), device=device),
        v0n=_t(epack("v0n", 3), device=device),
        v1n=_t(epack("v1n", 3), device=device),
        v2n=_t(epack("v2n", 3), device=device),
        v0t=_t(epack("v0t", 2), device=device),
        v1t=_t(epack("v1t", 2), device=device),
        v2t=_t(epack("v2t", 2), device=device),
        radius=_t(epack("radius"), device=device),
        area=_t(epack("area"), device=device),
        select_prob=_t(select_prob, device=device),
        select_cdf=_t(select_cdf, device=device),
        radiance_tex=_t(np.pad(e["rad_tex"], (0, e_pad - n_area)) if n_area else np.zeros(e_pad), np.int32, device=device),
        env_type=_t(env_type, np.int32, device=device),
        env_color=_t(env_color, device=device),
        env_center=_t(center, np.float32, device=device),
        env_to_world=_t(env_to_world, device=device),
        env_to_local=_t(env_to_local, device=device),
        env_radiance_tex=_t(env_rad_tex, np.int32, device=device),
        env_row_cdf=_t(env_row_cdf, device=device),
        env_col_cdf=_t(env_col_cdf, device=device),
        env_joint_cdf=_t(env_joint_cdf, device=device),
        env_row_weight=_t(env_row_weight, device=device),
        env_normalization=_t(env_norm, np.float32, device=device),
        env_scale=_t(env_scale, np.float32, device=device),
        env_select_prob=_t(env_prob, np.float32, device=device),
    )

    from benchmark.reference.flatten.types import CRV_COLS, Curves

    curve_count = len(c_rows)
    c_pad = max(curve_count, 1)
    crv = np.zeros((c_pad, CRV_COLS), np.float32)
    if c_rows:
        crv[:curve_count] = np.stack(c_rows)
    curves = Curves(packed=_t(crv, device=device))

    data = SceneData(
        tris=tris,
        spheres=spheres,
        curves=curves,
        materials=materials.build(device),
        textures=textures.build(device),
        emitters=emitters,
    )
    def _tex_group_spec(tex_ids):
        """(kinds, filters) actually reachable from a set of texture ids —
        the per-call-site specialization that keeps constant-RGB fetches
        from compiling 5 pixel-pool gathers just because the scene also
        has a bitmap somewhere (e.g. the env map)."""
        ids = sorted({int(i) for i in tex_ids})
        if not ids:
            return (0,), (0,)
        kinds = tuple(sorted({textures.kind[i] for i in ids}))
        filters = tuple(
            sorted({textures.filter[i] for i in ids if textures.kind[i] == 2})
        )
        return kinds, (filters or (0,))

    mat_tex_kinds, mat_tex_filters = _tex_group_spec(materials.used_tex_ids)
    em_tex_kinds, em_tex_filters = _tex_group_spec(e["rad_tex"])
    env_filter = (
        int(textures.filter[int(env_rad_tex)]) if env_size[0] > 0 else 1
    )

    config = RenderConfig(
        width=scene.sensor.film.w,
        height=scene.sensor.film.h,
        max_depth=scene.integrator.max_depth,
        spectral=bool(getattr(scene.integrator, "spectral", False)),
        tri_count=tri_count,
        sphere_count=sphere_count,
        curve_count=curve_count,
        emitter_count=n_area,
        has_env=env is not None,
        env_size=env_size,
        mat_types=tuple(sorted(set(materials.mtype))),
        tex_kinds=tuple(sorted(set(textures.kind))),
        mat_tex_kinds=mat_tex_kinds,
        mat_tex_filters=mat_tex_filters,
        em_tex_kinds=em_tex_kinds,
        em_tex_filters=em_tex_filters,
        env_filter=env_filter,
        has_sphere_emitter=any(t == 1 for t in e["etype"]),
        has_point_emitter=any(t == 2 for t in e["etype"]),
        has_directional_emitter=any(t == 3 for t in e["etype"]),
        bvh_nodes=bvh_nodes,
        bvh_tcl=bvh_tcl,
        instanced=False,
    )
    return data, config


def camera_block_from_scene(scene: Scene, device) -> CameraBlock:
    """Build the device camera uniform from the scene sensor (``device``
    as in ``flatten_scene``)."""
    from benchmark.reference.utils.math import Transform

    cam = Camera(
        CameraDesc(
            fov_y=scene.sensor.fov,
            aspect_ratio=scene.sensor.film.w / scene.sensor.film.h,
            near_clip=scene.sensor.near_clip,
            far_clip=scene.sensor.far_clip,
            to_world=Transform(scene.sensor.transform.matrix),
        )
    )
    return camera_block(cam, device)


def camera_block(cam: Camera, device) -> CameraBlock:
    device = torch.device(device)
    return CameraBlock(
        sample_to_camera=_t(cam.sample_to_camera, device=device),
        camera_to_world=_t(cam.to_world, device=device),
    )
