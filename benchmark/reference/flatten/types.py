"""Device-side scene data model: dataclasses of tensors.

Mirrors pupiloptixlab_tpu/flatten/types.py field for field; the packed
column layouts are copied verbatim so both packages address the same
tables. ``RenderConfig`` stays a frozen dataclass of Python values; the
refit records (``RefitData``, ``InstRefitData``) hold host numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# --- packed-row column layouts (verbatim from the reference) -------------
# TriSoup.attrs (T, 26): per-hit attributes fetched in one gather.
# Cols 17:26 mirror packed[:, 0:9] (p0, e1, e2) so barycentrics are
# recomputed inside get_local_geometry from the same gather.
TRI_N0, TRI_N1, TRI_N2 = slice(0, 3), slice(3, 6), slice(6, 9)
TRI_UV0, TRI_UV1, TRI_UV2 = slice(9, 11), slice(11, 13), slice(13, 15)
TRI_MAT, TRI_EMITTER = 15, 16
TRI_P0, TRI_E1, TRI_E2 = slice(17, 20), slice(20, 23), slice(23, 26)
TRI_ATTR_COLS = 26

# MaterialTable.packed (M, 16)
MAT_TYPE, MAT_TWOSIDED, MAT_ETA, MAT_INT_FDR, MAT_SSW, MAT_NONLINEAR = range(6)
MAT_TEX0 = 6  # 6 texture-slot ids follow
MAT_ANISO = 12  # 1.0 = the alpha texture's r/g hold (alpha_u, alpha_v)
MAT_DISPERSION = 13  # Cauchy B (um^2) for spectral dielectrics; 0 = none
MAT_COLS = 16

# TextureTable.packed (K, 24)
TEX_KIND = 0
TEX_RGB, TEX_PATCH2 = slice(1, 4), slice(4, 7)
TEX_UVT = slice(7, 13)  # row-major (2,3)
TEX_OFFSET, TEX_W, TEX_H, TEX_FILTER, TEX_ADDRESS = 13, 14, 15, 16, 17
TEX_OFFSET_BI = 18  # row offset into pool_bi (2x2 quad rows, see texture.py)
TEX_COLS = 24

# EmitterTable.packed (E, 32)
EM_V0P, EM_V1P, EM_V2P = slice(0, 3), slice(3, 6), slice(6, 9)
EM_V0N, EM_V1N, EM_V2N = slice(9, 12), slice(12, 15), slice(15, 18)
EM_V0T, EM_V1T, EM_V2T = slice(18, 20), slice(20, 22), slice(22, 24)
EM_RADIUS, EM_AREA, EM_SELECT_PROB, EM_RAD_TEX, EM_ETYPE = 24, 25, 26, 27, 28
EM_COLS = 32

# Texture slot assignments within MaterialTable.tex (column index):
SLOT_REFLECTANCE = 0        # diffuse reflectance / plastic diffuse
SLOT_SPECULAR = 1           # specular reflectance
SLOT_TRANSMITTANCE = 2      # specular transmittance
SLOT_ETA = 3                # conductor eta (rgb)
SLOT_K = 4                  # conductor k (rgb)
SLOT_ALPHA = 5              # roughness
N_SLOTS = 6

# Spheres.attrs (S, 16): w2o rows flat (12), mat_id, emitter_id, flip
SPH_W2O = slice(0, 12)
SPH_MAT, SPH_EMITTER, SPH_FLIP = 12, 13, 14
SPH_COLS = 16

# TriSoup.inst_packed (I, 16): per-instance shading row (instanced mode)
INST_NRM = slice(0, 9)   # normal matrix: inverse-transpose 3x3 row-major,
                         # flip_normals sign folded in
INST_MAT = 9             # material id
INST_EMIT_BASE = 10      # emitter table base (-1 = not an emitter); the
                         # hit's emitter_id = base + attrs[TRI_EMITTER]
                         # (which holds the shape-local face index)
INST_W2O0 = 11           # 1.0 = flip the v texture coordinate
INST_COLS = 16

# Curves.packed (C, 12): segment endpoints + radii + ids
CRV_P0 = slice(0, 3)
CRV_R0 = 3
CRV_P1 = slice(4, 7)
CRV_R1 = 7
CRV_MAT = 8
CRV_UV0, CRV_UV1 = 9, 10
CRV_COLS = 12


@dataclass
class TextureTable:
    packed: torch.Tensor        # (K, TEX_COLS) f32 packed descriptors
    kind: torch.Tensor          # (K,) i32: 0 rgb, 1 checkerboard, 2 bitmap
    rgb: torch.Tensor           # (K,3) f32
    patch2: torch.Tensor        # (K,3) f32
    uv_transform: torch.Tensor  # (K,2,3) f32
    offset: torch.Tensor        # (K,) i32 into pool
    width: torch.Tensor         # (K,) i32
    height: torch.Tensor        # (K,) i32
    filter_mode: torch.Tensor   # (K,) i32: 0 point, 1 linear
    address_mode: torch.Tensor  # (K,) i32: 0 wrap, 1 clamp, 2 mirror
    pool: torch.Tensor          # (P,3) f32 pixel pool
    pool_bi: torch.Tensor       # (Q,12) f32 2x2 quad pool; (1,12) when off


@dataclass
class MaterialTable:
    packed: torch.Tensor     # (M, MAT_COLS) f32 packed params
    mtype: torch.Tensor      # (M,) i32 (MatType)
    twosided: torch.Tensor   # (M,) bool
    tex: torch.Tensor        # (M, N_SLOTS) i32 texture ids
    eta: torch.Tensor        # (M,) f32
    int_fdr: torch.Tensor    # (M,) f32
    ssw: torch.Tensor        # (M,) f32
    nonlinear: torch.Tensor  # (M,) bool


@dataclass
class TriSoup:
    """Triangle table and BVH node tables (8-wide, accel/bvh.py).
    ``sweep_boxes`` is the port's own box table of the chunk sweep (K5/K6),
    derived from ``packed`` once (accel/bvh_traverse.py ``sweep_boxes``:
    padded chunk boxes, then padded super-boxes above 32 chunks); the refit
    rebuilds it from the moved rows. A tree's tables hold a (0, 8)
    placeholder.
    ``bvh_depth`` is the tree depth (root = 1), recorded at flatten time
    so the traversal kernels can check their per-thread stack bound.

    Baked scenes hold world-space rows and leave the instancing tables as
    1-row placeholders. Instanced scenes (``config.instanced``,
    flatten/instanced.py) hold each repeated shape once: ``packed`` /
    ``attrs`` are unique OBJECT-space rows, the BVH is a world tree over
    per-instance leaf boxes whose leaf ids ``-(li+1)`` index
    ``leaf_start`` / ``leaf_inst``, and the traversal maps the ray into
    the leaf's instance space through ``inst_w2o`` (directions are not
    renormalised, so t stays the world parameter).

    ``subleaf_rows`` / ``subleaf_boxes`` are the port's own sub-leaf table,
    derived from ``packed`` once a flatten (accel/bvh_traverse.py). On a
    baked tree (``bvh_nodes > 0``): the (T,) uint8 leaf-local row order of
    each leaf's 8 spatial groups and the (T/tcl*8, 8) world group boxes
    (``make_baked_subleaf``), which the baked refit rebuilds from the moved
    rows in the kept order. On instanced tables: ``subleaf_rows`` is a (1,)
    placeholder and ``subleaf_boxes`` the 8 object-space boxes a unique leaf
    over consecutive rows (``make_subleaf_boxes``), which the instanced
    refit never changes. Without a tree (the chunk sweep): (1,) and (1, 8)
    placeholders."""

    packed: torch.Tensor       # (T,12) [p0, e1, e2, pad]
    chunk_boxes: torch.Tensor  # (T/64, 8)
    attrs: torch.Tensor        # (T, TRI_ATTR_COLS)
    mat_id: torch.Tensor       # (T,) i32
    emitter_id: torch.Tensor   # (T,) i32; -1 = not an emitter
    bvh_child: torch.Tensor    # (M*8,) i32; >=0 child node, <0 leaf
    bvh_axis: torch.Tensor     # (M,) i32
    bvh_boxes: torch.Tensor    # (M*8, 8) f32
    leaf_start: torch.Tensor   # (L,) i32 tcl-aligned unique-row start per world leaf
    leaf_inst: torch.Tensor    # (L,) i32 instance per world leaf
    inst_w2o: torch.Tensor     # (I, 12) f32 world->object 3x4 row-major
    inst_packed: torch.Tensor  # (I, INST_COLS) f32 shading row
    sweep_boxes: torch.Tensor  # (T/64 + G, 8) the sweep's padded boxes; (0, 8) with a tree
    subleaf_boxes: torch.Tensor  # (T/tcl*8, 8) group boxes: world (K1/K2/K11) or object (K7/K8)
    subleaf_rows: torch.Tensor   # (T,) u8 leaf-local row order (K1/K2/K11); (1,) otherwise
    bvh_depth: int = 0


@dataclass
class Spheres:
    attrs: torch.Tensor  # (S, SPH_COLS)
    o2w: torch.Tensor    # (S,3,4)
    w2o: torch.Tensor    # (S,3,4)
    mat_id: torch.Tensor
    emitter_id: torch.Tensor
    flip_normal: torch.Tensor  # (S,) bool


@dataclass
class Curves:
    packed: torch.Tensor  # (C, CRV_COLS) f32


@dataclass
class EmitterTable:
    packed: torch.Tensor
    etype: torch.Tensor
    v0p: torch.Tensor
    v1p: torch.Tensor
    v2p: torch.Tensor
    v0n: torch.Tensor
    v1n: torch.Tensor
    v2n: torch.Tensor
    v0t: torch.Tensor
    v1t: torch.Tensor
    v2t: torch.Tensor
    radius: torch.Tensor
    area: torch.Tensor
    select_prob: torch.Tensor
    select_cdf: torch.Tensor
    radiance_tex: torch.Tensor
    env_type: torch.Tensor          # () i32: 0 none, 1 const, 2 envmap
    env_color: torch.Tensor         # (3,)
    env_center: torch.Tensor        # (3,)
    env_to_world: torch.Tensor      # (3,3)
    env_to_local: torch.Tensor      # (3,3)
    env_radiance_tex: torch.Tensor  # () i32
    env_row_cdf: torch.Tensor       # (H+1,)
    env_col_cdf: torch.Tensor       # (H, W+1)
    env_joint_cdf: torch.Tensor     # (H*W,)
    env_row_weight: torch.Tensor    # (H,)
    env_normalization: torch.Tensor  # () f32
    env_scale: torch.Tensor         # () f32
    env_select_prob: torch.Tensor   # () f32


@dataclass
class CameraBlock:
    sample_to_camera: torch.Tensor  # (4,4)
    camera_to_world: torch.Tensor   # (4,4)


@dataclass
class SceneData:
    tris: TriSoup
    spheres: Spheres
    curves: Curves
    materials: MaterialTable
    textures: TextureTable
    emitters: EmitterTable


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings (same fields and defaults as the
    reference's RenderConfig)."""

    width: int
    height: int
    max_depth: int = 2
    accumulate: bool = True
    spp_per_pass: int = 1
    tri_count: int = 0
    sphere_count: int = 0
    curve_count: int = 0
    emitter_count: int = 0
    has_env: bool = False
    env_size: tuple[int, int] = (0, 0)
    mat_types: tuple[int, ...] = tuple(range(1, 8))
    tex_kinds: tuple[int, ...] = (0, 1, 2)
    mat_tex_kinds: tuple[int, ...] = (0, 1, 2)
    mat_tex_filters: tuple[int, ...] = (0, 1)
    em_tex_kinds: tuple[int, ...] = (0, 1, 2)
    em_tex_filters: tuple[int, ...] = (0, 1)
    env_filter: int = 1
    has_sphere_emitter: bool = True
    has_point_emitter: bool = False
    has_directional_emitter: bool = False
    bvh_nodes: int = 0
    bvh_tcl: int = 0
    instanced: bool = False
    debug_checks: bool = False
    spectral: bool = False


# --- refit records (host side, numpy; flatten/refit.py) -------------------
@dataclass
class RefitData:
    """Static (per-scene-topology) inputs of the baked device refit,
    captured by ``flatten_scene(..., return_refit=True)``."""

    # unique object-space geometry: (U, 18) [p0 e1 e2 n0 n1 n2]
    unique_rows: np.ndarray
    u_row: np.ndarray       # (T,) i32 row into unique_rows (BVH order)
    tri_inst: np.ndarray    # (T,) i32 instance id per row (BVH order)
    tri_valid: np.ndarray   # (T,) bool
    flip_sign: np.ndarray   # (I,) f32 +-1 (flip_normals per instance)
    # BVH slot topology (static): kind 0=empty 1=leaf 2=internal
    slot_kind: np.ndarray   # (M*8,) i32
    slot_ref: np.ndarray    # (M*8,) i32 leaf index or child node id
    depth: int              # bottom-up refit passes needed
    tcl: int
    # emitters
    em_tri_row: np.ndarray      # (E,) i32 tri row for tri-area emitters, -1 else
    em_sphere_inst: np.ndarray  # (E,) i32 instance id for sphere emitters, -1
    em_base_weight: np.ndarray  # (E,) f32 max-channel(radiance) factors
    n_area: int
    emitter_num: int            # n_area + (1 if env)
    # spheres
    sphere_inst: np.ndarray     # (S,) i32 instance id per sphere row, -1 pad
    # instance bookkeeping
    n_instances: int
    instance_names: list


@dataclass
class InstRefitData:
    """Static refit inputs of an instanced scene (flatten/instanced.py):
    object-space geometry never moves under a transform edit, so the refit
    recomputes the per-instance matrices, re-derives the world leaf boxes
    from the static object leaf boxes and refits the world box tree
    bottom-up with frozen topology. Scope: mesh-only, non-emissive scenes;
    the flatten keeps the baked ``RefitData`` otherwise."""

    obj_leaf_lo: np.ndarray     # (L, 3) object-space leaf boxes, BVH order
    obj_leaf_hi: np.ndarray     # (L, 3)
    leaf_inst: np.ndarray       # (L,) i32 instance id per leaf
    child: np.ndarray           # (M*8,) i32 world-tree topology (frozen)
    inst_packed: np.ndarray     # (I, INST_COLS) f32 baseline shading rows
    mesh_scene_idx: np.ndarray  # (I,) i32 scene.shape_instances index
    n_instances: int
    instance_names: list
