"""Shapes: built-in rectangle/cube/sphere and OBJ mesh import.

Parity: resource::ShapeManager (resource/shape.{h,cpp}). Built-in shapes
use the same canonical geometry: rectangle = XY quad on [-1,1]^2 facing +Z
(2 tris), cube = [-1,1]^3 with 24 vertices / 12 tris, sphere = analytic
unit sphere at the origin (radius/center folded into the instance
transform, shape.cpp:106-124 + 196-198). Mesh import replaces assimp with
a native OBJ reader (triangulating fans, merging all groups into one mesh
like the reference's single-mesh assimp path, shape.cpp:219-278).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchmark.reference.scene.emitters import Emitter
from benchmark.reference.scene.materials import Material
from benchmark.reference.utils.log import get_logger
from benchmark.reference.utils.math import AABB, Transform

log = get_logger(__name__)


class ShapeType(enum.IntEnum):
    UNKNOWN = 0
    OBJ = 1
    SPHERE = 2
    CUBE = 3
    RECTANGLE = 4
    CURVE = 5  # round curve (optix builtin curve-IS analog, module.h:20-29)


@dataclass
class Mesh:
    positions: np.ndarray  # (v, 3) f32
    normals: np.ndarray | None  # (v, 3) f32 or None -> face-normal fallback
    texcoords: np.ndarray | None  # (v, 2) f32
    indices: np.ndarray  # (f, 3) uint32

    @property
    def face_num(self) -> int:
        return int(self.indices.shape[0])


@dataclass
class Shape:
    type: ShapeType
    mesh: Mesh | None = None
    aabb: AABB = field(default_factory=AABB)
    key: str = ""  # dedupe key (file path or builtin name)
    # round curve: control vertices (P, 4) [x y z radius] + basis from
    # the builtin curve-module set (reference optix/module.h:20-29):
    # "linear" | "bspline2" | "bspline3" | "catmullrom". Non-linear
    # bases tessellate to rounded-cone segments at flatten time
    # (scene/curves.py). curve_degree is kept as the legacy numeric view
    # (1 linear, 2 quadratic, 3 cubic/catrom).
    curve_points: np.ndarray | None = None
    curve_degree: int = 1
    curve_basis: str = "linear"


@dataclass
class ShapeInstance:
    name: str = ""
    shape: Shape | None = None
    material: Material = field(default_factory=Material)
    emitter: Emitter = field(default_factory=Emitter)
    is_emitter: bool = False
    transform: Transform = field(default_factory=Transform)
    flip_normals: bool = False
    flip_tex_coords: bool = False  # OBJ XML loader defaults this to True
    visibility_mask: int = 255


# --- built-in canonical geometry (shape.cpp:20-66 equivalents) ------------

def _rectangle_mesh() -> Mesh:
    positions = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    )
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    texcoords = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    return Mesh(positions, normals, texcoords, indices)


def _cube_mesh() -> Mesh:
    # 6 faces x 4 verts, outward normals, unit uv per face.
    faces = [
        (np.array([-1, 0, 0], np.float32),
         [[-1, -1, -1], [-1, -1, 1], [-1, 1, 1], [-1, 1, -1]]),
        (np.array([0, 0, -1], np.float32),
         [[1, -1, -1], [-1, -1, -1], [-1, 1, -1], [1, 1, -1]]),
        (np.array([1, 0, 0], np.float32),
         [[1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]]),
        (np.array([0, 0, 1], np.float32),
         [[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]]),
        (np.array([0, 1, 0], np.float32),
         [[-1, 1, 1], [1, 1, 1], [1, 1, -1], [-1, 1, -1]]),
        (np.array([0, -1, 0], np.float32),
         [[-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]]),
    ]
    positions, normals, texcoords, indices = [], [], [], []
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for fi, (n, quad) in enumerate(faces):
        base = 4 * fi
        positions.extend(quad)
        normals.extend([n] * 4)
        texcoords.extend(uv)
        indices.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return Mesh(
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(texcoords, np.float32),
        np.asarray(indices, np.uint32),
    )


def load_obj(path: str | Path) -> Mesh:
    """OBJ reader: v/vt/vn/f, fan-triangulated, corner-deduped (the port's
    Python parser, the specification of its C++ one)."""
    positions, texcoords, normals = [], [], []
    out_pos, out_uv, out_n, out_idx = [], [], [], []
    corner_map: dict[tuple[int, int, int], int] = {}
    has_uv = has_n = False

    def corner(spec: str) -> int:
        nonlocal has_uv, has_n
        parts = spec.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ti - 1 if ti > 0 else (len(texcoords) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(normals) + ni if ni else -1)
        key = (vi, ti, ni)
        if key in corner_map:
            return corner_map[key]
        idx = len(out_pos)
        corner_map[key] = idx
        out_pos.append(positions[vi])
        if ti >= 0:
            has_uv = True
            out_uv.append(texcoords[ti])
        else:
            out_uv.append((0.0, 0.0))
        if ni >= 0:
            has_n = True
            out_n.append(normals[ni])
        else:
            out_n.append((0.0, 0.0, 0.0))
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                positions.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                positions_uv = (float(p[1]), float(p[2]) if len(p) > 2 else 0.0)
                texcoords.append(positions_uv)
            elif line.startswith("vn "):
                p = line.split()
                normals.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                specs = line.split()[1:]
                ids = [corner(s) for s in specs]
                for k in range(1, len(ids) - 1):
                    out_idx.append((ids[0], ids[k], ids[k + 1]))

    return Mesh(
        np.asarray(out_pos, np.float32),
        np.asarray(out_n, np.float32) if has_n else None,
        np.asarray(out_uv, np.float32) if has_uv else None,
        np.asarray(out_idx, np.uint32),
    )


def parse_mtl(path: str | Path) -> dict[str, dict]:
    """Minimal MTL reader: newmtl, Kd/Ks/Ke, Ns, d, map_Kd. Returns
    {material name: {key: value}} with colors as float tuples and
    map_Kd as a (relative) path string.

    Beyond the reference, which imports each OBJ as ONE mesh with the
    XML-assigned material (resource/shape.cpp:219-278, single-mesh
    assimp import)."""
    mats: dict[str, dict] = {}
    cur: dict | None = None
    try:
        lines = Path(path).read_text(errors="replace").splitlines()
    except OSError:
        return mats
    for line in lines:
        p = line.split()
        if not p or p[0].startswith("#"):
            continue
        if p[0] == "newmtl" and len(p) > 1:
            cur = mats.setdefault(p[1], {})
        elif cur is None:
            continue
        elif p[0] in ("Kd", "Ks", "Ke") and len(p) >= 4:
            cur[p[0]] = (float(p[1]), float(p[2]), float(p[3]))
        elif p[0] in ("Ns", "d") and len(p) >= 2:
            cur[p[0]] = float(p[1])
        elif p[0] == "map_Kd" and len(p) >= 2:
            cur["map_Kd"] = p[-1]
    return mats


def load_obj_groups(
    path: str | Path,
) -> tuple[list[tuple[str, str | None, Mesh]], str | None]:
    """OBJ reader preserving usemtl/g/o group structure: returns
    ([(group name, mtl name, Mesh)], mtllib filename). Faces before any
    group statement land in group "default". Each group deduplicates
    its own corners (independent index spaces)."""
    positions, texcoords, normals = [], [], []
    groups: dict[tuple[str, str | None], dict] = {}
    gname, mtl = "default", None
    mtllib = None

    def bucket():
        key = (gname, mtl)
        if key not in groups:
            groups[key] = {
                "pos": [], "uv": [], "n": [], "idx": [],
                "map": {}, "has_uv": False, "has_n": False,
            }
        return groups[key]

    def corner(b, spec: str) -> int:
        parts = spec.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ti - 1 if ti > 0 else (len(texcoords) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(normals) + ni if ni else -1)
        key = (vi, ti, ni)
        if key in b["map"]:
            return b["map"][key]
        idx = len(b["pos"])
        b["map"][key] = idx
        b["pos"].append(positions[vi])
        if ti >= 0:
            b["has_uv"] = True
            b["uv"].append(texcoords[ti])
        else:
            b["uv"].append((0.0, 0.0))
        if ni >= 0:
            b["has_n"] = True
            b["n"].append(normals[ni])
        else:
            b["n"].append((0.0, 0.0, 0.0))
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                positions.append((float(p[1]), float(p[2]), float(p[3])))
            elif p[0] == "vt":
                texcoords.append((float(p[1]), float(p[2]) if len(p) > 2 else 0.0))
            elif p[0] == "vn":
                normals.append((float(p[1]), float(p[2]), float(p[3])))
            elif p[0] in ("g", "o") and len(p) > 1:
                gname = p[1]
            elif p[0] == "usemtl" and len(p) > 1:
                mtl = p[1]
            elif p[0] == "mtllib" and len(p) > 1:
                mtllib = p[-1]
            elif p[0] == "f":
                b = bucket()
                ids = [corner(b, s) for s in p[1:]]
                for k in range(1, len(ids) - 1):
                    b["idx"].append((ids[0], ids[k], ids[k + 1]))

    out = []
    for (g, m), b in groups.items():
        if not b["idx"]:
            continue
        out.append((
            g,
            m,
            Mesh(
                np.asarray(b["pos"], np.float32),
                np.asarray(b["n"], np.float32) if b["has_n"] else None,
                np.asarray(b["uv"], np.float32) if b["has_uv"] else None,
                np.asarray(b["idx"], np.uint32),
            ),
        ))
    return out, mtllib


class ShapeManager:
    """Shape registry deduping built-ins and mesh files by key."""

    def __init__(self):
        self._cache: dict[str, Shape] = {}
        self._group_cache: dict[str, tuple] = {}

    def _get(self, key: str, builder) -> Shape:
        if key not in self._cache:
            shape = builder()
            shape.key = key
            self._cache[key] = shape
        return self._cache[key]

    def load_rectangle(self) -> Shape:
        def build():
            mesh = _rectangle_mesh()
            s = Shape(ShapeType.RECTANGLE, mesh)
            s.aabb.merge_points(mesh.positions)
            return s

        return self._get("builtin/rectangle", build)

    def load_cube(self) -> Shape:
        def build():
            mesh = _cube_mesh()
            s = Shape(ShapeType.CUBE, mesh)
            s.aabb.merge_points(mesh.positions)
            return s

        return self._get("builtin/cube", build)

    def load_sphere(self) -> Shape:
        def build():
            s = Shape(ShapeType.SPHERE, None)
            s.aabb.merge_point([-1.0, -1.0, -1.0]).merge_point([1.0, 1.0, 1.0])
            return s

        return self._get("builtin/sphere", build)

    def load_mesh(self, path: str | Path) -> Shape:
        key = str(Path(path))

        def build():
            ext = Path(key).suffix.lower()
            if ext == ".ply":
                from benchmark.reference.scene.mesh_io import load_ply

                pos, nrm, uv, idx = load_ply(key)
                mesh = Mesh(pos, nrm, uv, idx)
            elif ext in (".gltf", ".glb"):
                from benchmark.reference.scene.mesh_io import load_gltf

                pos, nrm, uv, idx = load_gltf(key)
                mesh = Mesh(pos, nrm, uv, idx)
            elif ext == ".stl":
                from benchmark.reference.scene.mesh_io import load_stl

                pos, nrm, uv, idx = load_stl(key)
                mesh = Mesh(pos, nrm, uv, idx)
            elif ext == ".dae":
                from benchmark.reference.scene.mesh_io import load_dae

                pos, nrm, uv, idx = load_dae(key)
                mesh = Mesh(pos, nrm, uv, idx)
            else:
                mesh = load_obj(key)
            s = Shape(ShapeType.OBJ, mesh)
            s.aabb.merge_points(mesh.positions)
            return s

        return self._get(key, build)

    def load_mesh_groups(
        self, path: str | Path
    ) -> tuple[list[tuple[str, str | None, Shape]], str | None]:
        """OBJ split into per-usemtl/g groups, each its own cached
        Shape; returns ([(group, mtl name, Shape)], mtllib filename)."""
        key = str(Path(path))
        probe = f"{key}#groups"
        if probe not in self._group_cache:
            groups, mtllib = load_obj_groups(key)
            shapes = []
            for g, m, mesh in groups:
                def build(mesh=mesh):
                    s = Shape(ShapeType.OBJ, mesh)
                    s.aabb.merge_points(mesh.positions)
                    return s

                shapes.append((g, m, self._get(f"{key}#{g}#{m}", build)))
            self._group_cache[probe] = (shapes, mtllib)
        return self._group_cache[probe]

    def clear(self) -> None:
        self._cache.clear()
        self._group_cache.clear()
