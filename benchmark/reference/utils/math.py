"""Host-side math: 4x4 affine transforms, AABB.

Behavioral parity notes (conventions match the reference framework,
framework/util/{type.h,transform.cpp}):

* Matrices are stored row-major but act in **column-vector** convention:
  ``p' = M @ [p, 1]`` with the translation in the last column.
* ``Transform`` composes ops *left-multiplied*: ``Rotate`` then ``Translate``
  yields ``T @ R`` (translate applied last), matching
  ``transform.cpp:Translate/Rotate/Scale`` (``matrix = op * matrix``).
* ``look_at`` reproduces ``XMMatrixLookAtRH`` + inverse-transpose
  (transform.cpp:96-109): camera-to-world columns are
  ``[x=cross(up,z), y=cross(z,x), z=normalize(origin-target), origin]``.
  The mitsuba3 handedness fix (negating columns 0 and 2 of the 3x3;
  resource/xml/util_loader.cpp:159-166) is applied by the XML loader,
  not here.

Everything here is plain numpy float32 — it runs on the host during scene
load/flatten; device code gets raw arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def normalize(v: np.ndarray) -> np.ndarray:
    v = _f32(v)
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


def translate_matrix(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    return m


def scale_matrix(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def rotate_matrix(ux: float, uy: float, uz: float, angle_deg: float) -> np.ndarray:
    """Rotation about an axis by ``angle_deg`` degrees (column-vector).

    Quaternion-derived matrix, same formula as transform.cpp:7-50.
    """
    u = normalize([ux, uy, uz])
    theta = math.radians(angle_deg)
    a = math.cos(0.5 * theta)
    s = math.sin(0.5 * theta)
    b, c, d = s * u[0], s * u[1], s * u[2]
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 1 - 2 * c * c - 2 * d * d
    m[0, 1] = 2 * b * c - 2 * a * d
    m[0, 2] = 2 * a * c + 2 * b * d
    m[1, 0] = 2 * b * c + 2 * a * d
    m[1, 1] = 1 - 2 * b * b - 2 * d * d
    m[1, 2] = 2 * c * d - 2 * a * b
    m[2, 0] = 2 * b * d - 2 * a * c
    m[2, 1] = 2 * a * b + 2 * c * d
    m[2, 2] = 1 - 2 * b * b - 2 * c * c
    return m


def look_at_matrix(origin, target, up) -> np.ndarray:
    """Right-handed camera-to-world (column-vector convention).

    Equivalent to transpose(inverse(XMMatrixLookAtRH(origin,target,up)))
    in the reference (transform.cpp:96-109): camera +Z points from target
    toward origin (away from the view direction).
    """
    origin, target, up = _f32(origin), _f32(target), _f32(up)
    z = normalize(origin - target)
    x = normalize(np.cross(up, z))
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, origin
    return m


def mitsuba_handedness_fix(m: np.ndarray) -> np.ndarray:
    """Negate columns 0 and 2 of the 3x3 block.

    Mitsuba3: +X left, +Z view; reference convention: +X right, +Z -view.
    Applied to look-at to_world transforms (util_loader.cpp:159-166) and
    again to sensor transforms (scene.cpp:132-139) — for a look-at sensor
    the two fixes cancel.
    """
    out = m.copy()
    out[:3, 0] *= -1.0
    out[:3, 2] *= -1.0
    return out


def transform_point(p: np.ndarray, m: np.ndarray) -> np.ndarray:
    p = _f32(p)
    h = m[:3, :3] @ p + m[:3, 3]
    w = m[3, :3] @ p + m[3, 3]
    return h / w


def transform_points(pts: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(N,3) batch of points through a 4x4 (column-vector)."""
    pts = _f32(pts)
    h = pts @ m[:3, :3].T + m[:3, 3]
    w = pts @ m[3, :3].T + m[3, 3]
    return h / w[:, None]


def transform_vector(v: np.ndarray, m: np.ndarray) -> np.ndarray:
    return m[:3, :3] @ _f32(v)


def transform_normals(normals: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(N,3) normals through inverse-transpose of ``m``; renormalized."""
    it = np.linalg.inv(m[:3, :3]).T.astype(np.float32)
    out = _f32(normals) @ it.T
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-20)


@dataclass
class Transform:
    """Affine transform builder mirroring util::Transform.

    Ops compose as ``matrix = op @ matrix`` (the newest op applies last
    to points), matching transform.cpp.
    """

    matrix: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))

    def translate(self, x: float, y: float, z: float) -> "Transform":
        self.matrix = translate_matrix(x, y, z) @ self.matrix
        return self

    def scale(self, x: float, y: float, z: float) -> "Transform":
        self.matrix = scale_matrix(x, y, z) @ self.matrix
        return self

    def rotate(self, ux: float, uy: float, uz: float, angle_deg: float) -> "Transform":
        self.matrix = rotate_matrix(ux, uy, uz, angle_deg) @ self.matrix
        return self

    def look_at(self, origin, target, up) -> "Transform":
        self.matrix = look_at_matrix(origin, target, up)
        return self


@dataclass
class AABB:
    """Axis-aligned bounding box (util/aabb.h behavior)."""

    min: np.ndarray = field(default_factory=lambda: np.full(3, np.inf, np.float32))
    max: np.ndarray = field(default_factory=lambda: np.full(3, -np.inf, np.float32))

    @property
    def valid(self) -> bool:
        return bool(np.all(self.min <= self.max))

    def merge_point(self, p) -> "AABB":
        p = _f32(p)
        self.min = np.minimum(self.min, p)
        self.max = np.maximum(self.max, p)
        return self

    def merge_points(self, pts: np.ndarray) -> "AABB":
        if len(pts):
            self.min = np.minimum(self.min, pts.min(axis=0).astype(np.float32))
            self.max = np.maximum(self.max, pts.max(axis=0).astype(np.float32))
        return self

    def merge(self, other: "AABB") -> "AABB":
        self.min = np.minimum(self.min, other.min)
        self.max = np.maximum(self.max, other.max)
        return self

    def transform(self, m: np.ndarray) -> "AABB":
        """Transform by the 8-corner method (util/aabb.h:33-47)."""
        if not self.valid:
            return self
        xs = [self.min[0], self.max[0]]
        ys = [self.min[1], self.max[1]]
        zs = [self.min[2], self.max[2]]
        corners = np.array(
            [[x, y, z] for x in xs for y in ys for z in zs], dtype=np.float32
        )
        pts = transform_points(corners, m)
        return AABB(pts.min(axis=0), pts.max(axis=0))

    @property
    def center(self) -> np.ndarray:
        return (self.min + self.max) * 0.5
