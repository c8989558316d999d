"""Host-side interactive camera.

Parity target: util::Camera (framework/util/camera.{h,cpp})
and world::CameraHelper (world/camera.h). Reproduces exactly:

* ``sample_to_camera`` = transpose(inv(P_row @ T_row @ S_row)) where the
  factors are the row-vector-convention DirectXMath matrices
  (camera.cpp:7-20): PerspectiveFovRH, Translation(1,1,0), Scaling(.5,.5,1).
  The result maps a film point (sx, sy, 0, 1), sx/sy in [0,1], to a
  camera-space point (column-vector convention).
* ``to_world`` (camera-to-world) with rotate/move interaction semantics
  (camera.cpp:104-123): drag rotates pitch*R*yaw, move translates in the
  camera frame.
* fov clamped to [0.012, 180] on interactive edits (world/camera.cpp:29-38).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.utils.math import (
    Transform,
    rotate_matrix,
    translate_matrix,
)

X = np.array([1.0, 0.0, 0.0], np.float32)
Y = np.array([0.0, 1.0, 0.0], np.float32)
Z = np.array([0.0, 0.0, 1.0], np.float32)

FOV_MIN = 0.012
FOV_MAX = 180.0


def perspective_fov_rh_row(fov_y_rad: float, aspect: float, zn: float, zf: float) -> np.ndarray:
    """XMMatrixPerspectiveFovRH in its native row-vector convention."""
    h = 1.0 / math.tan(0.5 * fov_y_rad)
    w = h / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = zf / (zn - zf)
    m[2, 3] = -1.0
    m[3, 2] = zn * zf / (zn - zf)
    return m


def sample_to_camera_matrix(fov_y_deg: float, aspect: float, zn: float, zf: float) -> np.ndarray:
    """Film([0,1]^2, z=0 plane) -> camera space, column-vector convention.

    Matches util::Camera::GetSampleToCameraMatrix (camera.cpp:7-20).
    """
    p = perspective_fov_rh_row(math.radians(fov_y_deg), aspect, zn, zf)
    # Row-vector convention translation / scale (DirectXMath layout).
    t = np.eye(4, dtype=np.float32)
    t[3, 0], t[3, 1] = 1.0, 1.0
    s = np.diag([0.5, 0.5, 1.0, 1.0]).astype(np.float32)
    m_row = p @ t @ s
    return np.linalg.inv(m_row).T.astype(np.float32)


@dataclass
class CameraDesc:
    fov_y: float = 90.0
    aspect_ratio: float = 1.0
    near_clip: float = 0.01
    far_clip: float = 10000.0
    to_world: Transform = field(default_factory=Transform)


class Camera:
    """Interactive host camera; produces the two GPU matrices.

    The device-side camera block (render/camera.h:7-10 in the reference)
    is just ``{sample_to_camera, camera_to_world}``.
    """

    sensitivity: float = 0.05
    sensitivity_scale: float = 1.0

    def __init__(self, desc: CameraDesc | None = None):
        self._fov_y = 90.0
        self._aspect = 1.0
        self._near = 0.01
        self._far = 10000.0
        self._position = np.zeros(3, np.float32)
        self._rotate = np.eye(4, dtype=np.float32)      # world->camera rotation
        self._rotate_inv = np.eye(4, dtype=np.float32)  # camera->world rotation
        if desc is not None:
            self.reset(desc)

    # -- setup ------------------------------------------------------------
    def reset(self, desc: CameraDesc) -> None:
        self.set_projection(desc.fov_y, desc.aspect_ratio, desc.near_clip, desc.far_clip)
        self.set_world_transform(desc.to_world.matrix)

    def set_projection(self, fov_y: float, aspect: float, near: float = 0.01, far: float = 10000.0) -> None:
        self._fov_y, self._aspect, self._near, self._far = fov_y, aspect, near, far

    def set_fov(self, fov: float) -> None:
        self._fov_y = min(max(fov, FOV_MIN), FOV_MAX)

    def set_fov_delta(self, delta: float) -> None:
        self.set_fov(self._fov_y + delta)

    def set_world_transform(self, to_world: np.ndarray) -> None:
        """Decompose a camera-to-world matrix into position + rotation.

        Mirrors camera.cpp:83-103: position from the translation column;
        rotation = transpose of the 3x3 block (assumed orthonormal).
        """
        m = np.asarray(to_world, np.float32)
        self._position = m[:3, 3].copy()
        self._rotate = np.eye(4, dtype=np.float32)
        self._rotate[:3, :3] = m[:3, :3].T
        self._rotate_inv = np.eye(4, dtype=np.float32)
        self._rotate_inv[:3, :3] = m[:3, :3]

    # -- queries ----------------------------------------------------------
    @property
    def fov_y(self) -> float:
        return self._fov_y

    @property
    def position(self) -> np.ndarray:
        return self._position.copy()

    @property
    def view(self) -> np.ndarray:
        """World-to-camera matrix (camera.cpp:37-44)."""
        t = translate_matrix(-self._position[0], -self._position[1], -self._position[2])
        return self._rotate @ t

    @property
    def to_world(self) -> np.ndarray:
        return np.linalg.inv(self.view).astype(np.float32)

    @property
    def sample_to_camera(self) -> np.ndarray:
        return sample_to_camera_matrix(self._fov_y, self._aspect, self._near, self._far)

    def coordinate_system(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(right, up, forward) world-space camera axes (camera.cpp:63-68)."""
        r = self._rotate_inv[:3, :3]
        return r @ X, r @ Y, r @ Z

    # -- interaction (gui drag / wasdqe) ----------------------------------
    def rotate(self, delta_x: float, delta_y: float) -> None:
        """Mouse-drag rotate: pitch * R * yaw (camera.cpp:105-115)."""
        pitch = rotate_matrix(*X, delta_y)
        yaw = rotate_matrix(*Y, delta_x)
        self._rotate = pitch @ self._rotate @ yaw
        self._rotate_inv = self._rotate.T.copy()

    def move(self, delta: np.ndarray) -> None:
        """Translate in the camera frame (camera.cpp:117-123)."""
        world_delta = self._rotate_inv[:3, :3] @ np.asarray(delta, np.float32)
        self._position = self._position + world_delta

    def gpu_block(self) -> dict[str, np.ndarray]:
        """The device camera uniform: both matrices, f32."""
        return {
            "sample_to_camera": self.sample_to_camera,
            "camera_to_world": self.to_world,
        }
