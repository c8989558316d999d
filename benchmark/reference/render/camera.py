"""Device camera ray generation (plane layout).

Mirrors pupiloptixlab_tpu/render/camera.py: jittered subpixel ->
sample_to_camera (perspective divide, normalize) -> camera_to_world
rotation; origin from the translation column.
"""

from __future__ import annotations

import torch

from benchmark.reference.flatten.types import CameraBlock
from benchmark.reference.render.vec import Vec3


def generate_rays(
    camera: CameraBlock,
    width: int,
    height: int,
    jitter_x: torch.Tensor,
    jitter_y: torch.Tensor,
):
    """Primary rays for the full film in row-major pixel order
    (y*width + x). Returns (origin Vec3, direction Vec3)."""
    idx = torch.arange(width * height, dtype=torch.int32, device=jitter_x.device)
    return generate_rays_for(camera, width, height, idx, jitter_x, jitter_y)


def generate_rays_for(
    camera: CameraBlock,
    width: int,
    height: int,
    pixel_ids: torch.Tensor,
    jitter_x: torch.Tensor,
    jitter_y: torch.Tensor,
):
    """Primary rays for arbitrary per-lane pixel ids."""
    n = pixel_ids.shape[0]
    idx = pixel_ids
    px = (idx % width).to(torch.float32)
    py = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    sx = (px + jitter_x) / width
    sy = (py + jitter_y) / height

    s = camera.sample_to_camera
    c = camera.camera_to_world
    dx = s[0, 0] * sx + s[0, 1] * sy + s[0, 3]
    dy = s[1, 0] * sx + s[1, 1] * sy + s[1, 3]
    dz = s[2, 0] * sx + s[2, 1] * sy + s[2, 3]
    dw = s[3, 0] * sx + s[3, 1] * sy + s[3, 3]
    d = Vec3(dx / dw, dy / dw, dz / dw).normalized()
    world_d = Vec3(
        c[0, 0] * d.x + c[0, 1] * d.y + c[0, 2] * d.z,
        c[1, 0] * d.x + c[1, 1] * d.y + c[1, 2] * d.z,
        c[2, 0] * d.x + c[2, 1] * d.y + c[2, 2] * d.z,
    ).normalized()
    origin = Vec3(c[0, 3].expand(n), c[1, 3].expand(n), c[2, 3].expand(n))
    return origin, world_d
