"""The reference's entry: pixels of a render worked out again, from the scene
file, the camera's moves and the seeds alone.

``load`` reads the scene with the reference's own loader and flattens it
with its own flatten (no BVH: every triangle query is a brute sweep).
``accumulate`` traces the given pixels for a run of samples (one seed a
sample) in one batch of lanes and folds them in sample order with the
progressive blend ``acc + (r - acc) * 1 / (float32(n) + 1)``, as a render
or a run of frames accumulates them from count 0. With ``lowp`` the film is
held in bfloat16 (each sample's radiance, the blend and the AOVs rounded
to it): the comparison's control, one precision below the float32 that the
configurations state.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.flatten.flatten import camera_block, flatten_scene
from benchmark.reference.render.integrator import render_sample
from benchmark.reference.render.rng import M32
from benchmark.reference.render.sampling import aces_tonemap, gamma_correct
from benchmark.reference.scene.scene import load_scene
from benchmark.reference.utils.camera import Camera, CameraDesc
from benchmark.reference.utils.math import Transform

# WASDQE in the camera frame, forward = -z (the viewer's key map)
KEY_DELTA = {
    "w": (0.0, 0.0, -1.0), "s": (0.0, 0.0, 1.0),
    "a": (-1.0, 0.0, 0.0), "d": (1.0, 0.0, 0.0),
    "q": (0.0, -1.0, 0.0), "e": (0.0, 1.0, 0.0),
}


@dataclass
class Reference:
    scene: object
    data: object
    config: object
    device: torch.device

    def camera(self, keys=()) -> Camera:
        """The scene's camera after the key steps ``keys``, in order."""
        s = self.scene.sensor
        cam = Camera(CameraDesc(
            fov_y=s.fov, aspect_ratio=s.film.w / s.film.h, near_clip=s.near_clip,
            far_clip=s.far_clip, to_world=Transform(s.transform.matrix)))
        scale = Camera.sensitivity * Camera.sensitivity_scale
        for k in keys:
            cam.move(np.asarray(KEY_DELTA[k], np.float32) * scale)
        return cam


def load(scene_path: Path, device) -> Reference:
    scene = load_scene(scene_path)
    data, config = flatten_scene(scene, device=device)
    return Reference(scene, data, config, torch.device(device))


def accumulate(ref: Reference, pix, seeds, keys=(), lowp: bool = False, keep=None) -> dict:
    """The accumulated radiance (P, 3) of pixels ``pix`` after the samples
    at ``seeds`` (the first at count 0), with the last sample's albedo and
    normal, all float32 on the host; with ``keep`` (sample counts) also the
    accumulation after each of those counts, under ``"kept"``."""
    dev = ref.device
    pix = torch.as_tensor(np.asarray(pix), dtype=torch.int64, device=dev)
    p, s = pix.shape[0], len(seeds)
    lanes = pix.repeat(s)
    lane_seed = torch.as_tensor([int(x) & M32 for x in seeds], dtype=torch.int64,
                                device=dev).repeat_interleave(p)
    cam = camera_block(ref.camera(keys), dev)
    with torch.inference_mode():
        out = render_sample(ref.data, cam, lane_seed, ref.config, lanes)
        dtype = torch.bfloat16 if lowp else torch.float32
        rad = out["radiance"].reshape(s, p, 3).to(dtype)
        acc = rad[0].clone()
        kept = {}
        for n in range(1, s + 1):
            if keep is not None and n in keep:
                kept[n] = acc.float().cpu().numpy()
            if n == s:
                break
            t = float(np.float32(1.0) / (np.float32(n) + np.float32(1.0)))
            acc = acc + (rad[n] - acc) * t
        last = slice((s - 1) * p, s * p)
        return {
            "kept": kept,
            "accum": acc.float().cpu().numpy(),
            "albedo": out["albedo"][last].to(dtype).float().cpu().numpy(),
            "normal": out["normal"][last].to(dtype).float().cpu().numpy(),
        }


def display_u8(rgb: np.ndarray, device) -> np.ndarray:
    """Linear radiance -> the viewer's uint8 (ACES, gamma 1/2.2, clamp,
    ``x * 255 + 0.5`` truncated), computed on ``device``."""
    x = torch.as_tensor(rgb, dtype=torch.float32, device=device)
    x = torch.clamp(gamma_correct(aces_tonemap(x), 2.2), 0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
