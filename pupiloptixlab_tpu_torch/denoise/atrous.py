"""PyTorch denoiser: edge-avoiding a-trous wavelet filtering.

Counterpart of pupiloptixlab_tpu/denoise/atrous.py, the stand-in for the
OptiX AI denoiser wrapper (optix/denoiser.{h,cpp}): an SVGF-style guided
filter with no trained weights, and API parity with optix::Denoiser:

* mode bitfield {USE_ALBEDO, USE_NORMAL, APPLY_TO_AOV, TEMPORAL,
  UPSCALE_2X, TILED} (denoiser.h:9-17),
* ``setup(w, h)`` fixes shapes, ``execute({...})`` takes the guide layers
  the PT pass emits (color/albedo/normal + optional previous output for
  temporal), mirroring denoiser.cpp:171-267,
* tiled execution with overlap (denoiser.cpp:100-112, 232-246).

Filter: N iterations of the 5x5 B3-spline a-trous kernel with joint
bilateral weights on colour distance, normal alignment and albedo
similarity (Dammertz et al. 2010 / SVGF's edge-stopping functions).

Images are (h, w, C) tensors on any device; every function computes on
its inputs' device. On the card, ``atrous_denoise`` without variance and
AOVs runs K9 (denoise/atrous_kernel.py), the set the reference sends to
its Pallas kernel on a TPU; with either it runs the plain filter, as the
reference runs jnp there. The arithmetic keeps the reference's (h, w)
channel planes and its order of operations.
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F

from pupiloptixlab_tpu_torch.denoise.atrous_kernel import (
    atrous_denoise_cuda,
    atrous_step,
    planes_of,
)


class DenoiserMode(enum.IntFlag):
    NONE = 0
    USE_ALBEDO = 1
    USE_NORMAL = 2
    APPLY_TO_AOV = 4
    TEMPORAL = 8
    UPSCALE_2X = 16
    TILED = 32


def _shift2d(img, dy: int, dx: int):
    """Shift with edge clamping (img is (h, w, c) or (h, w)): element
    (y, x) of the result is img[clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape[:2]
    dev = img.device
    ys = (torch.arange(h, device=dev) + dy).clamp(0, h - 1)
    xs = (torch.arange(w, device=dev) + dx).clamp(0, w - 1)
    return img[ys][:, xs]


def _atrous_denoise(color, albedo, normal, variance, aovs, iterations: int,
                    use_albedo: bool, use_normal: bool, sigma_color: float,
                    sigma_albedo: float, sigma_normal: float, sigma_variance: float):
    """The plain filter (``_atrous_denoise_jnp``): ``iterations`` of
    ``atrous_step`` at steps 2^i; returns (color', tuple of aovs')."""
    planes = planes_of(color)
    a, n = planes_of(albedo), planes_of(normal)
    aov_planes = torch.cat([planes_of(x) for x in aovs]) if aovs else None
    var = variance.to(torch.float32) if variance is not None else None
    for it in range(iterations):
        planes, aov_planes, var = atrous_step(
            planes, a, n, 1 << it, use_albedo, use_normal, sigma_color, sigma_albedo,
            sigma_normal, variance=var, aovs=aov_planes, sigma_variance=sigma_variance)
    out = planes.permute(1, 2, 0).contiguous()
    aovs_out = tuple(aov_planes[3 * i:3 * i + 3].permute(1, 2, 0).contiguous()
                     for i in range(len(aovs)))
    return out, aovs_out


def atrous_denoise(
    color: torch.Tensor,   # (h, w, 3) linear radiance
    albedo: torch.Tensor,  # (h, w, 3)
    normal: torch.Tensor,  # (h, w, 3)
    iterations: int = 5,
    use_albedo: bool = True,
    use_normal: bool = True,
    sigma_color: float = 0.35,
    sigma_albedo: float = 0.15,
    sigma_normal: float = 0.25,
    variance: torch.Tensor | None = None,  # (h, w) luminance variance
    aovs: tuple = (),                      # extra (h, w, 3) layers
    sigma_variance: float = 4.0,
):
    """Edge-avoiding a-trous filter.

    ``variance``: per-pixel luminance variance of ``color`` switches the
    luminance edge-stop to the SVGF form exp(-|dl| / (sigma_v *
    sqrt(gauss3x3(var)))); the variance field is filtered alongside with
    w^2 weights.

    ``aovs``: extra (h, w, 3) layers filtered with the SAME weights as
    the beauty (the APPLY_TO_AOV semantics). When given, returns
    (color', tuple(aovs')) instead of color' alone.
    """
    plain = variance is None and not aovs
    if plain and color.device.type == "cuda":
        return atrous_denoise_cuda(
            color, albedo, normal, iterations=iterations,
            use_albedo=use_albedo, use_normal=use_normal,
            sigma_color=sigma_color, sigma_albedo=sigma_albedo,
            sigma_normal=sigma_normal,
        )
    out, aovs_out = _atrous_denoise(
        color, albedo, normal, variance, tuple(aovs), iterations, use_albedo,
        use_normal, sigma_color, sigma_albedo, sigma_normal, sigma_variance,
    )
    return (out, aovs_out) if aovs else out


def _grid(h: int, w: int, device):
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return ys, xs


def reproject(previous, motion):
    """Warp the previous frame by per-pixel MOTION VECTORS (h, w, 2):
    motion[y, x] = (dx, dy) from the current pixel to where its surface
    point was in the previous frame (the optix Denoiser flow-layer
    convention, denoiser.cpp:145-168). Bilinear sample with edge clamp;
    returns (warped, valid) where valid marks in-frame source positions.
    """
    h, w = previous.shape[:2]
    ys, xs = _grid(h, w, previous.device)
    sx = xs + motion[..., 0]
    sy = ys + motion[..., 1]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0 = torch.clamp(torch.floor(sx), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy), 0, h - 1)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)

    def tap(yy, xx):
        return previous[yy, xx]

    warped = (
        tap(y0i, x0i) * ((1 - fx) * (1 - fy))[..., None]
        + tap(y0i, x1i) * (fx * (1 - fy))[..., None]
        + tap(y1i, x0i) * ((1 - fx) * fy)[..., None]
        + tap(y1i, x1i) * (fx * fy)[..., None]
    )
    return warped, valid


def camera_motion_vectors(world_pos, hit_mask, prev_camera, width: int, height: int):
    """Flow from the CURRENT frame's first-hit world positions and the
    PREVIOUS frame's camera (static geometry): motion[y, x] = previous
    pixel of the surface point minus the current pixel.

    ``prev_camera`` is a CameraBlock (sample_to_camera, camera_to_world)
    from the previous frame; ``world_pos`` is (h, w, 3); ``hit_mask``
    (h, w) disables flow for env pixels (flow 0 = reuse in place).
    """
    dev = world_pos.device
    c2w = torch.as_tensor(prev_camera.camera_to_world, dtype=torch.float32, device=dev)
    s2c = torch.as_tensor(prev_camera.sample_to_camera, dtype=torch.float32, device=dev)
    w2c = torch.linalg.inv(c2w)
    c2s = torch.linalg.inv(s2c)
    p = world_pos.reshape(-1, 3)
    ones = torch.ones((p.shape[0], 1), dtype=torch.float32, device=dev)
    cam = torch.cat([p, ones], 1) @ w2c.T
    samp = cam @ c2s.T
    s = samp[:, :2] / torch.clamp(torch.abs(samp[:, 3:4]), min=1e-12) * torch.sign(
        samp[:, 3:4]
    )
    prev_px = s[:, 0] * width
    prev_py = s[:, 1] * height
    ys, xs = _grid(height, width, dev)
    dx = prev_px.reshape(height, width) - (xs + 0.5)
    dy = prev_py.reshape(height, width) - (ys + 0.5)
    flow = torch.stack([dx, dy], dim=-1)
    return torch.where(hit_mask[..., None], flow, 0.0)


def temporal_blend(current, previous, alpha: float = 0.2, clamp_k: float = 1.0,
                   motion=None):
    """Exponential temporal accumulation with neighborhood clamping
    (the UseTemporal mode analog). With ``motion`` (h, w, 2) the
    previous frame is REPROJECTED first (denoiser.cpp:145-168's flow
    input); without it, static-camera in-place reuse."""
    if motion is not None:
        previous, valid = reproject(previous, motion)
        previous = torch.where(valid[..., None], previous, current)
    # 3x3 neighborhood min/max of current as the clamp window
    mn = current
    mx = current
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift2d(current, dy, dx)
            mn = torch.minimum(mn, s)
            mx = torch.maximum(mx, s)
    center = 0.5 * (mn + mx)
    half = 0.5 * (mx - mn) * clamp_k + 1e-4
    prev_clamped = torch.clamp(previous, min=center - half, max=center + half)
    return prev_clamped * (1.0 - alpha) + current * alpha


def _upscale_2x_guided(img, albedo_hi, normal_hi, sigma_albedo: float,
                       sigma_normal: float, sigma_spatial: float):
    """Joint-bilateral 2x upsample (Kopf et al. 2007) guided by
    FULL-resolution albedo/normal layers: the low-res radiance is
    resampled through a 3x3 low-res tap window whose weights combine a
    Gaussian spatial kernel with guide similarity at the TARGET (hi-res)
    pixel, so radiance edges land where the full-res G-buffer puts them.
    Every accumulation runs on (h, w) channel planes; the 4 output phases
    assemble by stack + reshape."""
    h, w = img.shape[:2]

    def planes(a):
        return [a[..., c] for c in range(3)]

    lr, lg, lb = planes(img)

    # low-res guides: 2x2 box reduction of the hi-res layers (normals
    # renormalized after averaging)
    def down(p):
        return 0.25 * (
            p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        )

    alo = [down(p) for p in planes(albedo_hi)]
    nlo = [down(p) for p in planes(normal_hi)]
    nrm = torch.sqrt(nlo[0] ** 2 + nlo[1] ** 2 + nlo[2] ** 2)
    inv_n = 1.0 / torch.clamp(nrm, min=1e-6)
    nlo = [p * inv_n for p in nlo]

    # edge-pad once; all taps are slices of the shared pad
    pads = F.pad(torch.stack([lr, lg, lb, *alo, *nlo])[None], (1, 1, 1, 1),
                 mode="replicate")[0]

    inv_2sa = 1.0 / (2.0 * sigma_albedo**2)
    inv_2ss = 1.0 / (2.0 * sigma_spatial**2)
    n_pow = max(int(round(1.0 / max(sigma_normal, 1e-3))), 1)

    phase_out = [[None, None], [None, None]]  # [py][px] -> 3 planes
    for py in (0, 1):
        for px in (0, 1):
            # hi-res guide planes seen by this phase (strided views)
            ahi = [p[py::2, px::2] for p in planes(albedo_hi)]
            nhi = [p[py::2, px::2] for p in planes(normal_hi)]
            acc = [torch.zeros((h, w), dtype=img.dtype, device=img.device)
                   for _ in range(3)]
            wsum = torch.zeros((h, w), dtype=img.dtype, device=img.device)
            # hi pixel center in low-res coords: y + (2*py - 1)/4
            oy = (2 * py - 1) / 4.0
            ox = (2 * px - 1) / 4.0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    def tap(i):
                        return pads[i, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

                    d2 = (oy - dy) ** 2 + (ox - dx) ** 2
                    w_ = torch.exp(torch.tensor(-d2 * inv_2ss, dtype=img.dtype,
                                                device=img.device))
                    da = (
                        (tap(3) - ahi[0]) ** 2
                        + (tap(4) - ahi[1]) ** 2
                        + (tap(5) - ahi[2]) ** 2
                    )
                    w_ = w_ * torch.exp(-da * inv_2sa)
                    ndot = torch.clamp(
                        tap(6) * nhi[0] + tap(7) * nhi[1] + tap(8) * nhi[2],
                        0.0, 1.0,
                    )
                    npw = ndot
                    for _ in range(n_pow - 1):
                        npw = npw * ndot
                    w_ = w_ * npw
                    for c in range(3):
                        acc[c] = acc[c] + tap(c) * w_
                    wsum = wsum + w_
            inv_w = 1.0 / torch.clamp(wsum, min=1e-8)
            phase_out[py][px] = [a * inv_w for a in acc]

    outs = []
    for c in range(3):
        # (h, 2, w, 2) -> (2h, 2w): a pure reshape/stack relayout
        quad = torch.stack(
            [
                torch.stack([phase_out[0][0][c], phase_out[0][1][c]], dim=-1),
                torch.stack([phase_out[1][0][c], phase_out[1][1][c]], dim=-1),
            ],
            dim=1,
        )
        outs.append(quad.reshape(2 * h, 2 * w))
    return torch.stack(outs, dim=-1)


def upscale_2x(img, albedo_hi=None, normal_hi=None, sigma_albedo: float = 0.1,
               sigma_normal: float = 0.25, sigma_spatial: float = 0.6):
    """2x upscale (the UseUpscale2X mode analog, denoiser.cpp:62-75).

    With FULL-resolution ``albedo_hi``/``normal_hi`` guide layers this
    is a joint-bilateral upsample; without guides it is plain bilinear."""
    if albedo_hi is not None and normal_hi is not None:
        return _upscale_2x_guided(img, albedo_hi, normal_hi, sigma_albedo,
                                  sigma_normal, sigma_spatial)
    h, w, _ = img.shape
    # jax.image.resize(..., "bilinear") at an exact 2x samples at half-pixel
    # centres and renormalises the triangle kernel at the borders, which
    # gives the edge pixel itself there: F.interpolate with
    # align_corners=False (source = (dst + 0.5) / 2 - 0.5, clamped at 0 and
    # at the last pixel) computes the same samples
    out = F.interpolate(img.permute(2, 0, 1)[None], size=(2 * h, 2 * w),
                        mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0).contiguous()


def denoise(
    color,
    albedo=None,
    normal=None,
    previous=None,
    mode: DenoiserMode = DenoiserMode.USE_ALBEDO | DenoiserMode.USE_NORMAL,
    iterations: int = 5,
    motion=None,
    variance=None,
    aovs: dict | None = None,
    albedo_hi=None,
    normal_hi=None,
):
    """One-shot functional interface; inputs are (h, w, 3) (+ optional
    (h, w, 2) motion vectors for temporal reprojection, an (h, w)
    luminance-variance plane for the SVGF edge-stop, and, with
    APPLY_TO_AOV in the mode, a dict of named (h, w, 3) AOV layers
    filtered with the beauty's weights). With AOVs the return is
    (color', {name: aov'}); otherwise just color'.

    ``albedo_hi``/``normal_hi``: (2h, 2w, 3) full-resolution guide
    layers for UPSCALE_2X; they switch the upscale from bilinear to the
    joint-bilateral guided form (see upscale_2x)."""
    use_albedo = bool(mode & DenoiserMode.USE_ALBEDO) and albedo is not None
    use_normal = bool(mode & DenoiserMode.USE_NORMAL) and normal is not None
    if albedo is None:
        albedo = torch.zeros_like(color)
    if normal is None:
        normal = torch.zeros_like(color)
    do_aov = bool(mode & DenoiserMode.APPLY_TO_AOV) and aovs
    names = tuple(aovs.keys()) if do_aov else ()
    res = atrous_denoise(
        color, albedo, normal,
        iterations=iterations, use_albedo=use_albedo, use_normal=use_normal,
        variance=variance,
        aovs=tuple(aovs[k] for k in names) if do_aov else (),
    )
    out, aov_list = res if do_aov else (res, ())
    if mode & DenoiserMode.TEMPORAL and previous is not None:
        out = temporal_blend(out, previous, motion=motion)
    if mode & DenoiserMode.UPSCALE_2X:
        out = upscale_2x(out, albedo_hi=albedo_hi, normal_hi=normal_hi)
    if do_aov:
        return out, dict(zip(names, aov_list))
    return out


class Denoiser:
    """Stateful wrapper mirroring optix::Denoiser Setup/Execute."""

    def __init__(self, mode: DenoiserMode = DenoiserMode.USE_ALBEDO | DenoiserMode.USE_NORMAL):
        self.mode = mode
        self.width = 0
        self.height = 0
        self.tile_size = 512
        self.overlap = 32
        self._previous = None

    def setup(self, width: int, height: int) -> None:
        self.width, self.height = width, height
        self._previous = None

    def execute(self, layers: dict):
        """layers: {'input': (h,w,3) [, 'albedo', 'normal', 'prev',
        'motion', 'variance', 'aovs': {name: (h,w,3)}, 'albedo_hi',
        'normal_hi']}: the optix::Denoiser::Execute layer set
        (denoiser.cpp:171-267; 'motion' is the temporal flow buffer, see
        camera_motion_vectors for the camera-only case; 'aovs' are the
        extra layers the AOV model kind denoises alongside the beauty).
        Returns the denoised beauty, or (beauty, {name: aov'}) when the
        mode has APPLY_TO_AOV and 'aovs' layers were given."""
        color = layers["input"]
        albedo = layers.get("albedo")
        normal = layers.get("normal")
        previous = layers.get("prev", self._previous)
        motion = layers.get("motion")
        variance = layers.get("variance")
        aovs = layers.get("aovs")
        albedo_hi = layers.get("albedo_hi")
        normal_hi = layers.get("normal_hi")
        do_aov = bool(self.mode & DenoiserMode.APPLY_TO_AOV) and aovs
        if self.mode & DenoiserMode.TILED and color.shape[0] > self.tile_size:
            out = self._execute_tiled(color, albedo, normal, previous)
            aov_out = None
        elif do_aov:
            out, aov_out = denoise(
                color, albedo, normal, previous, self.mode, motion=motion,
                variance=variance, aovs=aovs,
                albedo_hi=albedo_hi, normal_hi=normal_hi,
            )
        else:
            out = denoise(color, albedo, normal, previous, self.mode,
                          motion=motion, variance=variance,
                          albedo_hi=albedo_hi, normal_hi=normal_hi)
            aov_out = None
        if self.mode & DenoiserMode.TEMPORAL:
            if self.mode & DenoiserMode.UPSCALE_2X:
                # temporal history lives at the RENDER (low) resolution;
                # the upscaled output is 2x: box-reduce it back
                self._previous = 0.25 * (
                    out[0::2, 0::2] + out[0::2, 1::2]
                    + out[1::2, 0::2] + out[1::2, 1::2]
                )
            else:
                self._previous = out
        return (out, aov_out) if do_aov else out

    def _execute_tiled(self, color, albedo, normal, previous):
        """Overlapped tiles (denoiser.cpp:232-246 analog)."""
        h, w = color.shape[:2]
        ts, ov = self.tile_size, self.overlap
        out = torch.zeros_like(color)
        for y0 in range(0, h, ts):
            for x0 in range(0, w, ts):
                y1 = min(y0 + ts, h)
                x1 = min(x0 + ts, w)
                ya, xa = max(y0 - ov, 0), max(x0 - ov, 0)
                yb, xb = min(y1 + ov, h), min(x1 + ov, w)

                def crop(img):
                    return None if img is None else img[ya:yb, xa:xb]

                tile = denoise(
                    crop(color), crop(albedo), crop(normal), crop(previous),
                    self.mode & ~DenoiserMode.TILED,
                )
                out[y0:y1, x0:x1] = tile[y0 - ya:y0 - ya + (y1 - y0),
                                         x0 - xa:x0 - xa + (x1 - x0)]
        return out
