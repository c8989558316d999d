"""Display transfer: ACES tone map + gamma, computed on the device.

Counterpart of pupiloptixlab_tpu/display/tonemap.py (the reference's
fullscreen-quad pixel shader, system/gui/output.hlsl:30-73): optional ACES
tone mapping, then optional gamma 1/2.2 encode. Plain torch on the
tensor's own device, before any device->host fetch, so the host only
receives display-ready bytes.
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch.render.sampling import aces_tonemap, gamma_correct


def aces_gamma_to_display(
    rgb: torch.Tensor, tone_mapping: bool = True, gamma: bool = True
) -> torch.Tensor:
    """(..., 3) linear radiance -> uint8-ready [0,1] display values."""
    out = rgb
    if tone_mapping:
        out = aces_tonemap(out)
    if gamma:
        out = gamma_correct(out, 2.2)
    return torch.clamp(out, 0.0, 1.0)


def to_display_u8(
    rgb: torch.Tensor, tone_mapping: bool = True, gamma: bool = True,
    stride: int = 1,
) -> torch.Tensor:
    """(..., 3) linear radiance -> display uint8, quantized on the device,
    so a fetch moves a quarter of the float image's bytes.

    ``stride`` > 1 additionally subsamples (h, w, 3) input on the device
    before the fetch (the motion-preview path of the display pump)."""
    if stride > 1:
        rgb = rgb[::stride, ::stride]
    out = aces_gamma_to_display(rgb, tone_mapping, gamma)
    return (out * 255.0 + 0.5).to(torch.uint8)


def expand_to_rgba(arr: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """float1/2/3/4 buffer -> (h, w, 4) like buffer_to_canvas.cu:6-34."""
    n = width * height
    if arr.dim() == 1:
        arr = arr[:, None]
    c = arr.shape[1]
    out = torch.ones((n, 4), dtype=torch.float32, device=arr.device)
    if c >= 3:
        out[:, :c] = arr[:, :c]
    elif c == 2:
        out[:, :2] = arr
    else:
        out[:, :3] = arr[:, 0:1]
    return out.reshape(height, width, 4)
