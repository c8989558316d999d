"""One edge-avoiding a-trous iteration: the K9 wrapper and its plain version.

Counterpart of pupiloptixlab_tpu/denoise/pallas_atrous.py. Kernel
(csrc/atrous.cu):
  atrous_iter (K9) <- _iter_kernel, launched once per iteration by
                      atrous_denoise_pallas
``atrous_denoise_cuda`` is the counterpart of ``atrous_denoise_pallas``:
(h, w, 3) in and out, one K9 launch per iteration at step 2^i, the colour
planes swapped between launches.

Images travel as (3, h, w) blocks of channel planes (the reference's
(h, w) plane arithmetic). The plain version, ``atrous_step``, is one
iteration of the reference's ``_atrous_denoise_jnp`` with its variance
(SVGF) and AOV options, operation by operation in the reference's order;
K9 computes it for calls without either. Edge padding is done with
clamped indices, which gives the reference's ``mode="edge"`` pad at any
step (the Pallas kernel's halo stops at step 16, i.e. 5 iterations).
"""

from __future__ import annotations

import torch

from pupiloptixlab_tpu_torch import kernels

# 5-tap B3 spline, separably combined into 25 taps
_B3 = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]


def normal_power(sigma_normal: float) -> tuple[float, int]:
    """(n_pow, npow_int): the normal edge-stop exponent 1 / sigma_normal,
    and that exponent as an integer where it is one in 1..8 (applied by
    repeated multiplication), else 0 (pow), as pallas_atrous.py:187-191."""
    n_pow = 1.0 / max(sigma_normal, 1e-3)
    k = round(n_pow)
    return n_pow, (int(k) if abs(n_pow - k) < 1e-6 and 1 <= k <= 8 else 0)


def _edge_pad(planes: torch.Tensor, halo: int) -> torch.Tensor:
    """(C, h, w) -> (C, h + 2 halo, w + 2 halo), edge values repeated
    (jnp.pad mode="edge") through clamped indices, for any halo."""
    _, h, w = planes.shape
    dev = planes.device
    ys = torch.arange(-halo, h + halo, device=dev).clamp(0, h - 1)
    xs = torch.arange(-halo, w + halo, device=dev).clamp(0, w - 1)
    return planes[:, ys][:, :, xs]


def atrous_step(color, albedo, normal, step: int, use_albedo: bool, use_normal: bool,
                sigma_color: float, sigma_albedo: float, sigma_normal: float,
                variance=None, aovs=None, sigma_variance: float = 4.0):
    """One a-trous iteration at ``step`` on (3, h, w) planes; ``variance``
    (h, w) switches the luminance edge-stop to the SVGF form and is carried
    with w^2 weights; ``aovs`` (3A, h, w) are filtered with the beauty's
    weights. Returns (color', aovs' or None, variance' or None)."""
    _, h, w = color.shape
    cr, cg, cb = color[0], color[1], color[2]
    ar, ag, ab_ = albedo[0], albedo[1], albedo[2]
    nr, ng, nb = normal[0], normal[1], normal[2]
    n_aov = 0 if aovs is None else aovs.shape[0]
    use_var = variance is not None
    inv_2sc = 1.0 / (2.0 * sigma_color**2)
    inv_2sa = 1.0 / (2.0 * sigma_albedo**2)
    n_pow, npow_int = normal_power(sigma_normal)

    def npow(x):
        if npow_int:
            y = x
            for _ in range(npow_int - 1):
                y = y * x
            return y
        return torch.pow(x, n_pow)

    halo = 2 * step
    stack = [color, albedo, normal]
    if n_aov:
        stack.append(aovs)
    if use_var:
        stack.append(variance[None])
    pads = _edge_pad(torch.cat(stack), halo)
    acc_r = torch.zeros_like(cr)
    acc_g = torch.zeros_like(cr)
    acc_b = torch.zeros_like(cr)
    acc_aov = [torch.zeros_like(cr) for _ in range(n_aov)]
    wsum = torch.zeros_like(cr)
    lum_c = 0.2126 * cr + 0.7152 * cg + 0.0722 * cb
    if use_var:
        # SVGF: the luminance edge-stop scales by the local noise level,
        # from the variance prefiltered by a 3x3 binomial
        pvar = pads[-1]
        gvar = torch.zeros_like(cr)
        for gy, ky in ((-1, 0.25), (0, 0.5), (1, 0.25)):
            for gx, kx in ((-1, 0.25), (0, 0.5), (1, 0.25)):
                gvar = gvar + ky * kx * pvar[halo + gy:halo + gy + h, halo + gx:halo + gx + w]
        inv_sl = 1.0 / (sigma_variance * torch.sqrt(torch.clamp(gvar, min=0.0)) + 1e-6)
        acc_var = torch.zeros_like(cr)
    for iy in range(-2, 3):
        for ix in range(-2, 3):
            k = float(_B3[iy + 2] * _B3[ix + 2])
            y0 = halo + iy * step
            x0 = halo + ix * step

            def sh(j):
                return pads[j, y0:y0 + h, x0:x0 + w]

            scr, scg, scb = sh(0), sh(1), sh(2)
            dl = 0.2126 * scr + 0.7152 * scg + 0.0722 * scb - lum_c
            if use_var:
                wt = k * torch.exp(-torch.abs(dl) * inv_sl)
            else:
                wt = k * torch.exp(-(dl * dl) * inv_2sc)
            if use_albedo:
                da = (sh(3) - ar) ** 2 + (sh(4) - ag) ** 2 + (sh(5) - ab_) ** 2
                wt = wt * torch.exp(-da * inv_2sa)
            if use_normal:
                ndot = torch.clamp(sh(6) * nr + sh(7) * ng + sh(8) * nb, 0.0, 1.0)
                wt = wt * npow(ndot)
            acc_r = acc_r + scr * wt
            acc_g = acc_g + scg * wt
            acc_b = acc_b + scb * wt
            for j in range(n_aov):
                acc_aov[j] = acc_aov[j] + sh(9 + j) * wt
            wsum = wsum + wt
            if use_var:
                acc_var = acc_var + pvar[y0:y0 + h, x0:x0 + w] * (wt * wt)
    inv_w = 1.0 / torch.clamp(wsum, min=1e-8)
    out = torch.stack([acc_r * inv_w, acc_g * inv_w, acc_b * inv_w])
    aovs_out = torch.stack([a * inv_w for a in acc_aov]) if n_aov else None
    # Var[sum w x / sum w] = sum w^2 var / (sum w)^2
    var_out = acc_var * inv_w * inv_w if use_var else None
    return out, aovs_out, var_out


def atrous_iter_plain(color, albedo, normal, step: int, use_albedo: bool = True,
                      use_normal: bool = True, sigma_color: float = 0.35,
                      sigma_albedo: float = 0.15, sigma_normal: float = 0.25):
    """Plain version of K9: ``atrous_step`` without variance or AOVs."""
    return atrous_step(color, albedo, normal, step, use_albedo, use_normal,
                       sigma_color, sigma_albedo, sigma_normal)[0]


def atrous_iter(color, albedo, normal, step: int, use_albedo: bool = True,
                use_normal: bool = True, sigma_color: float = 0.35,
                sigma_albedo: float = 0.15, sigma_normal: float = 0.25):
    """One a-trous iteration at ``step`` on (3, h, w) float32 planes;
    returns new (3, h, w) colour planes."""
    if color.device.type == "cpu":
        return atrous_iter_plain(color, albedo, normal, step, use_albedo, use_normal,
                                 sigma_color, sigma_albedo, sigma_normal)
    for label, t in (("color", color), ("albedo", albedo), ("normal", normal)):
        if (t.device != color.device or t.dtype != torch.float32 or t.dim() != 3
                or t.shape != color.shape or t.shape[0] != 3 or not t.is_contiguous()):
            raise ValueError(f"atrous_iter: {label} must be a contiguous (3, h, w) float32 "
                             f"tensor on {color.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if step < 1:
        raise ValueError(f"atrous_iter: step {step} must be at least 1")
    _, h, w = color.shape
    n_pow, npow_int = normal_power(sigma_normal)
    out = torch.empty_like(color)
    fn = kernels.launcher("atrous_iter")
    kernels.LAUNCHES["atrous_iter"] += 1
    rc = fn(color.data_ptr(), albedo.data_ptr(), normal.data_ptr(), out.data_ptr(), h, w,
            step, int(use_albedo), int(use_normal), 1.0 / (2.0 * sigma_color**2),
            1.0 / (2.0 * sigma_albedo**2), npow_int, n_pow,
            kernels.stream_ptr(color.device))
    kernels.check(rc, "atrous_iter")
    return out


def planes_of(img: torch.Tensor) -> torch.Tensor:
    """(h, w, 3) -> contiguous (3, h, w) float32 planes."""
    return img.permute(2, 0, 1).to(torch.float32).contiguous()


def atrous_denoise_cuda(color, albedo, normal, iterations: int = 5,
                        use_albedo: bool = True, use_normal: bool = True,
                        sigma_color: float = 0.35, sigma_albedo: float = 0.15,
                        sigma_normal: float = 0.25):
    """The a-trous filter through K9, (h, w, 3) in and out: one launch per
    iteration at step 2^i (the counterpart of atrous_denoise_pallas)."""
    planes = planes_of(color)
    a, n = planes_of(albedo), planes_of(normal)
    for it in range(iterations):
        planes = atrous_iter(planes, a, n, 1 << it, use_albedo, use_normal,
                             sigma_color, sigma_albedo, sigma_normal)
    return planes.permute(1, 2, 0).contiguous()
