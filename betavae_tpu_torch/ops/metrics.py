"""Reconstruction metrics: MSE, PSNR and SSIM per image, batched, NCHW.

The port's own copy of ``betavae_tpu/ops/metrics.py``, with the reference's
deliberately nonstandard details kept for evaluation parity:

- ``psnr``: the maximum signal is 1.0, and zero MSE gives 99.0,
- ``ssim``: an 11×11 Gaussian window with σ 1.5 as a depthwise convolution
  with zero SAME padding, the dynamic range ``L = max − min`` of the *first*
  argument per image, floored at 1.0 where it is not positive, variances
  clamped at 0 and a 1e-12 guard on the denominator.

Everything is computed in fp32 on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def _psnr_of(m: torch.Tensor) -> torch.Tensor:
    val = -10.0 * torch.log10(torch.clamp_min(m, 1e-30))
    return torch.where(m == 0, torch.full_like(val, 99.0), val)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _psnr_of(mse(a, b))


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    k2d = np.outer(g, g)
    return (k2d / k2d.sum()).astype(np.float32)


def batched_ssim(x: torch.Tensor, y: torch.Tensor, window_size: int = 11,
                 sigma: float = 1.5) -> torch.Tensor:
    """Per-image SSIM of ``x, y`` ``[B, C, H, W]``: ``[B]``."""
    x, y = x.float(), y.float()
    c = x.shape[1]
    window = torch.from_numpy(_gaussian_window(window_size, sigma)).to(x.device)
    kernel = window[None, None].expand(c, 1, window_size, window_size)

    def blur(t):
        return F.conv2d(t, kernel, padding=window_size // 2, groups=c)

    L = x.amax(dim=(1, 2, 3)) - x.amin(dim=(1, 2, 3))
    L = torch.where(L <= 0, torch.ones_like(L), L)[:, None, None, None]
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    mu_x, mu_y = blur(x), blur(y)
    mu_x_sq, mu_y_sq, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x_sq = torch.clamp_min(blur(x * x) - mu_x_sq, 0.0)
    sigma_y_sq = torch.clamp_min(blur(y * y) - mu_y_sq, 0.0)
    sigma_xy = blur(x * y) - mu_xy
    denom = (mu_x_sq + mu_y_sq + c1) * (sigma_x_sq + sigma_y_sq + c2)
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    return torch.mean(num / (denom + 1e-12), dim=(1, 2, 3))


def ssim(x: torch.Tensor, y: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """SSIM of one image pair ``[C, H, W]``."""
    return batched_ssim(x[None], y[None], window_size, sigma)[0]


def batched_image_metrics(recon: torch.Tensor, x: torch.Tensor) -> dict:
    """``{"mse", "psnr", "ssim"}``, each ``[B]``, of ``recon`` against ``x``
    (``[B, C, H, W]``).  The argument order is the reference's per-image
    ``mse(ri, xi)``, ``psnr(ri, xi)``, ``ssim(ri, xi)``: SSIM's dynamic
    range comes from the reconstruction."""
    r, t = recon.float(), x.float()
    per_img_mse = torch.mean((r - t) ** 2, dim=(1, 2, 3))
    return {"mse": per_img_mse, "psnr": _psnr_of(per_img_mse),
            "ssim": batched_ssim(r, t)}
