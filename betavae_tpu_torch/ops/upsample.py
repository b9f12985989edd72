"""Bilinear ×2 upsampling with half-pixel centres (``align_corners=False``).

Counterpart of ``betavae_tpu/ops/upsample.py``, whose separable dilated
depthwise convolutions are a TPU lowering of exactly this function, edges
included (the edge taps clamp to the border pixel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def bilinear_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), in ``x``'s dtype.  Autocast would
    upcast a bf16 input to fp32; the JAX decoder upsamples in its compute
    dtype, so autocast is off here."""
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilinear_upsample_x2(x)
