"""Squeeze-and-Excitation channel gating (NCHW).

Counterpart of ``betavae_tpu/models/se.py``: mean over H and W →
Linear(C → max(1, C//r)) → ReLU → Linear(→ C) → sigmoid → channelwise
scale.  Parameters sit at ``block.fc.0`` and ``block.fc.2``, the reference
torch model's names, so its state dicts load unchanged.  With
``return_gate`` the block returns the ungated activations and the gates
``[B, C]``, for a caller that folds the gate into its next op
(``ops/head.py``).  A block whose GN kernels already computed the squeeze
(``ops/gn.py::fused_gn_relu_pool``: the mean of ``x``, summed in fp32)
passes it as ``pooled``, and the mean is not taken again.
"""

from __future__ import annotations

import torch
from torch import nn


class _Excite(nn.Module):
    def __init__(self, channels: int, reduction: int):
        super().__init__()
        r = max(1, channels // reduction)
        self.fc = nn.Sequential(nn.Linear(channels, r), nn.ReLU(),
                                nn.Linear(r, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor, return_gate: bool = False,
                pooled: torch.Tensor | None = None):
        gate = self.fc(x.mean(dim=(2, 3)) if pooled is None else pooled)
        if return_gate:
            return x, gate
        return x * gate[:, :, None, None]


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.block = _Excite(channels, reduction)

    def forward(self, x: torch.Tensor, return_gate: bool = False,
                pooled: torch.Tensor | None = None):
        return self.block(x, return_gate, pooled)
