"""Squeeze-and-Excitation channel gating (NCHW).

Counterpart of ``betavae_tpu/models/se.py``: mean over H and W →
Linear(C → max(1, C//r)) → ReLU → Linear(→ C) → sigmoid → channelwise
scale.  Parameters sit at ``block.fc.0`` and ``block.fc.2``, the reference
torch model's names, so its state dicts load unchanged.
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.fc(x.mean(dim=(2, 3)))
        return x * gate[:, :, None, None]


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.block = _Excite(channels, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)
