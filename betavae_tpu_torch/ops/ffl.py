"""Focal Frequency Loss, fp32, over NCHW.

Counterpart of ``betavae_tpu/ops/ffl.py::focal_frequency_loss``, whose
matmul DFT is a TPU lowering of ``fft2``: the ortho 2-D FFT of
``pred − target`` (the DFT is linear, so one transform of the difference),
squared spectral distance, focal weight ``(dist / mean)^alpha`` with the
per-channel mean over batch and space, clamped at ``eps``, then the mean.
Both means are over the global batch: with a data-parallel ``group`` they
are sums over the group (:func:`..parallel.reduce.global_sum`) divided by
the global count, padded rows included, as the JAX package takes them.
"""

from __future__ import annotations

import torch

from ..parallel.reduce import global_sum, world_size


def focal_frequency_loss(pred: torch.Tensor, target: torch.Tensor,
                         alpha: float = 1.0, eps: float = 1e-8,
                         group=None) -> torch.Tensor:
    if pred.shape != target.shape:
        raise ValueError(f"Shape mismatch: pred {tuple(pred.shape)} vs "
                         f"target {tuple(target.shape)}")
    with torch.autocast(pred.device.type, enabled=False):
        diff = pred.float() - target.float()
        spec = torch.fft.fft2(diff, norm="ortho")
        dist = spec.real ** 2 + spec.imag ** 2
        b, c, h, w = dist.shape
        n = b * world_size(group)
        denom = global_sum(dist.sum(dim=(0, 2, 3), keepdim=True),
                           group) / (n * h * w) + eps
        weight = torch.clamp(dist / denom, min=eps) ** alpha
        return global_sum((weight * dist).sum(), group) / (n * c * h * w)
