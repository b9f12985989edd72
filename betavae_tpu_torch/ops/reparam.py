"""Reparameterisation sample + elementwise KL, in plain PyTorch.

Counterpart of ``betavae_tpu/ops/reparam.py``.  KL is always fp32 whatever
the compute policy:

    z       = mu + eps · exp(½·logvar)
    kl_elem = −½ · (1 + logvar − mu² − exp(logvar))

The training step takes the fused CUDA kernel (:mod:`.elbo`) on the GPU;
this function is the deterministic path and the oracle the kernel's plain
version is built from.
"""

from __future__ import annotations

import torch


def reparameterize_and_kl(mu: torch.Tensor, logvar: torch.Tensor,
                          eps: torch.Tensor | None = None,
                          generator: torch.Generator | None = None,
                          deterministic: bool = False):
    """Returns ``(z, kl_elem)``, both fp32.  ``eps`` defaults to a
    ``torch.randn`` draw from ``generator``; ``deterministic`` gives
    ``z = mu``."""
    mu32 = mu.float()
    logvar32 = logvar.float()
    kl_elem = -0.5 * (1.0 + logvar32 - mu32 * mu32 - torch.exp(logvar32))
    if deterministic:
        return mu32, kl_elem
    if eps is None:
        eps = torch.randn(mu32.shape, generator=generator,
                          device=mu32.device, dtype=torch.float32)
    return mu32 + eps * torch.exp(0.5 * logvar32), kl_elem
