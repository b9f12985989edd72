"""One training step: gather → augment → encode → fused reparam+KL → decode
→ loss → backward → clip → update.

Counterpart of the step body in ``betavae_tpu/train/loop.py``
(``_build_step_fn``, ``_forward_with_loss``, ``_scalar_metrics``).  Where
the JAX step is one jitted program over immutable state, this one updates
the model and optimizer in place and returns the step's scalar metrics as
device tensors, so nothing waits for the card until a caller reads them.
"""

from __future__ import annotations

import torch

from ..data.augment import augment_batch
from ..data.pipeline import gather_batch
from ..models.beta_vae import BetaVAEModule
from ..models.losses import LossSpec, compute_loss
from ..ops.elbo import fused_reparam_kl
from ..ops.reparam import reparameterize_and_kl
from .optim import OptimizerChain


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    msum = torch.clamp_min(mask.sum(), 1.0)
    return (x.mean(dim=tuple(range(1, x.ndim))) * mask).sum() / msum


def masked_std(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unbiased std over the masked rows (``Tensor.std()`` semantics)."""
    d = x.shape[1] if x.ndim > 1 else 1
    n = torch.clamp_min(mask.sum() * d, 2.0)
    m = mask[:, None] if x.ndim > 1 else mask
    mean = (x * m).sum() / n
    return torch.sqrt((((x - mean) ** 2) * m).sum() / (n - 1.0))


def scalar_metrics(losses: dict, mask: torch.Tensor) -> dict:
    return {
        "total": losses["total"].detach(),
        "recon": losses["recon"].detach(),
        "recon_base": losses["recon_base"].detach(),
        "recon_lpips": losses["recon_lpips"].detach(),
        "recon_ffl": losses["recon_ffl"].detach(),
        "kl_mean": losses["kl_mean"].detach(),
        "kl_effective": losses["kl_effective"].detach(),
        "kl_per_dim_mean": losses["kl_per_dim"].detach().mean(),
        "mu_mean_batch": masked_mean(losses["mu"].detach(), mask),
        "z_std_batch": masked_std(losses["z"].detach(), mask),
    }


def make_train_step(model: BetaVAEModule, optimizer: OptimizerChain,
                    spec: LossSpec, *, aug_kwargs: dict, use_capacity: bool,
                    seed: int):
    """Build ``step(images, idx, mask, sched, step_index) -> metrics``.

    ``images`` is the device-resident uint8 split, ``idx`` (B,) int64 and
    ``mask`` (B,) float tensors on the same device, ``sched`` the floats
    ``{beta, capacity, capacity_weight, free_bits, lr}``.  The noise of step
    ``step_index`` is the kernel's Philox stream at ``(seed, step_index)``;
    augmentation draws from a generator seeded with ``seed``.
    """
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))

    def step(images, idx, mask, sched: dict, step_index: int) -> dict:
        model.train()
        x = augment_batch(gather_batch(images, idx), generator, **aug_kwargs)
        optimizer.zero_grad()
        mu, logvar = model.encode(x)
        if spec.deterministic:
            z, kl_elem = reparameterize_and_kl(mu, logvar, deterministic=True)
        else:
            z, kl_elem = fused_reparam_kl(mu, logvar, seed, step_index)
        recon = model.decode(z)
        losses = compute_loss(
            (recon, mu, logvar, z, kl_elem), x, spec=spec, beta=sched["beta"],
            capacity=sched["capacity"] if use_capacity else None,
            capacity_weight=sched["capacity_weight"] if use_capacity else None,
            free_bits=sched["free_bits"], mask=mask)
        losses["total"].backward()
        optimizer.step(sched["lr"])
        return scalar_metrics(losses, mask)

    return step
