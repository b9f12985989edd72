"""One training step: gather → augment → encode → fused reparam+KL → decode
→ loss → backward → clip → update; and one validation batch.

Counterpart of the step body in ``betavae_tpu/train/loop.py``
(``_build_step_fn``, ``_forward_with_loss``, ``_scalar_metrics``,
``make_eval_multi_step``).  Where the JAX step is one jitted program over
immutable state, this one updates the model and optimizer in place and
returns the step's scalar metrics as device tensors, so nothing waits for
the card until a caller reads them.

Every random draw of step ``n`` is a function of ``(seed, n)``, as the
JAX step's key ``fold_in(root_key, n)`` is: the noise is the kernel's
Philox stream at ``(seed, n)`` and the augmentation's generator is seeded
from ``(seed, n)`` at the start of the step, so a resumed run replays the
uninterrupted one.
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


def augment_seed(seed: int, step_index: int) -> int:
    """The augmentation generator's seed for step ``step_index``: a
    63-bit mix of the pair, as ``BatchPlan`` mixes (seed, epoch)."""
    return (int(seed) * 1_000_003 + int(step_index)) & (2**63 - 1)


def _forward_losses(model, x, mask, sched: dict, *, spec: LossSpec,
                    use_capacity: bool, seed: int, offset: int,
                    lpips_fn=None) -> dict:
    mu, logvar = model.encode(x)
    if spec.deterministic:
        z, kl_elem = reparameterize_and_kl(mu, logvar, deterministic=True)
    else:
        z, kl_elem = fused_reparam_kl(mu, logvar, seed, offset)
    recon = model.decode(z)
    return compute_loss(
        (recon, mu, logvar, z, kl_elem), x, spec=spec, beta=sched["beta"],
        capacity=sched["capacity"] if use_capacity else None,
        capacity_weight=sched["capacity_weight"] if use_capacity else None,
        free_bits=sched["free_bits"], mask=mask, lpips_fn=lpips_fn)


def make_train_step(model: BetaVAEModule, optimizer: OptimizerChain,
                    spec: LossSpec, *, aug_kwargs: dict, use_capacity: bool,
                    seed: int, lpips_fn=None):
    """Build ``step(images, idx, mask, sched, step_index) -> metrics``.

    ``images`` is the device-resident uint8 split, ``idx`` (B,) int64 and
    ``mask`` (B,) float tensors on the same device, ``sched`` the floats
    ``{beta, capacity, capacity_weight, free_bits, lr}``.  The noise of step
    ``step_index`` is the kernel's Philox stream at ``(seed, step_index)``;
    its augmentation draws from a generator seeded from the same pair.
    ``lpips_fn`` is the perceptual distance the loss adds when the spec
    turns LPIPS on (:func:`..ops.lpips.build_lpips_fn`).
    """
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)

    def step(images, idx, mask, sched: dict, step_index: int) -> dict:
        model.train()
        generator.manual_seed(augment_seed(seed, step_index))
        x = augment_batch(gather_batch(images, idx), generator, **aug_kwargs)
        optimizer.zero_grad()
        losses = _forward_losses(model, x, mask, sched, spec=spec,
                                 use_capacity=use_capacity, seed=seed,
                                 offset=step_index, lpips_fn=lpips_fn)
        losses["total"].backward()
        optimizer.step(sched["lr"])
        return scalar_metrics(losses, mask)

    return step


def make_eval_step(model: BetaVAEModule, spec: LossSpec, *,
                   use_capacity: bool, seed: int, lpips_fn=None):
    """Build ``eval_step(images, idx, mask, sched, offset) -> (metrics,
    mu)``: one stochastic validation batch in eval mode without autograd,
    its noise the kernel's Philox stream at ``(seed, offset)``."""

    @torch.no_grad()
    def eval_step(images, idx, mask, sched: dict, offset: int):
        model.eval()
        losses = _forward_losses(model, gather_batch(images, idx), mask,
                                 sched, spec=spec, use_capacity=use_capacity,
                                 seed=seed, offset=offset, lpips_fn=lpips_fn)
        return scalar_metrics(losses, mask), losses["mu"]

    return eval_step
