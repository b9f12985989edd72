"""The β-VAE training objective — one function returning the 16-key dict.

Counterpart of ``betavae_tpu/models/losses.py``: per-sample summed
mse/bce/l1 reconstruction averaged over the batch ``mask`` (images and
reconstructions compared in [0, 1], or in the range the model computes in,
``LossSpec.image_range``: [−1, 1] for ``autoencoder_kl``), the optional
FFL extra, elementwise KL with ``kl_per_dim`` and ``kl_mean``, β mode with
per-dim free bits, capacity mode ``rec + γ·|kl_mean − C|``, the optional
``λ·mean(mu²)`` latent regulariser, the optional LPIPS extra (through the
``lpips_fn`` the trainer builds, :func:`..ops.lpips.build_lpips_fn`), and
the deterministic mode that zeroes the KL path.  Every reduction is fp32.

Every batch reduction is over the global batch: with a data-parallel
``group`` each is a local sum passed through :func:`..parallel.reduce.
global_sum` before any nonlinearity (the capacity term's ``|·|``, the free
bits' clamp, the divisions), as the JAX package's mesh reduces over the
sharded batch; with ``group=None`` the sums are the rank's own.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import get, get_config
from ..ops.ffl import focal_frequency_loss
from ..parallel.reduce import global_sum


@dataclass(frozen=True)
class LossSpec:
    """Static loss configuration."""

    recon_loss_type: str = "mse"          # mse | bce | l1
    deterministic: bool = False
    latent_reg_lambda: float = 0.0
    use_ffl: bool = False
    ffl_weight: float = 0.0
    ffl_alpha: float = 1.0
    use_lpips: bool = False
    lpips_weight: float = 0.0
    free_bits_enabled: bool = False
    # the range images and reconstructions (in [0, 1]) are mapped to before
    # the reconstruction term compares them
    image_range: tuple = (0.0, 1.0)


def loss_spec_from_config(cfg=None) -> LossSpec:
    cfg = cfg or get_config()
    lcfg = get(cfg, "loss", None)
    mcfg = cfg.model
    free_bits = float(get(lcfg, "free_bits", 0.0) or 0.0)
    image_range = (0.0, 1.0)
    if get(mcfg, "architecture", "beta_vae") == "autoencoder_kl":
        from .autoencoder_kl import IMAGE_RANGE as image_range
    return LossSpec(
        recon_loss_type=str(mcfg.reconstruction_loss),
        deterministic=bool(get(mcfg, "deterministic_overfit", False)),
        latent_reg_lambda=float(get(mcfg, "latent_reg_lambda", 0.0) or 0.0),
        use_ffl=bool(get(lcfg, "use_ffl", False)),
        ffl_weight=float(get(lcfg, "ffl_weight", 0.0) or 0.0),
        ffl_alpha=float(get(lcfg, "ffl_alpha", 1.0)),
        use_lpips=bool(get(lcfg, "use_lpips", False)),
        lpips_weight=float(get(lcfg, "lpips_weight", 0.0) or 0.0),
        free_bits_enabled=free_bits > 0.0,
        image_range=tuple(image_range),
    )


def _per_sample_recon(recon, x, kind: str,
                      image_range: tuple = (0.0, 1.0)) -> torch.Tensor:
    """Sum over pixels per sample (fp32), ``recon`` and ``x`` mapped from
    [0, 1] to ``image_range`` first."""
    r = recon.float()
    t = x.float()
    lo, hi = image_range
    if (lo, hi) != (0.0, 1.0):
        if kind == "bce":
            raise ValueError(f"bce compares images in [0, 1], not in "
                             f"{image_range}")
        r = r * (hi - lo) + lo
        t = t * (hi - lo) + lo
    dims = tuple(range(1, x.ndim))
    if kind == "mse":
        return ((r - t) ** 2).sum(dim=dims)
    if kind == "bce":
        r = r.clamp(1e-12, 1.0 - 1e-12)
        return (-(t * torch.log(r) + (1.0 - t) * torch.log(1.0 - r))).sum(dim=dims)
    if kind == "l1":
        return (r - t).abs().sum(dim=dims)
    raise ValueError("invalid reconstruction_loss")


def _scalar(value, dev) -> torch.Tensor:
    """A 0-d fp32 tensor of ``value``, a float or (a schedule read on the
    card) a 0-d tensor, without a host sync."""
    if isinstance(value, torch.Tensor):
        return value.detach().float().reshape(())
    return torch.full((), float(value), device=dev)


def compute_loss(outputs, x: torch.Tensor, *, spec: LossSpec, beta,
                 capacity=None, capacity_weight=None, free_bits=0.0,
                 mask: Optional[torch.Tensor] = None,
                 lpips_fn: Optional[Callable] = None, group=None) -> dict:
    """``outputs`` is ``(recon, mu, logvar, z, kl_elem)``; ``capacity`` and
    ``capacity_weight`` both set select capacity mode.  ``beta``,
    ``capacity``, ``capacity_weight`` and ``free_bits`` are floats or 0-d
    fp32 tensors (one schedule row of a captured step), with bitwise the
    same result: every one enters an fp32 operation.  ``lpips_fn(recon,
    x, group=group)`` adds ``lpips_weight`` times the perceptual distance
    to the reconstruction term when ``use_lpips`` is on and weighted, as in
    the JAX package.  ``group`` is the data-parallel process group of which
    ``x`` is this rank's rows, or None."""
    recon, mu, logvar, z, kl_elem = outputs
    dev = x.device
    if mask is None:
        mask = torch.ones(x.shape[0], device=dev)
    mask = mask.float()
    msum = torch.clamp_min(global_sum(mask.sum(), group), 1.0)
    zero = torch.zeros((), device=dev)

    base_recon = global_sum((_per_sample_recon(recon, x, spec.recon_loss_type,
                                               spec.image_range)
                             * mask).sum(), group) / msum
    lp = zero
    ff = zero
    if spec.use_lpips and spec.lpips_weight > 0 and lpips_fn is not None:
        lp = lpips_fn(recon, x, group=group) * spec.lpips_weight
    if spec.use_ffl and spec.ffl_weight > 0:
        ff = focal_frequency_loss(recon, x, alpha=spec.ffl_alpha,
                                  group=group) * spec.ffl_weight
    rec_loss = base_recon + lp + ff

    use_capacity = capacity is not None and capacity_weight is not None
    if spec.deterministic:
        kl_per_dim = torch.zeros(mu.shape[1], device=dev)
        kl_mean = zero
        kl_effective = zero
    else:
        kl32 = kl_elem.float()
        kl_per_dim = global_sum((kl32 * mask[:, None]).sum(dim=0),
                                group) / msum
        kl_mean = global_sum((kl32.sum(dim=1) * mask).sum(), group) / msum
        if spec.free_bits_enabled and not use_capacity:
            kl_effective = torch.clamp(kl_per_dim, min=free_bits).sum()
        else:
            kl_effective = kl_per_dim.sum()

    latent_reg = zero
    if spec.latent_reg_lambda > 0:
        mu_sq_mean = global_sum(((mu.float() ** 2).mean(dim=1) * mask).sum(),
                                group) / msum
        latent_reg = spec.latent_reg_lambda * mu_sq_mean

    if spec.deterministic:
        total = rec_loss + latent_reg
    elif use_capacity:
        total = rec_loss + capacity_weight * (kl_mean - capacity).abs() + latent_reg
    else:
        total = rec_loss + beta * kl_effective + latent_reg

    return {
        "total": total,
        "recon": rec_loss,
        "recon_base": base_recon,
        "recon_lpips": lp,
        "recon_ffl": ff,
        "kl_mean": kl_mean,
        "kl_per_dim": kl_per_dim,
        "beta": _scalar(beta, dev),
        "capacity": _scalar(math.nan if capacity is None else capacity, dev),
        "latent_reg": latent_reg,
        "recon_img": recon,
        "z": z,
        "mu": mu,
        "logvar": logvar,
        "kl_effective": kl_effective,
        "mode": "capacity" if use_capacity else "beta",
    }
