"""Conv β-VAE with SE blocks — the flagship model, as NCHW ``nn.Module``s.

Counterpart of ``betavae_tpu/models/beta_vae.py`` (``BetaVAEModule``,
``model_from_config``):

- encoder: ``num_blocks`` × [3×3 stride-2 conv → norm → act → SE] with widths
  ``base·2^i``; ``flatten`` or ``gap`` pooling; fp32 ``fc_mu``/``fc_logvar``
  and the logvar clamp (from config, else ±10),
- decoder: ``fc_dec`` (broadcast over the bottleneck grid under ``gap``),
  then mirrored [bilinear ×2 → 3×3 conv → norm → act → optional SE] blocks,
  a final 3×3 conv and a fp32 sigmoid; optional latent clamp before decode,
- ``fused_head``: the last decoder block's SE gate folded into the final
  C→1 conv through the hand-written head kernels (``ops/head.py``), as the
  JAX ``FinalConvHead`` does with its Pallas kernel; ``final_conv`` keeps
  its parameters and names either way,
- norms: ``layer`` → GroupNorm(1) with flax's eps 1e-6, ``batch`` →
  BatchNorm with flax's update rule (momentum 0.99 is torch 0.01, running
  variance from the biased batch variance), ``none``,
- module names are the reference torch model's (``encoder.{i}.conv|norm|
  se.block.fc.{0,2}``, ``decoder_blocks.{i}.up.1``, ``fc_mu``, ``fc_logvar``,
  ``fc_dec``, ``final_conv``), so :func:`..io.weights.params_from_jax`
  output loads with ``strict=True``.

Mixed precision is ``torch.autocast`` to bf16 over the convolutions, norms,
SE and ``fc_dec``, with fp32 params, heads and sigmoid input.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import get, get_config
from ..device import resolve_device
from ..ops.head import fused_se_conv_head
from ..ops.reparam import reparameterize_and_kl
from ..ops.upsample import Upsample2x
from .se import SEBlock


def _activation(name: str) -> nn.Module:
    if name == "relu":
        return nn.ReLU()
    if name == "leakyrelu":
        return nn.LeakyReLU(0.2)
    if name == "elu":
        return nn.ELU()
    raise ValueError("unsupported activation")


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running-statistics rule: the running variance
    is updated from the *biased* batch variance (torch uses the unbiased
    one).  Normalisation and parameter names are torch's."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = x32.var(dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


def _norm(norm_type: str, channels: int) -> nn.Module:
    if norm_type == "batch":
        return FlaxBatchNorm2d(channels)
    if norm_type == "layer":
        return nn.GroupNorm(1, channels, eps=1e-6)
    if norm_type == "none":
        return nn.Identity()
    raise ValueError("unsupported norm")


def _normed(norm: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """``norm(y)`` in ``y``'s dtype.  Autocast computes GroupNorm in fp32
    and returns fp32; flax's ``GroupNorm(dtype=bf16)`` keeps fp32 statistics
    but returns bf16, so the activations between blocks stay bf16."""
    return norm(y).to(y.dtype)


class ConvBlock(nn.Module):
    """3×3 stride-2 conv → norm → act → SE (encoder block)."""

    def __init__(self, in_ch: int, out_ch: int, norm_type: str,
                 activation: str, se_reduction: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, stride=2, padding=1)
        self.norm = _norm(norm_type, out_ch)
        self.act = _activation(activation)
        self.se = SEBlock(out_ch, se_reduction)

    def forward(self, x):
        return self.se(self.act(_normed(self.norm, self.conv(x))))


class DeconvBlock(nn.Module):
    """bilinear ×2 → 3×3 conv → norm → act → optional SE (decoder block)."""

    def __init__(self, in_ch: int, out_ch: int, norm_type: str,
                 activation: str, use_se: bool, se_reduction: int):
        super().__init__()
        self.up = nn.Sequential(Upsample2x(),
                                nn.Conv2d(in_ch, out_ch, 3, padding=1))
        self.norm = _norm(norm_type, out_ch)
        self.act = _activation(activation)
        self.se = SEBlock(out_ch, se_reduction) if use_se else nn.Identity()

    def forward(self, x, return_gate: bool = False):
        """With ``return_gate``: ``(ungated activations, SE gates)``, the
        gates ``None`` when the block has no SE."""
        h = self.act(_normed(self.norm, self.up(x)))
        if not return_gate:
            return self.se(h)
        if isinstance(self.se, SEBlock):
            return self.se(h, return_gate=True)
        return h, None


class BetaVAEModule(nn.Module):
    """Inputs and outputs NCHW float in [0, 1]."""

    def __init__(self, image_size: int, in_channels: int, latent_dim: int,
                 base_channels: int, num_blocks: int, activation: str = "relu",
                 norm_type: str = "layer", se_reduction: int = 16,
                 use_decoder_se: bool = True, encoder_pooling: str = "flatten",
                 logvar_clamp: Optional[Sequence[float]] = None,
                 latent_clamp: Optional[float] = None,
                 mixed_precision: bool = False, fused_head: bool = False):
        super().__init__()
        if encoder_pooling not in ("flatten", "gap"):
            raise ValueError("encoder_pooling must be flatten or gap")
        self.image_size = image_size
        self.in_channels = in_channels
        self.latent_dim = latent_dim
        self.base_channels = base_channels
        self.num_blocks = num_blocks
        self.encoder_pooling = encoder_pooling
        self.logvar_clamp = (tuple(float(v) for v in logvar_clamp)
                             if logvar_clamp else (-10.0, 10.0))
        self.latent_clamp = latent_clamp
        self.mixed_precision = mixed_precision
        self.fused_head = fused_head

        chs = self.channel_widths
        self.encoder = nn.ModuleList(
            ConvBlock(in_channels if i == 0 else chs[i - 1], chs[i],
                      norm_type, activation, se_reduction)
            for i in range(num_blocks))
        self.fc_mu = nn.Linear(self.flat_dim, latent_dim)
        self.fc_logvar = nn.Linear(self.flat_dim, latent_dim)
        self.fc_dec = nn.Linear(latent_dim, self.flat_dim)
        dec_chs = list(reversed(chs))
        self.decoder_blocks = nn.ModuleList(
            DeconvBlock(dec_chs[i],
                        dec_chs[i + 1] if i + 1 < len(dec_chs) else dec_chs[-1],
                        norm_type, activation, use_decoder_se, se_reduction)
            for i in range(num_blocks))
        self.final_conv = nn.Conv2d(dec_chs[-1], in_channels, 3, padding=1)

    @property
    def channel_widths(self) -> list:
        return [self.base_channels * (2**i) for i in range(self.num_blocks)]

    @property
    def bottleneck_hw(self) -> int:
        s = self.image_size
        for _ in range(self.num_blocks):
            s = (s + 1) // 2  # stride-2 conv with padding 1: ceil(s/2)
        return s

    @property
    def flat_dim(self) -> int:
        c = self.channel_widths[-1]
        return c if self.encoder_pooling == "gap" else c * self.bottleneck_hw**2

    def _autocast(self, device: torch.device):
        if not self.mixed_precision:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

    def encode(self, x: torch.Tensor):
        with self._autocast(x.device):
            h = x
            for blk in self.encoder:
                h = blk(h)
            h = h.mean(dim=(2, 3)) if self.encoder_pooling == "gap" \
                else h.reshape(h.shape[0], -1)
        with torch.autocast(x.device.type, enabled=False):
            h = h.float()
            mu = self.fc_mu(h)
            logvar = self.fc_logvar(h).clamp(*self.logvar_clamp)
        return mu, logvar

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.latent_clamp is not None:
            z = z.clamp(-self.latent_clamp, self.latent_clamp)
        s, c = self.bottleneck_hw, self.channel_widths[-1]
        with self._autocast(z.device):
            h = self.fc_dec(z)
            if self.encoder_pooling == "gap":
                h = h[:, :, None, None].expand(h.shape[0], c, s, s)
            else:
                h = h.reshape(h.shape[0], c, s, s)
            for blk in self.decoder_blocks[:-1]:
                h = blk(h)
            last = self.decoder_blocks[-1]
            if self.fused_head and self.in_channels == 1:
                h, gate = last(h, return_gate=True)
                if gate is None:
                    gate = torch.ones(h.shape[:2], dtype=h.dtype,
                                      device=h.device)
                x = fused_se_conv_head(h, gate, self.final_conv.weight[0])
                x = x[:, None] + self.final_conv.bias
            else:
                x = self.final_conv(last(h))
        return torch.sigmoid(x.float())

    def forward(self, x: torch.Tensor, deterministic: bool = False,
                generator: torch.Generator | None = None):
        """``(recon, mu, logvar, z)``; ``z = mu`` when ``deterministic``,
        else a ``torch.randn`` draw from ``generator``."""
        mu, logvar = self.encode(x)
        z, _ = reparameterize_and_kl(mu, logvar, generator=generator,
                                     deterministic=deterministic)
        return self.decode(z), mu, logvar, z


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal fan-in weights and zero biases for every conv and
    linear layer: the JAX package's ``variance_scaling(2, fan_in, normal)``
    init, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
            nn.init.zeros_(m.bias)


def _check_unported_options(tcfg) -> None:
    remat = get(tcfg, "remat", False)
    if remat not in (False, None, "none", "false"):
        raise NotImplementedError(
            f"training.remat={remat!r} is not ported yet")


def resolve_fused_head(value) -> bool:
    """``training.fused_head``: true/false/None as in the JAX package's
    ``_resolve_fused_head``; ``auto`` (the default) is off, since the port
    has no environment switch for it."""
    if value in (True, "true"):
        return True
    if value in (False, "false", None, "none", "auto"):
        return False
    raise ValueError(f"training.fused_head must be auto/true/false, "
                     f"got {value!r}")


def model_from_config(cfg=None, mixed_precision: bool | None = None,
                      device: str | torch.device = "cuda") -> BetaVAEModule:
    """The flagship model from the config, initialised from ``data.seed``
    (on the CPU, so a seed gives the same weights on every device) and
    moved to ``device``."""
    dev = resolve_device(device)
    cfg = cfg or get_config()
    mcfg, dcfg = cfg.model, cfg.data
    _check_unported_options(cfg.training)
    if mixed_precision is None:
        mixed_precision = bool(get(cfg.training, "mixed_precision", False))
    logvar_clamp = get(mcfg, "logvar_clamp", None)
    model = BetaVAEModule(
        image_size=int(dcfg.image_size),
        in_channels=1 if dcfg.grayscale else 3,
        latent_dim=int(mcfg.latent_dim),
        base_channels=int(mcfg.base_channels),
        num_blocks=int(mcfg.num_blocks),
        activation=str(mcfg.activation),
        norm_type=str(mcfg.encoder_norm),
        se_reduction=int(mcfg.se_reduction_ratio),
        use_decoder_se=bool(mcfg.use_decoder_se),
        encoder_pooling=str(get(mcfg, "encoder_pooling", "flatten")),
        logvar_clamp=tuple(logvar_clamp) if logvar_clamp else None,
        latent_clamp=get(mcfg, "latent_clamp", None),
        mixed_precision=mixed_precision,
        fused_head=resolve_fused_head(get(cfg.training, "fused_head", "auto")),
    )
    init_weights(model, torch.Generator().manual_seed(int(dcfg.seed)))
    return model.to(dev)
