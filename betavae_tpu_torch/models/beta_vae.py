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
- ``remat`` (``training.remat``): ``true``/``all`` recomputes every encoder
  and decoder block's activations in the backward pass, ``decoder`` the
  decoder blocks' only (``torch.utils.checkpoint``, as the JAX module wraps
  the same blocks in ``nn.remat``); ``fc_*``, the reparam+KL and the head
  are never recomputed, and the last decoder block's ``(activations,
  gates)`` pair leaves its checkpoint for the fused head,
- norms: ``layer`` → GroupNorm(1) with flax's eps 1e-6, ``batch`` →
  BatchNorm with flax's update rule (momentum 0.99 is torch 0.01, running
  variance from the biased batch variance), ``none``; a block whose norm is
  ``layer`` and whose activation is ``relu`` runs GroupNorm → ReLU → the SE
  squeeze as one call of the port's GN kernels
  (``ops/gn.py::fused_gn_relu_pool``: the plain version for CPU tensors)
  on the conv output in its own dtype, its ``nn.GroupNorm`` only holding
  ``norm.weight`` and ``norm.bias``, where the JAX block runs flax
  ``GroupNorm``: the kernels' forward gives ``nn.GroupNorm``'s bits under
  autocast, and the squeeze is the mean of the activations as they leave
  the block, as the JAX SE block takes it,
- sampling for evaluation and inference (:func:`sample_forward`,
  :meth:`BetaVAEModule.sample_prior`, :meth:`BetaVAEModule.traverse`),
  which draw ε through the reparam+KL kernel (``ops/elbo.py``) on the card
  and its plain Philox version on the CPU, bitwise the same stream, and
  the host-side encode and decode of the evaluation and inference CLIs
  (:func:`encode_split`, :func:`decode_latents`),
- module names are the reference torch model's (``encoder.{i}.conv|norm|
  se.block.fc.{0,2}``, ``decoder_blocks.{i}.up.1``, ``fc_mu``, ``fc_logvar``,
  ``fc_dec``, ``final_conv``), so :func:`..io.weights.params_from_jax`
  output loads with ``strict=True``.

Mixed precision is ``torch.autocast`` to bf16 over the convolutions, norms,
SE and ``fc_dec``, with fp32 params, heads and sigmoid input.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import get, get_config
from ..data.dataset import images_to_tensor
from ..device import resolve_device
from ..ops.elbo import reparam_kl_forward
from ..ops.gn import fused_gn_relu_pool
from ..ops.head import fused_se_conv_head
from ..ops.reparam import reparameterize_and_kl
from ..ops.upsample import Upsample2x
from ..parallel.reduce import global_sum, world_size
from ..utils.profiling import library_call
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
    one).  Normalisation and parameter names are torch's.

    With a data-parallel ``group`` (set by the trainer), the batch
    statistics are the global batch's, as under the JAX package's mesh:
    the mean and then the biased variance from sums over the group
    (differentiable, :func:`..parallel.reduce.global_sum`), and the
    running statistics move by those, identically on every rank."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)
        # off while a remat checkpoint recomputes the block: the statistics
        # were updated by the block's forward, once a step, as flax's remat
        # updates them
        self.update_stats = True
        self.group = None

    def _global_batch_norm(self, x: torch.Tensor):
        """``(y, mean, var)``: ``x`` normalised by the statistics of the
        group's whole batch, in fp32."""
        x32 = x.float()
        n = x.shape[0] * x.shape[2] * x.shape[3] * world_size(self.group)
        mean = global_sum(x32.sum(dim=(0, 2, 3)), self.group) / n
        xc = x32 - mean[None, :, None, None]
        var = global_sum((xc * xc).sum(dim=(0, 2, 3)), self.group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = xc * scale[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            y, mean, var = self._global_batch_norm(x)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.lerp_(mean, self.momentum)
                    self.running_var.lerp_(var, self.momentum)
                    self.num_batches_tracked += 1
            return y
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if not self.update_stats:
            return y
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


def _norm_act(block: nn.Module, h: torch.Tensor):
    """``(activations, pooled)`` of ``block``'s norm and activation over
    its conv output ``h``: GroupNorm(1) → ReLU through the GN kernels, with
    their fp32 per-channel mean as ``pooled``, where the block is built of
    those two; else its modules (a GroupNorm among them counted as the
    library's, ``utils/profiling.py::library_call``), and ``pooled``
    None."""
    norm = block.norm
    if isinstance(norm, nn.GroupNorm):
        if norm.num_groups == 1 and isinstance(block.act, nn.ReLU):
            return fused_gn_relu_pool(h, norm.weight, norm.bias, norm.eps)
        library_call("gn.library")
    return block.act(_normed(norm, h)), None


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
        h, pooled = _norm_act(self, self.conv(x))
        return self.se(h, pooled=pooled)


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
        h, pooled = _norm_act(self, self.up(x))
        if isinstance(self.se, SEBlock):
            return self.se(h, return_gate, pooled)
        return (h, None) if return_gate else h


@contextlib.contextmanager
def _frozen_statistics(block: nn.Module):
    """The recompute of a checkpointed ``block``: its BatchNorms normalise
    by the batch's statistics as in the forward, and leave their running
    statistics as the forward left them."""
    norms = [m for m in block.modules() if isinstance(m, FlaxBatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def _checkpointed(block: nn.Module, *args):
    """``block(*args)`` with its activations recomputed in the backward
    pass.  The recompute runs under the autocast state of the forward
    (``checkpoint`` records and restores it).  No RNG state is kept
    (``preserve_rng_state=False``): a block draws no random numbers, the
    reparam noise being the kernel's Philox stream at an explicit
    (seed, offset) outside every block."""
    return checkpoint(
        block, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _frozen_statistics(block)))


def resolve_remat(value) -> str:
    """``training.remat`` as ``"none"``, ``"decoder"`` or ``"all"``, with
    the JAX module's spellings (``true``/``"all"``/``"true"``, ``"decoder"``,
    ``false``/``None``/``"none"``/``"false"``)."""
    if value in (True, "all", "true"):
        return "all"
    if value == "decoder":
        return "decoder"
    if value in (False, None, "none", "false"):
        return "none"
    raise ValueError(f"training.remat must be true/false/'decoder', got "
                     f"{value!r}")


@contextlib.contextmanager
def inference(model: nn.Module):
    """``torch.no_grad()`` in ``eval()`` mode, the module's mode restored
    after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


class BetaVAEModule(nn.Module):
    """Inputs and outputs NCHW float in [0, 1].  ``deterministic`` is the
    config's ``model.deterministic_overfit``: the default of
    :func:`sample_forward`, as the JAX ``BetaVAE.deterministic`` is."""

    def __init__(self, image_size: int, in_channels: int, latent_dim: int,
                 base_channels: int, num_blocks: int, activation: str = "relu",
                 norm_type: str = "layer", se_reduction: int = 16,
                 use_decoder_se: bool = True, encoder_pooling: str = "flatten",
                 logvar_clamp: Optional[Sequence[float]] = None,
                 latent_clamp: Optional[float] = None,
                 mixed_precision: bool = False, fused_head: bool = False,
                 deterministic: bool = False, remat=False):
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
        self.deterministic = deterministic
        self.remat = resolve_remat(remat)

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

    def _block_fn(self, blk: nn.Module, decoder: bool):
        """``blk``, checkpointed where ``remat`` covers it and a backward
        pass can follow."""
        if torch.is_grad_enabled() and (
                self.remat == "all" or (decoder and self.remat == "decoder")):
            return functools.partial(_checkpointed, blk)
        return blk

    def encode(self, x: torch.Tensor):
        with self._autocast(x.device):
            h = x
            for blk in self.encoder:
                h = self._block_fn(blk, decoder=False)(h)
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
                h = self._block_fn(blk, decoder=True)(h)
            last = self._block_fn(self.decoder_blocks[-1], decoder=True)
            if self.fused_head and self.in_channels == 1:
                h, gate = last(h, True)         # (activations, SE gates)
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

    def sample_prior(self, n: int, seed: int) -> torch.Tensor:
        """``n`` decodes of z ~ N(0, I): z is the Philox stream at ``(seed,
        0)``, drawn by the reparam+KL forward at μ = 0, logσ² = 0 (z = ε
        exactly).  The JAX package draws with ``jax.random.normal``, so the
        two agree in distribution, not bitwise."""
        zeros = torch.zeros((n, self.latent_dim),
                            device=self.fc_mu.weight.device)
        z = reparam_kl_forward(zeros, zeros, seed, 0)[0]
        with inference(self):
            return self.decode(z)

    def traverse(self, x: torch.Tensor, dim: int, steps: int = 7,
                 span: float = 3.0):
        """``(frames [B, steps, C, H, W], values [steps])``: μ of ``x`` with
        dim ``dim`` set to each of ``linspace(-span, span, steps)``, the
        whole sweep decoded in one call."""
        vals = torch.linspace(-span, span, steps)
        with inference(self):
            mu, _ = self.encode(x)
            z = mu[:, None, :].repeat(1, steps, 1)
            z[:, :, dim] = vals.to(mu.device)
            out = self.decode(z.reshape(-1, self.latent_dim))
        return out.reshape(x.shape[0], steps, *out.shape[1:]), vals


def sample_forward(model: BetaVAEModule, x: torch.Tensor, seed: int,
                   offset: int = 0, deterministic: bool | None = None):
    """``(recon, mu, logvar, z)`` of the evaluation forward, in ``eval()``
    mode without autograd: encode, z from the reparam+KL forward with the
    noise at ``(seed, offset)`` (the kernel on the card, its plain Philox
    version on the CPU, bitwise the same ε), decode.  ``deterministic``
    (default: the model's ``deterministic_overfit``) gives ``z = mu``.
    The JAX package draws with threefry keys, so sampled metrics agree with
    it in distribution, not bitwise."""
    if deterministic is None:
        deterministic = model.deterministic
    with inference(model):
        mu, logvar = model.encode(x)
        z = mu if deterministic else reparam_kl_forward(mu, logvar, seed,
                                                        offset)[0]
        return model.decode(z), mu, logvar, z


def to_numpy_images(frames: torch.Tensor) -> np.ndarray:
    """Model output ``[N, C, H, W]`` as host ``(N, H, W, C)`` float32."""
    return frames.permute(0, 2, 3, 1).float().cpu().numpy()


def encode_split(model: BetaVAEModule, images: np.ndarray, batch_size: int,
                 limit=None):
    """``(mu, logvar)``, host float32 ``(N, D)``, of the first ``limit``
    (all when falsy) packed uint8 images ``(N, H, W, C)`` (or float
    images in [0, 1]), encoded
    ``batch_size`` at a time; the results cross to the host once, after
    every batch is queued."""
    n = min(limit, len(images)) if limit else len(images)
    dev = model.fc_mu.weight.device
    mus, logvars = [], []
    with inference(model):
        for s in range(0, n, batch_size):
            mu, logvar = model.encode(
                images_to_tensor(images[s:min(s + batch_size, n)], dev))
            mus.append(mu)
            logvars.append(logvar)
    if not mus:
        empty = np.zeros((0, model.latent_dim), np.float32)
        return empty, empty.copy()
    return torch.cat(mus).cpu().numpy(), torch.cat(logvars).cpu().numpy()


def decode_latents(model: BetaVAEModule, zs) -> np.ndarray:
    """Host ``(N, H, W, C)`` decodes of latents ``(N, D)``, in one call."""
    z = torch.from_numpy(np.asarray(zs, np.float32))
    with inference(model):
        return to_numpy_images(model.decode(z.to(model.fc_mu.weight.device)))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal fan-in weights and zero biases for every conv and
    linear layer: the JAX package's ``variance_scaling(2, fan_in, normal)``
    init, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
            nn.init.zeros_(m.bias)


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
                      device: str | torch.device = "cuda") -> nn.Module:
    """The config's model, initialised from ``data.seed`` (on the CPU, so
    a seed gives the same weights on every device) and moved to
    ``device``: by ``model.architecture``, the flagship β-VAE
    (``beta_vae``, the default) or Stable Diffusion's autoencoder
    (``autoencoder_kl``, :mod:`.autoencoder_kl`)."""
    dev = resolve_device(device)
    cfg = cfg or get_config()
    mcfg, dcfg = cfg.model, cfg.data
    if mixed_precision is None:
        mixed_precision = bool(get(cfg.training, "mixed_precision", False))
    arch = str(get(mcfg, "architecture", "beta_vae"))
    if arch == "autoencoder_kl":
        from .autoencoder_kl import autoencoder_kl_from_config

        return autoencoder_kl_from_config(
            cfg, mixed_precision=mixed_precision,
            seed=int(dcfg.seed)).to(dev)
    if arch != "beta_vae":
        raise ValueError(f"model.architecture must be beta_vae or "
                         f"autoencoder_kl, got {arch!r}")
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
        deterministic=bool(get(mcfg, "deterministic_overfit", False)),
        remat=get(cfg.training, "remat", False),
    )
    init_weights(model, torch.Generator().manual_seed(int(dcfg.seed)))
    return model.to(dev)
