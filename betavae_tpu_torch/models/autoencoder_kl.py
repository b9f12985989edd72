"""Stable Diffusion's autoencoder, ``AutoencoderKL`` "kl-f8", as NCHW
``nn.Module``s on the port's training path.

From CompVis latent-diffusion (``ldm/modules/diffusionmodules/model.py``:
``Encoder``, ``Decoder``, ``ResnetBlock``, ``AttnBlock``, ``Downsample``,
``Upsample``; ``ldm/models/autoencoder.py``: ``AutoencoderKL``), with the
published module names (``encoder.down.{i}.block.{j}.norm1|conv1|norm2|
conv2|nin_shortcut``, ``encoder.mid.attn_1.q|k|v|proj_out``,
``quant_conv``, ``post_quant_conv``, ``decoder.up.{i}.upsample.conv``, …),
so the published checkpoint's state dict names every parameter:

- ``Norm`` is GroupNorm(``norm_groups``, eps 1e-6), then swish x·σ(x) where
  a block follows it with one;
- ``ResnetBlock(cin → cout)``: ``conv1(swish(norm1(x)))``, then
  ``conv2(swish(norm2(h)))`` (dropout 0), plus ``x``, through a 1×1
  ``nin_shortcut`` where cin ≠ cout;
- ``AttnBlock(C)``: one head of width C over the H·W positions, q, k, v
  and ``proj_out`` 1×1 convs of ``Norm(x)``, ``x + proj_out(softmax(qᵀk /
  √C)·v)``; the port runs ``F.scaled_dot_product_attention`` on q, k, v
  laid out ``[B, 1, HW, C]`` (the 1×1 convs as ``F.linear`` on the
  normalised input transposed once, so each is contiguous in C), where
  ldm multiplies with ``bmm``;
- ``Downsample``: zero pad (0, 1, 0, 1), then a 3×3 stride-2 conv;
  ``Upsample``: nearest ×2, then a 3×3 conv;
- encoder: ``conv_in``, ``num_res_blocks`` blocks a level at widths
  ``ch·ch_mult[i]`` with a ``Downsample`` after every level but the last,
  attention at ``attn_resolutions``, the mid block (``block_1``,
  ``attn_1``, ``block_2``), ``norm_out``, swish, ``conv_out`` to
  2·``z_channels``; ``quant_conv`` (1×1) gives μ and logσ², logσ² clamped
  to [−30, 20] (``DiagonalGaussianDistribution``);
- decoder: ``post_quant_conv`` (1×1), ``conv_in``, the mid block,
  ``num_res_blocks + 1`` blocks a level from the widest level down with an
  ``Upsample`` after every level but the last, ``norm_out``, swish,
  ``conv_out``, no output activation.

Images enter in [0, 1], as everywhere in the port, and are mapped to
[−1, 1] (``2x − 1``) as the recipe's loader does; :meth:`AutoencoderKL.
decode` maps the output back to [0, 1] (``(x̂ + 1) / 2``), and the loss
compares the two in [−1, 1] (:data:`IMAGE_RANGE`, ``models/losses.py``).
:meth:`AutoencoderKL.encode` returns μ and logσ² flattened to ``[B,
z·h·w]`` and :meth:`AutoencoderKL.decode` takes z of that shape, so the
step, the reparam+KL kernel and the loss take the model as they take the
β-VAE.

Mixed precision is ``torch.autocast`` to bf16 over the encoder's and the
decoder's bodies, with fp32 params and ``quant_conv`` in fp32.  Every norm
and the swish after it run as one op in its input's dtype (bf16 there),
with fp32 statistics: :func:`..ops.gn_silu.gn_silu`, the port's kernels on
the card (``csrc/gn_silu.cu``), their plain version on the CPU.  Each
attention call counts itself (:func:`..utils.profiling.library_call`:
``attn.<backend>``, the backend ``F.scaled_dot_product_attention`` picks),
so a captured step's replays count it (``train/chunks.py``), beside the
norm kernels' launches (``gn_silu.<path>_launches``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gn_silu import gn_silu
from ..ops.reparam import reparameterize_and_kl
from ..utils.profiling import library_call

# the range the model computes images in, which the loss compares them in
IMAGE_RANGE = (-1.0, 1.0)
LOGVAR_CLAMP = (-30.0, 20.0)
# torch.nn.attention.SDPBackend's values, by the name a counter gives them
_SDPA_BACKENDS = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}


def sdpa_backend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backend ``F.scaled_dot_product_attention(q, k, v)`` runs on."""
    return _SDPA_BACKENDS.get(int(torch._fused_sdp_choice(q, k, v)),
                              "other")


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)`` in ``x``'s dtype."""
    return gn_silu(x, norm.weight, norm.bias, norm.num_groups, norm.eps,
                   swish=False)


def _norm_swish(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``swish(norm(x))`` in ``x``'s dtype."""
    return gn_silu(x, norm.weight, norm.bias, norm.num_groups, norm.eps)


def _norm(channels: int, groups: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-6, affine=True)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = _norm(cin, groups)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout, groups)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(_norm_swish(self.norm1, x))
        h = self.conv2(_norm_swish(self.norm2, h))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


def _linear_of(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The 1×1 ``conv`` over ``x`` laid out ``[B, HW, C]``."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class AttnBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.norm = _norm(channels, groups)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        t = _group_norm(self.norm, x).flatten(2).transpose(1, 2).contiguous()
        q, k, v = (_linear_of(m, t)[:, None] for m in (self.q, self.k, self.v))
        library_call(f"attn.{sdpa_backend(q, k, v)}")
        o = F.scaled_dot_product_attention(q, k, v)[:, 0]
        o = _linear_of(self.proj_out, o)
        return x + o.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, groups)
        self.attn_1 = AttnBlock(channels, groups)
        self.block_2 = ResnetBlock(channels, channels, groups)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _Level(nn.Module):
    """One resolution's blocks, their attention where the level has it,
    and its ``downsample`` or ``upsample``."""

    def __init__(self, blocks: list, attn: list, resample=None,
                 name: str = ""):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attn)
        self.resample = None
        if resample is not None:
            setattr(self, name, resample)
            self.resample = name

    def forward(self, h):
        for i, blk in enumerate(self.block):
            h = blk(h)
            if self.attn:
                h = self.attn[i](h)
        return getattr(self, self.resample)(h) if self.resample else h


class Encoder(nn.Module):
    def __init__(self, *, ch: int, ch_mult, num_res_blocks: int,
                 in_channels: int, resolution: int, z_channels: int,
                 groups: int, attn_resolutions=()):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        res, widths = resolution, [ch * m for m in ch_mult]
        cin = ch
        self.down = nn.ModuleList()
        for i, cout in enumerate(widths):
            blocks, attn = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, cout, groups))
                cin = cout
                if res in attn_resolutions:
                    attn.append(AttnBlock(cout, groups))
            last = i == len(widths) - 1
            self.down.append(_Level(blocks, attn, None if last
                                    else Downsample(cout), "downsample"))
            if not last:
                res //= 2
        self.mid = _Mid(cin, groups)
        self.norm_out = _norm(cin, groups)
        self.conv_out = nn.Conv2d(cin, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(_norm_swish(self.norm_out, h))


class Decoder(nn.Module):
    """ldm builds ``up`` from the widest level down and inserts each at the
    front, so ``up[i]`` is level ``i`` and the levels run in reverse; the
    modules are made in that order here too, which is the order a seeded
    build draws their initial weights in."""

    def __init__(self, *, ch: int, ch_mult, num_res_blocks: int,
                 out_channels: int, resolution: int, z_channels: int,
                 groups: int, attn_resolutions=()):
        super().__init__()
        widths = [ch * m for m in ch_mult]
        cin = widths[-1]
        res = resolution // 2 ** (len(widths) - 1)
        self.conv_in = nn.Conv2d(z_channels, cin, 3, padding=1)
        self.mid = _Mid(cin, groups)
        levels = []
        for i in reversed(range(len(widths))):
            blocks, attn = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, widths[i], groups))
                cin = widths[i]
                if res in attn_resolutions:
                    attn.append(AttnBlock(cin, groups))
            levels.insert(0, _Level(blocks, attn, Upsample(cin) if i else None,
                                    "upsample"))
            if i:
                res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(cin, groups)
        self.conv_out = nn.Conv2d(cin, out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(_norm_swish(self.norm_out, h))


class AutoencoderKL(nn.Module):
    """Inputs NCHW float in [0, 1]; outputs in [0, 1]; the latent flattened
    to ``[B, latent_dim]``, ``latent_dim = z_channels · (image_size /
    2^(len(ch_mult) − 1))²``."""

    def __init__(self, *, image_size: int, in_channels: int, ch: int,
                 ch_mult, num_res_blocks: int, z_channels: int,
                 norm_groups: int, attn_resolutions=(),
                 mixed_precision: bool = False, deterministic: bool = False):
        super().__init__()
        down = 2 ** (len(ch_mult) - 1)
        if image_size % down:
            raise ValueError(f"image_size {image_size} does not divide by "
                             f"the encoder's {down}× downsampling")
        self.image_size, self.in_channels = image_size, in_channels
        self.z_channels = z_channels
        self.latent_hw = image_size // down
        self.latent_dim = z_channels * self.latent_hw ** 2
        self.mixed_precision = mixed_precision
        self.deterministic = deterministic
        sizes = dict(ch=ch, ch_mult=tuple(ch_mult),
                     num_res_blocks=num_res_blocks, resolution=image_size,
                     z_channels=z_channels, groups=norm_groups,
                     attn_resolutions=tuple(attn_resolutions))
        self.encoder = Encoder(in_channels=in_channels, **sizes)
        self.decoder = Decoder(out_channels=in_channels, **sizes)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * z_channels, 1)
        self.post_quant_conv = nn.Conv2d(z_channels, z_channels, 1)

    def _autocast(self, device: torch.device):
        if not self.mixed_precision:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

    def encode(self, x: torch.Tensor):
        """``(mu, logvar)``, fp32 ``[B, latent_dim]``, of images in [0, 1]."""
        lo, hi = IMAGE_RANGE
        with self._autocast(x.device):
            h = self.encoder(x * (hi - lo) + lo)
        with torch.autocast(x.device.type, enabled=False):
            moments = self.quant_conv(h.float())
        mu, logvar = moments.chunk(2, dim=1)
        return (mu.flatten(1),
                logvar.clamp(*LOGVAR_CLAMP).flatten(1))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Images in [0, 1] of latents ``[B, latent_dim]``."""
        z = z.reshape(z.shape[0], self.z_channels, self.latent_hw,
                      self.latent_hw)
        with self._autocast(z.device):
            x = self.decoder(self.post_quant_conv(z))
        lo, hi = IMAGE_RANGE
        return (x.float() - lo) / (hi - lo)

    def forward(self, x: torch.Tensor, deterministic: bool = False,
                generator: torch.Generator | None = None):
        """``(recon, mu, logvar, z)``; ``z = mu`` when ``deterministic``,
        else a ``torch.randn`` draw from ``generator``."""
        mu, logvar = self.encode(x)
        z, _ = reparameterize_and_kl(mu, logvar, generator=generator,
                                     deterministic=deterministic)
        return self.decode(z), mu, logvar, z


def autoencoder_kl_from_config(cfg, *, mixed_precision: bool,
                               seed: int) -> AutoencoderKL:
    """The model of a config whose ``model.architecture`` is
    ``autoencoder_kl``, its weights PyTorch's default initialisation (as
    ldm's modules get it) drawn from the CPU generator seeded ``seed``, in
    the order the modules are made."""
    from ..config import get

    m, d = cfg.model, cfg.data
    for key, off in (("training.remat", get(cfg.training, "remat", False)),
                     ("training.fused_head",
                      get(cfg.training, "fused_head", "auto"))):
        if off not in (False, None, "none", "false", "auto"):
            raise ValueError(f"{key} = {off!r}: the autoencoder_kl "
                             f"architecture has no such path")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(seed))
        model = AutoencoderKL(
            image_size=int(d.image_size),
            in_channels=1 if d.grayscale else 3, ch=int(m.ch),
            ch_mult=[int(c) for c in m.ch_mult],
            num_res_blocks=int(m.num_res_blocks),
            z_channels=int(m.z_channels), norm_groups=int(m.norm_groups),
            attn_resolutions=[int(r) for r in get(m, "attn_resolutions", [])
                              or []],
            mixed_precision=mixed_precision,
            deterministic=bool(get(m, "deterministic_overfit", False)))
    latent = get(m, "latent_dim", None)
    if latent is not None and int(latent) != model.latent_dim:
        raise ValueError(f"model.latent_dim {latent} is not the "
                         f"autoencoder's z·h·w = {model.latent_dim}")
    return model
