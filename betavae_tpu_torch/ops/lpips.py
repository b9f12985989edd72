"""LPIPS perceptual distance over frozen AlexNet features, in PyTorch.

Counterpart of ``betavae_tpu/ops/lpips.py``: grayscale inputs are repeated
to 3 channels, scaled from [0, 1] to [−1, 1], shifted and scaled as the
official metric does, and run through the five convolutions of AlexNet's
feature trunk (ReLU taps; a 3×3 stride-2 max-pool with no padding after the
first two).  Each tap is normalised to unit length over channels (``+1e-10``
outside the square root), the squared difference is weighted per channel
by ``|lin_i|``, averaged over H and W, and summed over the taps; the batch
mean of the distance clamped at 0 is the loss.  fp32 throughout with
autocast off, as the reference runs it.  Plain PyTorch: the JAX package has
no kernel here either.  Layout NCHW, so "channels" is dim 1.

Weights come from ``loss.lpips_weights_path`` or ``$LPIPS_WEIGHTS``: an
``.npz`` in the layout ``scripts/convert_lpips_weights.py`` writes
(``net/conv{i}/kernel`` HWIO, ``net/conv{i}/bias``, ``lin{i}`` of shape
``(C,)``), which :func:`convert` writes from the official torch files.
Without one, the network is a deterministic random init from a
``torch.Generator`` seeded with 0, drawn from flax's distributions (LeCun
normal kernels, zero biases, ``lin{i}`` uniform in [0, 0.1)); it makes no
bitwise claim against the JAX package's ``PRNGKey(0)`` init.  Nothing is
ever downloaded.
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel.reduce import global_sum, world_size

# official LPIPS input scaling (net preprocessing)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_ALEX_CFG = (
    # (features, kernel, stride, padding, pool_after)
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)

# flax's lecun_normal: a normal truncated at ±2σ, rescaled to the variance
# 1/fan_in (the constant is the std of a unit normal truncated at ±2)
_TRUNC_STD = 0.87962566103423978


class _AlexFeatures(nn.Module):
    """AlexNet feature trunk; returns the activations after each ReLU."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for feats, k, s, p, _ in _ALEX_CFG:
            convs.append(nn.Conv2d(cin, feats, k, stride=s, padding=p))
            cin = feats
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list:
        taps = []
        for conv, (*_, pool) in zip(self.convs, _ALEX_CFG):
            x = F.relu(conv(x))
            taps.append(x)
            if pool:
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPSModule(nn.Module):
    """``(x, y) -> (B,)`` distances for NCHW 3-channel inputs in [−1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = _AlexFeatures()
        self.lins = nn.ParameterList(
            nn.Parameter(torch.zeros(feats)) for feats, *_ in _ALEX_CFG)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for a, b, w in zip(fx, fy, self.lins):
            # official normalize_tensor: x / (||x||_channels + 1e-10)
            a = a / (torch.sqrt((a ** 2).sum(dim=1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt((b ** 2).sum(dim=1, keepdim=True)) + 1e-10)
            d = (a - b) ** 2
            # official heads are trained non-negative
            total = total + (d * w.abs()[None, :, None, None]).sum(dim=1).mean(
                dim=(1, 2))
        return total


def resolve_weights_path(weights_path: str | None = None) -> str | None:
    """The usable converted-``.npz`` path (argument or ``$LPIPS_WEIGHTS``),
    or ``None`` when none exists."""
    path = weights_path or os.environ.get("LPIPS_WEIGHTS")
    return path if path and os.path.exists(path) else None


def resolve_weight_source(weights_path: str | None = None) -> str:
    """Display form for the CONFIG line: ``"pretrained:<path>"`` or the loud
    ``"random-init"`` marker."""
    path = resolve_weights_path(weights_path)
    return f"pretrained:{path}" if path else "random-init"


def _random_init(module: LPIPSModule) -> None:
    """Flax's initialisers from a generator seeded with 0: LeCun normal
    kernels, zero biases, ``lin{i}`` uniform in [0, 0.1)."""
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for conv in module.net.convs:
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=g)
            nn.init.zeros_(conv.bias)
        for lin in module.lins:
            nn.init.uniform_(lin, 0.0, 0.1, generator=g)


def _load_npz(module: LPIPSModule, path: str) -> None:
    """The converter's ``.npz`` into ``module``; a missing key or a shape
    that differs raises."""
    with np.load(path) as flat:
        state = {}
        for i in range(len(_ALEX_CFG)):
            kernel = flat[f"net/conv{i}/kernel"]           # HWIO
            state[f"net.convs.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
            state[f"net.convs.{i}.bias"] = torch.from_numpy(
                flat[f"net/conv{i}/bias"])
            state[f"lins.{i}"] = torch.from_numpy(flat[f"lin{i}"])
    module.load_state_dict({k: v.float() for k, v in state.items()},
                           strict=True)


# torch AlexNet ``features`` indices of the five convolutions
_TORCH_CONV_IDX = (0, 3, 6, 8, 10)


def convert(alexnet_path: str, linear_path: str, out_path: str) -> str:
    """The official weights (torchvision's AlexNet state dict and the lpips
    package's ``alex.pth`` heads, each read with ``torch.load(...,
    weights_only=True)``) as the ``.npz`` :func:`load_lpips_module` reads:
    ``net/conv{i}/kernel`` HWIO of ``features.{0,3,6,8,10}.weight``, its
    bias, and ``lin{i}`` flattened from ``lin{i}.model.1.weight`` (or
    ``.model.0.`` in releases without the dropout layer).  The file is
    loaded back strictly before the path is returned."""
    feats = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lins = torch.load(linear_path, map_location="cpu", weights_only=True)
    flat = {}
    for i, ti in enumerate(_TORCH_CONV_IDX):
        w = feats[f"features.{ti}.weight"].numpy()         # (O, I, H, W)
        flat[f"net/conv{i}/kernel"] = np.transpose(w, (2, 3, 1, 0))
        flat[f"net/conv{i}/bias"] = feats[f"features.{ti}.bias"].numpy()
    for i in range(len(_ALEX_CFG)):
        key = f"lin{i}.model.1.weight"
        if key not in lins:
            key = f"lin{i}.model.0.weight"
        flat[f"lin{i}"] = lins[key].numpy().reshape(-1)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **flat)
    _load_npz(LPIPSModule(), out_path)
    return out_path


def load_lpips_module(weights_path: str | None = None) -> LPIPSModule:
    """The frozen module on the CPU: the ``.npz`` that
    :func:`resolve_weights_path` finds, else the seeded random init (with a
    warning)."""
    module = LPIPSModule()
    path = resolve_weights_path(weights_path)
    if path:
        _load_npz(module, path)
    else:
        _random_init(module)
        warnings.warn(
            "LPIPS pretrained weights not found; using deterministic "
            "randomly-initialized frozen features (set loss.lpips_weights_path "
            "or LPIPS_WEIGHTS to an .npz of converted official weights).")
    return module.requires_grad_(False).eval()


def build_lpips_fn(weights_path: str | None = None,
                   device: str | torch.device = "cuda"):
    """Returns ``lpips(pred, target) -> scalar`` over NCHW images in [0, 1].

    The reference's preparation: 1→3 channel repeat, [0, 1]→[−1, 1], the
    distance clamped at 0, the batch mean.  The parameters are frozen on
    ``device``: gradients flow to ``pred`` only.  With a data-parallel
    ``group`` (``lpips(pred, target, group=g)``), ``pred`` is a rank's rows
    and the mean is over the global batch.
    """
    dev = resolve_device(device)
    module = load_lpips_module(weights_path).to(dev)

    def _prep(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        return x * 2.0 - 1.0

    def lpips(pred: torch.Tensor, target: torch.Tensor,
              group=None) -> torch.Tensor:
        if pred.shape != target.shape:
            raise ValueError(
                f"Shape mismatch: pred {tuple(pred.shape)} vs target "
                f"{tuple(target.shape)}")
        with torch.autocast(pred.device.type, enabled=False):
            d = module(_prep(pred), _prep(target))
        d = torch.clamp(d, min=0.0)
        return global_sum(d.sum(), group) / (d.numel() * world_size(group))

    return lpips
