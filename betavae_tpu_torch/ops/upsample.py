"""Bilinear ×2 upsampling with half-pixel centres (``align_corners=False``):
the CUDA kernels and their plain PyTorch versions.

Counterpart of ``betavae_tpu/ops/upsample.py::bilinear_upsample_x2``, whose
separable dilated depthwise convolutions are a TPU lowering of exactly this
function, edges included (the edge taps clamp to the border pixel).  Per
axis, ``out[2i] = 0.25·x[i−1] + 0.75·x[i]`` and ``out[2i+1] = 0.75·x[i] +
0.25·x[i+1]``, indices clamped.

Two kernels (``csrc/upsample.cu``, whose header gives their bound on an
H100): :func:`upsample2x_forward`, and :func:`upsample2x_backward` in
gather form, where each ``dx`` element is one thread's fixed-order sum of
the ``dy`` taps that touch it, with no atomics, so a run replays bitwise
(``F.interpolate``'s backward scatters with atomics).  Both compute in fp32,
the H axis first, with every product and sum rounded on its own, and round
once to the input's dtype; the plain versions (:func:`upsample2x_reference`,
:func:`upsample2x_backward_reference`) do the same in torch ops, so kernel
and plain version agree bitwise.  Each wrapper launches its kernel for a
CUDA tensor and takes the plain version only for a CPU tensor; ``.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..device import raw_stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int):
    """``even`` and ``odd`` alternating along ``dim`` (``even`` first)."""
    return torch.stack((even, odd), dim=dim + 1).flatten(dim, dim + 1)


def _up_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of the forward on an edge-padded fp32 ``x`` (``n + 2``
    along ``dim``): ``2n`` values."""
    n = x.shape[dim] - 2
    lo, mid, hi = (x.narrow(dim, k, n) for k in range(3))
    return _interleave(0.25 * lo + 0.75 * mid, 0.75 * mid + 0.25 * hi, dim)


def upsample2x_reference(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W) in ``x``'s dtype: an edge-replicate
    pad, then the taps over H and then over W, in fp32."""
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="replicate")
    return _up_axis(_up_axis(xp, 2), 3).to(x.dtype)


def _down_axis(g: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of the gather backward on fp32 ``g`` (``2n`` along
    ``dim``): ``dx[i] = 0.25·g[2i−1] + w1·g[2i] + w2·g[2i+1] + 0.25·g[2i+2]``,
    ``g`` 0 outside, ``w1`` 1.0 at ``i = 0`` and ``w2`` 1.0 at ``i = n−1``
    (the clamped taps fold into the edge), else 0.75."""
    n = g.shape[dim] // 2
    pad = [0, 0] * (g.dim() - 1 - dim) + [1, 1]
    gp = F.pad(g, pad)
    even = torch.arange(0, 2 * n, 2, device=g.device)
    taps = [gp.index_select(dim, even + k) for k in range(4)]
    shape = [1] * g.dim()
    shape[dim] = n
    w1 = torch.full((n,), 0.75, dtype=g.dtype, device=g.device)
    w2 = w1.clone()
    w1[0] = 1.0
    w2[-1] = 1.0
    w1, w2 = w1.reshape(shape), w2.reshape(shape)
    return 0.25 * taps[0] + w1 * taps[1] + w2 * taps[2] + 0.25 * taps[3]


def upsample2x_backward_reference(dy: torch.Tensor) -> torch.Tensor:
    """(B, C, 2H, 2W) → (B, C, H, W) in ``dy``'s dtype: the gather sum of
    the backward, over W and then over H, in fp32."""
    return _down_axis(_down_axis(dy.float(), 3), 2).to(dy.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    lib = _build.load("upsample")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    for fn in (lib.betavae_upsample2x_fwd, lib.betavae_upsample2x_bwd):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(entry: str, src: torch.Tensor, out: torch.Tensor, h: int,
            w: int) -> torch.Tensor:
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"upsample kernel takes float32 or bfloat16, got "
                        f"{src.dtype}")
    if src.device.index != torch.cuda.current_device():
        with torch.cuda.device(src.device):
            return _launch(entry, src, out, h, w)
    b, c = src.shape[:2]
    rc = getattr(_library(), entry)(
        src.data_ptr(), out.data_ptr(), b * c, h, w, _DTYPE_CODES[src.dtype],
        raw_stream(src.device))
    if rc != 0:
        raise RuntimeError(f"upsample kernel {entry} failed with CUDA error "
                           f"{rc}")
    return out


def _device(t: torch.Tensor) -> str:
    if t.dim() != 4:
        raise ValueError(f"upsample takes (B, C, H, W), got {tuple(t.shape)}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def upsample2x_forward(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), without autograd: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if _device(x) == "cpu":
        return upsample2x_reference(x)
    x = x.contiguous()
    b, c, h, w = x.shape
    out = _launch("betavae_upsample2x_fwd", x,
                  x.new_empty((b, c, 2 * h, 2 * w)), h, w)
    upsample2x_forward.launches += 1
    return out


upsample2x_forward.launches = 0


def upsample2x_backward(dy: torch.Tensor) -> torch.Tensor:
    """(B, C, 2H, 2W) → (B, C, H, W), the gather backward: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if _device(dy) == "cpu":
        return upsample2x_backward_reference(dy)
    b, c, h2, w2 = dy.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"upsample backward takes even H and W, got "
                         f"{tuple(dy.shape)}")
    dy = dy.contiguous()
    out = _launch("betavae_upsample2x_bwd", dy,
                  dy.new_empty((b, c, h2 // 2, w2 // 2)), h2 // 2, w2 // 2)
    upsample2x_backward.launches += 1
    return out


upsample2x_backward.launches = 0


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return upsample2x_forward(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_backward(g)


def bilinear_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), in ``x``'s dtype.  Autocast would
    upcast a bf16 input to fp32; the JAX decoder upsamples in its compute
    dtype, so autocast is off here."""
    with torch.autocast(x.device.type, enabled=False):
        return _Upsample2x.apply(x)


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilinear_upsample_x2(x)
