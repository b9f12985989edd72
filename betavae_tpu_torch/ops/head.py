"""SE gate folded into the final 3×3 C→1 conv: the CUDA kernels and their
plain PyTorch versions.

Counterpart of ``betavae_tpu/ops/pallas_head.py::fused_se_conv_head``.  The
decoder's tail ``y·s → conv3×3(C→1)`` is, because the channel contraction
commutes with the per-sample gate, ``conv(y, s⊙k)``: one pass over ``y``
with no gated copy of it ever written.  Layout is the port's: ``y`` NCHW
``[B, C, H, W]`` (bf16 or fp32), gates ``s`` ``[B, C]`` (bf16 or fp32),
weights ``k = final_conv.weight[0]`` ``[C, 3, 3]`` fp32; the logits come out
fp32 ``[B, H, W]``, and bias and sigmoid are the caller's.

Two kernels (``csrc/head.cu``, whose header gives their bound on an H100):

- :func:`head_forward`: ``out[b,h,w] = Σ_{tap,c} y[b,c,h+dh−1,w+dw−1] ·
  s[b,c] · k[c,dh,dw]`` with zero SAME padding,
- :func:`head_m`: ``M[b,tap,c] = Σ_hw y[b,c,h+dh−1,w+dw−1] · dy[b,h,w]``
  (``tap = 3·dh + dw``), the one term of the backward that re-reads ``y``.

The rest of the backward is plain torch ops, as the JAX package leaves it
to XLA (``pallas_head.py:170-210``): ``dk = Σ_b s·M``, ``ds = Σ_tap k·M``
and ``dy_y = s ⊙ Σ_tap shift(dy)·k`` (a [C, 9] × [9, H·W] product per
sample, with ``s`` folded into the weights).  Each wrapper launches its
kernel for CUDA tensors and takes the plain version only for CPU tensors;
``head_forward.launches`` and ``head_m.launches`` count kernel launches,
and ``.launches_by_path`` counts them by the kernel's path: ``"tma"`` where
TMA can describe the rows (:func:`tma_path`: the flagship's shapes),
``"generic"`` for the rest.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def head_conv_reference(y: torch.Tensor, s: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """Gate, then a 3×3 SAME conv, all in fp32: ``[B, H, W]`` logits."""
    with torch.autocast(y.device.type, enabled=False):
        yg = y.float() * s.float()[:, :, None, None]
        return F.conv2d(yg, k.float()[None], padding=1)[:, 0]


def head_m_reference(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``M[b, 3·dh+dw, c] = Σ_hw y[b, c, h+dh−1, w+dw−1] · dy[b, h, w]``,
    zero padded, in fp32: ``[B, 9, C]``."""
    h, w = y.shape[2:]
    yp = F.pad(y.float(), (1, 1, 1, 1))
    dy = dy.float()[:, None]
    return torch.stack([(yp[:, :, dh:dh + h, dw:dw + w] * dy).sum(dim=(2, 3))
                        for dh in range(3) for dw in range(3)], dim=1)


def head_dx(dy: torch.Tensor, s: torch.Tensor, k: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``dy_y[b,c,h,w] = Σ_{dh,dw} dy[b, h+1−dh, w+1−dw] · s[b,c] ·
    k[c,dh,dw]`` in fp32 (one [C, 9] × [9, H·W] product per sample, the
    gate folded into the weights), returned in ``dtype``."""
    b, h, w = dy.shape
    dyp = F.pad(dy.float(), (1, 1, 1, 1))
    shifts = torch.stack([dyp[:, 2 - dh:2 - dh + h, 2 - dw:2 - dw + w]
                          for dh in range(3) for dw in range(3)], dim=1)
    sk = s.float()[:, :, None] * k.float().reshape(1, k.shape[0], 9)
    return torch.bmm(sk, shifts.reshape(b, 9, h * w)).reshape(
        b, -1, h, w).to(dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    lib = _build.load("head")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.betavae_head_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int]
    lib.betavae_head_fwd.restype = ctypes.c_int
    lib.betavae_head_m.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
    lib.betavae_head_m.restype = ctypes.c_int
    lib.betavae_head_tma_path.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2
    lib.betavae_head_tma_path.restype = ctypes.c_int
    return lib


def tma_path(y: torch.Tensor, dy: torch.Tensor | None = None) -> bool:
    """Whether ``csrc/head.cu`` takes its TMA path for this contiguous
    ``y`` (and ``dy``, for M): both 16-byte aligned and a row of ``y`` a
    multiple of 16 bytes, the tensor map's rule (``tma_rows`` there)."""
    return (y.data_ptr() % 16 == 0
            and (dy is None or dy.data_ptr() % 16 == 0)
            and y.shape[-1] * y.element_size() % 16 == 0)


def _count(wrapper, tma: bool) -> None:
    wrapper.launches += 1
    wrapper.launches_by_path["tma" if tma else "generic"] += 1


def _dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"head kernel takes float32 or bfloat16 {name}, "
                        f"got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("head kernel inputs must share one device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def head_forward(y: torch.Tensor, s: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """fp32 ``[B, H, W]`` logits of the gated 3×3 C→1 conv, without
    autograd: the kernel for CUDA tensors, the plain version for CPU."""
    if _device_of(y, s, k).type == "cpu":
        return head_conv_reference(y, s, k)
    b, c, h, w = y.shape
    if s.shape != (b, c) or k.shape != (c, 3, 3):
        raise ValueError(f"head kernel shapes: y {tuple(y.shape)}, "
                         f"s {tuple(s.shape)}, k {tuple(k.shape)}")
    if k.dtype != torch.float32:
        raise TypeError(f"head kernel takes float32 k, got {k.dtype}")
    y_code, s_code = _dtype_code("y", y), _dtype_code("s", s)
    y, s, k = y.contiguous(), s.contiguous(), k.contiguous()
    out = torch.empty((b, h, w), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _library().betavae_head_fwd(
        y.data_ptr(), s.data_ptr(), k.data_ptr(), out.data_ptr(),
        b, c, h, w, y_code, s_code, stream, y.device.index)
    if rc != 0:
        raise RuntimeError(f"head forward kernel launch failed with CUDA "
                           f"error {rc}")
    _count(head_forward, tma_path(y))
    return out


head_forward.launches = 0
head_forward.launches_by_path = {"tma": 0, "generic": 0}


def head_m(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """fp32 ``M [B, 9, C]`` for the head's backward: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if _device_of(y, dy).type == "cpu":
        return head_m_reference(y, dy)
    b, c, h, w = y.shape
    if dy.shape != (b, h, w):
        raise ValueError(f"head M kernel shapes: y {tuple(y.shape)}, "
                         f"dy {tuple(dy.shape)}")
    if dy.dtype != torch.float32:
        raise TypeError(f"head M kernel takes float32 dy, got {dy.dtype}")
    y_code = _dtype_code("y", y)
    y, dy = y.contiguous(), dy.contiguous()
    m = torch.empty((b, 9, c), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _library().betavae_head_m(
        y.data_ptr(), dy.data_ptr(), m.data_ptr(), b, c, h, w, y_code,
        stream, y.device.index)
    if rc != 0:
        raise RuntimeError(f"head M kernel launch failed with CUDA error {rc}")
    _count(head_m, tma_path(y, dy))
    return m


head_m.launches = 0
head_m.launches_by_path = {"tma": 0, "generic": 0}


class _FusedSEConvHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, s, k):
        ctx.save_for_backward(y, s, k)
        return head_forward(y, s, k)

    @staticmethod
    def backward(ctx, g):
        y, s, k = ctx.saved_tensors
        g = g.float().contiguous()
        m = head_m(y, g)                                     # [B, 9, C]
        k9 = k.float().reshape(k.shape[0], 9)                # [C, 9]
        dk = (m * s.float()[:, None, :]).sum(dim=0).t().reshape(k.shape)
        ds = (m * k9.t()[None]).sum(dim=1)
        dy_y = head_dx(g, s, k, y.dtype)
        return dy_y, ds.to(s.dtype), dk.to(k.dtype)


def fused_se_conv_head(y: torch.Tensor, s: torch.Tensor,
                       k: torch.Tensor) -> torch.Tensor:
    """``conv3×3_same(y · s[:, :, None, None], k[None])[:, 0]`` without the
    gate pass: fp32 ``[B, H, W]`` logits, differentiable in ``y``, ``s``
    and ``k``; gradients come back in the inputs' dtypes."""
    return _FusedSEConvHead.apply(y, s, k)
