"""Fused reparameterisation sample + elementwise KL and its backward: the
CUDA kernels and their plain PyTorch versions.

Counterpart of ``betavae_tpu/ops/pallas_elbo.py::fused_reparam_kl``.  The
forward kernel (``csrc/elbo.cu``, whose header gives its bound on an H100
and its design) draws ε in-kernel with Philox4x32-10 and Box–Muller and
writes ``z``, the elementwise KL and ε in one pass.  The backward kernel
computes the closed form of ``pallas_elbo.py:118-125``, which XLA runs as
one fusion on the TPU, in one pass:

    dμ     = g_z + g_kl · μ
    dlogσ² = ½ · ε · std · g_z + ½ · (e^{logσ²} − 1) · g_kl

:func:`reparam_kl_forward` and :func:`reparam_kl_backward` launch the
kernels for CUDA tensors and take the plain versions (:func:`philox_normal`
then :func:`reparam_kl_reference`; :func:`reparam_kl_backward_reference`)
only for CPU tensors: there is no fallback from the GPU.
``fused_reparam_kl.launches`` and ``reparam_kl_backward.launches`` count
kernel launches.

The forward kernel reads its Philox offset from device memory, so that a
step captured in a CUDA graph draws each replay's own noise
(``train/chunks.py``): the trainers pass the step's slot, a 0-d int64
tensor; an int offset is written to such a tensor first.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from ..device import raw_stream
from .reparam import reparameterize_and_kl

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586
# programmatic dependent launch for the forward: off, the faster in a
# replayed CUDA graph, the trainers' path (chip_smoke.py's kernel phase,
# elbo_device_offset, times both in turns)
FORWARD_PDL = False


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _mulhilo(a: int, x: torch.Tensor):
    """High and low 32-bit words of ``a · x`` for ``x`` int64 in [0, 2³²),
    in 16-bit halves so no int64 product overflows."""
    p1 = x * (a >> 16)
    p0 = x * (a & 0xFFFF)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 words."""
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_normal(shape, seed: int, offset,
                  device: torch.device | str = "cpu",
                  start: int = 0) -> torch.Tensor:
    """The kernel's ε in plain torch: element ``i`` of the flattened shape
    is Box–Muller (cosine branch) on words 0 and 1 of Philox4x32-10 with
    key ``seed`` and counter ``(start + i, offset)``, so ``start = k``
    gives elements ``k, k+1, …`` of a larger draw.  ``offset`` is an int or
    a 0-d int64 tensor holding one ≥ 0 (read without a host sync)."""
    n = math.prod(shape)
    seed &= _MASK64
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    c0 = idx & _MASK32
    c1 = idx >> 32
    if isinstance(offset, torch.Tensor):
        offset = offset.to(device=idx.device, dtype=torch.int64)
        c2 = (offset & _MASK32).expand_as(idx)
        c3 = (offset >> 32).expand_as(idx)
    else:
        offset &= _MASK64
        c2 = torch.full_like(idx, offset & _MASK32)
        c3 = torch.full_like(idx, offset >> 32)
    r0, r1, _, _ = philox4x32_10(c0, c1, c2, c3, seed & _MASK32, seed >> 32)
    u1 = (r0 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u2 = (r1 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u1 = torch.clamp_min(u1, 1e-7)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
    return eps.reshape(shape)


def reparam_kl_reference(mu: torch.Tensor, logvar: torch.Tensor,
                         eps: torch.Tensor):
    """``(z, kl_elem)`` from a given ε, in the kernel's order of operations."""
    return reparameterize_and_kl(mu, logvar, eps=eps)


def reparam_kl_backward_reference(mu: torch.Tensor, logvar: torch.Tensor,
                                  eps: torch.Tensor, g_z: torch.Tensor,
                                  g_kl: torch.Tensor):
    """``(dμ, dlogσ²)``: the closed form of ``pallas_elbo.py:118-125`` in
    plain torch ops, in the backward kernel's order of operations."""
    std = torch.exp(0.5 * logvar)
    d_mu = g_z + g_kl * mu
    d_logvar = 0.5 * eps * std * g_z + 0.5 * (torch.exp(logvar) - 1.0) * g_kl
    return d_mu, d_logvar


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    """``(forward, backward)`` C entries of ``csrc/elbo.cu``."""
    lib = _build.load("elbo")
    forward, backward = lib.betavae_reparam_kl, lib.betavae_reparam_kl_backward
    # without argtypes ctypes would pass each pointer as a 32-bit int
    forward.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    strided = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    backward.argtypes = [ctypes.c_void_p] * 3 + strided * 2 + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int]
    forward.restype = backward.restype = ctypes.c_int
    return forward, backward


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous fp32, copied only where it is not already (the
    main path's μ and logσ² are: the model computes both heads in fp32)."""
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _check_like(mu: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.shape != mu.shape or t.device != mu.device:
            raise ValueError(f"reparam+KL takes tensors of one shape and "
                             f"device: {tuple(mu.shape)} on {mu.device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def _device_offset(offset: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``offset`` as the kernel reads it: one int64 on ``device``."""
    if (offset.dim() != 0 or offset.dtype is not torch.int64
            or offset.device != device):
        raise ValueError(f"a device offset is a 0-d int64 tensor on "
                         f"{device}, got {tuple(offset.shape)} "
                         f"{offset.dtype} on {offset.device}")
    return offset


def _launch(mu: torch.Tensor, logvar: torch.Tensor, seed: int, offset,
            pdl: bool = FORWARD_PDL, start: int = 0):
    """``(z, kl, eps)``, rows of one fp32 ``[3, *shape]`` buffer, for
    contiguous fp32 CUDA ``mu`` and ``logvar``, the noise from counter
    ``start`` on.  ``offset`` is a 0-d int64 tensor on ``mu``'s device,
    which the kernel reads, or an int, written to one first (its 64 bits
    as the kernel reads them).  ``pdl`` chooses programmatic dependent
    launch, for measuring what it buys."""
    _check_like(mu, logvar)
    if mu.device.index != torch.cuda.current_device():
        with torch.cuda.device(mu.device):
            return _launch(mu, logvar, seed, offset, pdl, start)
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")
    if isinstance(offset, torch.Tensor):
        offset = _device_offset(offset, mu.device)
    else:
        offset &= _MASK64
        offset = torch.full((), offset - (offset >> 63 << 64),
                            dtype=torch.int64, device=mu.device)
    out = mu.new_empty((3, *mu.shape))
    rc = _library()[0](mu.data_ptr(), logvar.data_ptr(), out.data_ptr(),
                       mu.numel(), seed & _MASK64, offset.data_ptr(), start,
                       raw_stream(mu.device), int(pdl))
    if rc != 0:
        raise RuntimeError(f"elbo kernel launch failed with CUDA error {rc}")
    fused_reparam_kl.launches += 1
    return out.unbind(0)


def _offset_arg(offset):
    """An int offset as a Python int; a tensor one as it is."""
    return offset if isinstance(offset, torch.Tensor) else int(offset)


def reparam_kl_forward(mu: torch.Tensor, logvar: torch.Tensor, seed: int,
                       offset=0, start: int = 0):
    """``(z, kl_elem, eps)``, all fp32, without autograd: the kernel for
    CUDA tensors, the plain version for CPU tensors.  ``offset`` is an int
    or a 0-d int64 tensor on ``mu``'s device.  ``start`` is the flat index
    of ``mu``'s first element in the whole batch whose noise is drawn (a
    data-parallel rank's first row times the latent width)."""
    mu, logvar = _fp32(mu), _fp32(logvar)
    offset = _offset_arg(offset)
    if mu.device.type == "cuda":
        return _launch(mu, logvar, int(seed), offset, start=int(start))
    if mu.device.type != "cpu":
        raise ValueError(f"unsupported device {mu.device}")
    if isinstance(offset, torch.Tensor):
        offset = _device_offset(offset, mu.device)
    eps = philox_normal(mu.shape, int(seed), offset, mu.device,
                        start=int(start))
    z, kl = reparam_kl_reference(mu, logvar, eps)
    return z, kl, eps


def _rows(g: torch.Tensor):
    """``(g as fp32, (row, column) strides)`` of its ``[numel / C, C]`` view,
    C its last dim.  A 2-D gradient goes as it comes: the flagship's g_kl
    arrives as a broadcast (capacity mode's per-sample sum, strides (1, 0)),
    which a copy to contiguous memory would cost a launch of its own."""
    if g.dtype is not torch.float32:
        g = g.float()
    if g.dim() == 2:
        return g, g.stride()
    g = g.contiguous()
    return g, (g.shape[-1] if g.dim() else 1, 1)


def _launch_backward(mu, logvar, eps, g_z, g_kl, pdl: bool = True):
    """``(dμ, dlogσ²)``, rows of one fp32 ``[2, *shape]`` buffer, for CUDA
    tensors of one shape: μ, logσ² and ε contiguous fp32, the gradients
    any layout."""
    _check_like(mu, logvar, eps, g_z, g_kl)
    if mu.device.index != torch.cuda.current_device():
        with torch.cuda.device(mu.device):
            return _launch_backward(mu, logvar, eps, g_z, g_kl, pdl)
    (g_z, (z_row, z_col)), (g_kl, (kl_row, kl_col)) = _rows(g_z), _rows(g_kl)
    out = mu.new_empty((2, *mu.shape))
    rc = _library()[1](mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(),
                       g_z.data_ptr(), z_row, z_col, g_kl.data_ptr(), kl_row,
                       kl_col, out.data_ptr(), mu.numel(),
                       mu.shape[-1] if mu.dim() else 1,
                       raw_stream(mu.device), int(pdl))
    if rc != 0:
        raise RuntimeError(f"elbo backward kernel launch failed with CUDA "
                           f"error {rc}")
    reparam_kl_backward.launches += 1
    return out.unbind(0)


def reparam_kl_backward(mu: torch.Tensor, logvar: torch.Tensor,
                        eps: torch.Tensor, g_z: torch.Tensor,
                        g_kl: torch.Tensor):
    """``(dμ, dlogσ²)``, fp32: the backward kernel for CUDA tensors, the
    plain closed form for CPU tensors."""
    if mu.device.type == "cuda":
        return _launch_backward(_fp32(mu), _fp32(logvar), _fp32(eps), g_z,
                                g_kl)
    if mu.device.type != "cpu":
        raise ValueError(f"unsupported device {mu.device}")
    return reparam_kl_backward_reference(mu.float(), logvar.float(),
                                         eps.float(), g_z.float(),
                                         g_kl.float())


reparam_kl_backward.launches = 0


class _FusedReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar, seed, offset, start):
        mu, logvar = _fp32(mu), _fp32(logvar)
        z, kl, eps = reparam_kl_forward(mu, logvar, seed, offset, start)
        ctx.save_for_backward(mu, logvar, eps)
        return z, kl

    @staticmethod
    def backward(ctx, g_z, g_kl):
        d_mu, d_logvar = reparam_kl_backward(*ctx.saved_tensors, g_z, g_kl)
        return d_mu, d_logvar, None, None, None


def fused_reparam_kl(mu: torch.Tensor, logvar: torch.Tensor, seed: int,
                     offset=0, start: int = 0):
    """Returns ``(z, kl_elem)``, both fp32 with the shape of ``mu``.

    ``(seed, offset)`` selects the noise: the trainer passes the run's seed
    and the step number, so every step draws fresh ε and a run replays.
    ``offset`` is an int, or a 0-d int64 tensor on ``mu``'s device (the
    same noise, bitwise): a captured step passes its slot's, so that each
    replay draws its own.
    ``start`` places ``mu`` in a larger batch: a data-parallel rank passes
    its first row times the latent width, and draws its rows of the noise
    of the whole batch.
    """
    return _FusedReparamKL.apply(mu, logvar, int(seed), _offset_arg(offset),
                                 int(start))


fused_reparam_kl.launches = 0
