"""Fused reparameterisation sample + elementwise KL: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``betavae_tpu/ops/pallas_elbo.py::fused_reparam_kl``.  The
kernel (``csrc/elbo.cu``, whose header gives its bound on an H100) draws ε
in-kernel with Philox4x32-10 and Box–Muller and writes ``z``, the
elementwise KL and ε in one pass.  Its backward is the closed form of
``pallas_elbo.py:118-125`` in plain torch ops, as the JAX package has no
backward kernel either:

    dμ     = g_z + g_kl · μ
    dlogσ² = ½ · ε · std · g_z + ½ · (e^{logσ²} − 1) · g_kl

:func:`fused_reparam_kl` launches the kernel for CUDA tensors and takes the
plain version (:func:`philox_normal` then :func:`reparam_kl_reference`)
only for CPU tensors: there is no fallback from the GPU.
``fused_reparam_kl.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from .reparam import reparameterize_and_kl

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586


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


def philox_normal(shape, seed: int, offset: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernel's ε in plain torch: element ``i`` of the flattened shape
    is Box–Muller (cosine branch) on words 0 and 1 of Philox4x32-10 with
    key ``seed`` and counter ``(i, offset)``."""
    n = math.prod(shape)
    seed &= _MASK64
    offset &= _MASK64
    idx = torch.arange(n, dtype=torch.int64, device=device)
    c0 = idx & _MASK32
    c1 = idx >> 32
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


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    fn = _build.load("elbo").betavae_reparam_kl
    # without argtypes ctypes would pass each pointer as a 32-bit int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _launch(mu: torch.Tensor, logvar: torch.Tensor, seed: int, offset: int):
    if mu.dtype != torch.float32 or logvar.dtype != torch.float32:
        raise TypeError("fused_reparam_kl kernel takes float32 mu and logvar")
    if mu.shape != logvar.shape or mu.device != logvar.device:
        raise ValueError("mu and logvar must share shape and device")
    mu = mu.contiguous()
    logvar = logvar.contiguous()
    z = torch.empty_like(mu)
    kl = torch.empty_like(mu)
    eps = torch.empty_like(mu)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    rc = _library()(mu.data_ptr(), logvar.data_ptr(), z.data_ptr(),
                    kl.data_ptr(), eps.data_ptr(), mu.numel(),
                    seed & _MASK64, offset & _MASK64, stream,
                    mu.device.index)
    if rc != 0:
        raise RuntimeError(f"elbo kernel launch failed with CUDA error {rc}")
    fused_reparam_kl.launches += 1
    return z, kl, eps


def reparam_kl_forward(mu: torch.Tensor, logvar: torch.Tensor, seed: int,
                       offset: int = 0):
    """``(z, kl_elem, eps)``, all fp32, without autograd: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    mu32 = mu.float()
    logvar32 = logvar.float()
    if mu32.device.type == "cuda":
        return _launch(mu32, logvar32, int(seed), int(offset))
    if mu32.device.type != "cpu":
        raise ValueError(f"unsupported device {mu32.device}")
    eps = philox_normal(mu32.shape, int(seed), int(offset), mu32.device)
    z, kl = reparam_kl_reference(mu32, logvar32, eps)
    return z, kl, eps


class _FusedReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar, seed, offset):
        z, kl, eps = reparam_kl_forward(mu, logvar, seed, offset)
        ctx.save_for_backward(mu.float(), logvar.float(), eps)
        return z, kl

    @staticmethod
    def backward(ctx, g_z, g_kl):
        mu, logvar, eps = ctx.saved_tensors
        std = torch.exp(0.5 * logvar)
        d_mu = g_z + g_kl * mu
        d_logvar = 0.5 * eps * std * g_z + 0.5 * (torch.exp(logvar) - 1.0) * g_kl
        return d_mu, d_logvar, None, None


def fused_reparam_kl(mu: torch.Tensor, logvar: torch.Tensor, seed: int,
                     offset: int = 0):
    """Returns ``(z, kl_elem)``, both fp32 with the shape of ``mu``.

    ``(seed, offset)`` selects the noise: the trainer passes the run's seed
    and the step number, so every step draws fresh ε and a run replays.
    """
    return _FusedReparamKL.apply(mu, logvar, int(seed), int(offset))


fused_reparam_kl.launches = 0
