"""GroupNorm with one group → ReLU → per-channel spatial mean: the CUDA
kernels and their plain PyTorch versions.

Counterpart of ``betavae_tpu/ops/pallas_gn.py::fused_gn_relu_pool``: every
block of the flagship ends GroupNorm(1) → ReLU → SE, and the SE squeeze is
the per-channel mean of the ReLU output.  Per sample, over all C·H·W
values, in fp32 (the JAX kernel's statistics, not ``nn.GroupNorm``'s
variance)::

    m = Σx/n ;  v = Σx²/n − m² ;  rstd = rsqrt(max(v, 0) + eps)
    x̂ = (x − m)·rstd ;  z = x̂·γ + β ;  y = max(z, 0)
    pooled[b, c] = mean_hw(y)            (of the fp32 y)

and backward, given ``gy`` and ``gp`` (the gradients of ``y`` and
``pooled``)::

    gz = (gy + gp/HW)·1[z > 0] ;  dβ[b,c] = Σ_hw gz ;  dγ[b,c] = Σ_hw gz·x̂
    dx̂ = gz·γ ;  dx = rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂))

with the per-sample ``dγ``/``dβ`` summed over B outside the kernel, as
``pallas_gn.py:192-197`` does.  Layout is the port's: ``x`` NCHW ``[B, C,
H, W]`` in bf16 or fp32, ``γ``/``β`` fp32 ``[C]``; ``y`` comes back in x's
dtype, ``pooled`` fp32 ``[B, C]``.

Two kernel launchers (``csrc/gn.cu``, whose header gives their bound on an
H100 and their design): :func:`gn_forward` and :func:`gn_backward`.  Each
takes one of two paths, by :func:`gn_path` (shape and dtype alone):
``"cluster"``, one launch per direction with one thread-block cluster of
``k`` CTAs per sample holding the sample in shared memory (every sample
within the budget: the flagship's block shapes but its largest, and the
bench canary's), or ``"generic"``, two launches per direction (a stats
pass and an apply pass; a sums pass and a dx pass).  Each launches its
kernels for CUDA tensors and takes the plain version only for CPU tensors;
``gn_forward.launches`` and ``gn_backward.launches`` count kernel launches
and ``.launches_by_path`` counts them by path.  The plain versions form
``z`` with the same separately rounded operations as the kernels, so that
given the same ``m`` and ``rstd`` the two agree on every ReLU mask bit.

Not wired into the model: the JAX model runs flax GroupNorm and keeps this
kernel for its bench canary (``bench.py:229``); the port's blocks keep
``nn.GroupNorm``, and its bench canary (``betavae_tpu_torch/bench.py``) is
this kernel's path.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from ..device import raw_stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# values summed by one block of the generic path's stats pass
_STATS_CHUNK = 8192
# the cluster path's rule, as csrc/gn.cu states it (cl::cluster_k): two
# CTAs on each SM of the H100 SXM's 132, portable clusters of at most 8
# CTAs, and a CTA's channels within 72 KiB of shared memory (three CTAs to
# an SM) at 24 bytes a channel besides its values
_CLUSTER_CTAS = 2 * 132
_CLUSTER_MAX = 8
_SLICE_BUDGET = 72 * 1024
_PER_CHANNEL = 24


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _stats(x32: torch.Tensor, eps: float):
    """``(m, rstd)`` ``[B]`` of fp32 ``x32`` over each sample."""
    n = x32[0].numel()
    flat = x32.reshape(x32.shape[0], -1)
    m = flat.sum(dim=1) / n
    v = (flat * flat).sum(dim=1) / n - m * m
    return m, torch.rsqrt(torch.clamp_min(v, 0.0) + eps)


def _pre_relu(x32, gamma, beta, m, rstd):
    """``(x̂, z)``, each operation rounded on its own as the kernels do."""
    xhat = (x32 - m[:, None, None, None]) * rstd[:, None, None, None]
    z = xhat * gamma.float()[None, :, None, None] \
        + beta.float()[None, :, None, None]
    return xhat, z


def gn_forward_reference(x, gamma, beta, eps: float = 1e-6):
    """``(y fp32, pooled, m, rstd)``, differentiable in every input."""
    with torch.autocast(x.device.type, enabled=False):
        x32 = x.float()
        m, rstd = _stats(x32, eps)
        _, z = _pre_relu(x32, gamma, beta, m, rstd)
        y = torch.clamp_min(z, 0.0)
        return y, y.mean(dim=(2, 3)), m, rstd


def gn_relu_pool_reference(x, gamma, beta, eps: float = 1e-6):
    """``(y, pooled)`` in fp32: ``reference_gn_relu_pool`` of the JAX
    package."""
    y, pooled, _, _ = gn_forward_reference(x, gamma, beta, eps)
    return y, pooled


def groupnorm_relu_reference(x, gamma, beta, eps: float = 1e-6):
    """fp32 ``relu(GroupNorm₁(x)·γ + β)``: ``reference_groupnorm_relu``."""
    return gn_forward_reference(x, gamma, beta, eps)[0]


def gn_backward_reference(x, gamma, beta, m, rstd, gy, gp):
    """``(dx in x's dtype, dγ [B, C], dβ [B, C])`` from the saved ``m`` and
    ``rstd``, in the kernels' order of operations."""
    with torch.autocast(x.device.type, enabled=False):
        x32 = x.float()
        hw = x.shape[2] * x.shape[3]
        xhat, z = _pre_relu(x32, gamma, beta, m, rstd)
        g = gy.float() + (gp.float() * (1.0 / hw))[:, :, None, None]
        gz = torch.where(z > 0, g, torch.zeros_like(g))
        dbeta = gz.sum(dim=(2, 3))
        dgamma = (gz * xhat).sum(dim=(2, 3))
        dxhat = gz * gamma.float()[None, :, None, None]
        n = x[0].numel()
        mean_dxhat = dxhat.sum(dim=(1, 2, 3)) / n
        mean_dxhat_xhat = (dxhat * xhat).sum(dim=(1, 2, 3)) / n
        dx = rstd[:, None, None, None] * (
            dxhat - mean_dxhat[:, None, None, None]
            - xhat * mean_dxhat_xhat[:, None, None, None])
        return dx.to(x.dtype), dgamma, dbeta


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    lib = _build.load("gn")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.betavae_gn_fwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int]
    lib.betavae_gn_fwd.restype = ctypes.c_int
    lib.betavae_gn_bwd.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int]
    lib.betavae_gn_bwd.restype = ctypes.c_int
    lib.betavae_gn_path.argtypes = [ctypes.c_int] * 5
    lib.betavae_gn_path.restype = ctypes.c_int
    lib.betavae_gn_active_clusters.argtypes = [ctypes.c_int] * 8
    lib.betavae_gn_active_clusters.restype = ctypes.c_int
    return lib


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("GN kernel inputs must share one device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check(x, gamma, beta) -> int:
    """x's dtype code; raises on what the kernels do not take."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"GN kernel takes a non-empty [B, C, H, W] x, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"GN kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    c = x.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"GN kernel takes float32 {name} of shape "
                             f"({c},), got {t.dtype} {tuple(t.shape)}")
    return _DTYPE_CODES[x.dtype]


def stats_splits(sample_values: int) -> int:
    """Blocks per sample of the generic path's stats pass."""
    return max(1, min(65535, math.ceil(sample_values / _STATS_CHUNK)))


def gn_path(shape, dtype: torch.dtype) -> tuple[str, int]:
    """The path the kernels take for x of ``shape`` ``[B, C, H, W]`` and
    ``dtype``: ``("cluster", k)``, one launch per direction with clusters of
    ``k`` CTAs, or ``("generic", splits)``, two launches per direction with
    ``splits`` stats blocks a sample.  ``k`` starts at ``min(8, 264 // B,
    C)``, so that B·k CTAs put two on each of the card's SMs where B
    allows, and is the least from there to ``min(8, C)`` whose largest
    slice, ``ceil(C/k)`` channels, fits the shared-memory budget.
    ``betavae_gn_path`` in ``csrc/gn.cu`` states the same rule."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"GN kernel takes float32 or bfloat16, got {dtype}")
    b, c, h, w = shape
    plane_bytes = h * w * (2 if dtype == torch.bfloat16 else 4)
    k_max = min(_CLUSTER_MAX, c)
    for k in range(min(k_max, max(1, _CLUSTER_CTAS // b)), k_max + 1):
        if -(-c // k) * (plane_bytes + _PER_CHANNEL) <= _SLICE_BUDGET:
            return ("cluster", k)
    return ("generic", stats_splits(c * h * w))


# one dictionary lookup per call; shapes are few
_path_of = functools.lru_cache(maxsize=1024)(gn_path)


def _partial_offset(b: int, c: int) -> int:
    """Where the generic path's stats scratch starts in the forward's fp32
    buffer, after pooled, m and rstd (``partial_offset`` in ``gn.cu``)."""
    return (b * c + 2 * b + 3) // 4 * 4


def _stats_views(buf: torch.Tensor, b: int, c: int):
    """``(pooled [B, C], m [B], rstd [B])``: views of the forward's fp32
    buffer, in the order ``betavae_gn_fwd`` writes them (the generic
    path's stats scratch, if any, after them)."""
    pooled, m, rstd, _ = buf.split_with_sizes(
        (b * c, b, b, buf.numel() - b * c - 2 * b))
    return pooled.view(b, c), m, rstd


def _param_views(buf: torch.Tensor):
    """``(dγ [B, C], dβ [B, C])``: views of the backward's fp32 ``[2, B,
    C]`` buffer, in the order ``betavae_gn_bwd`` writes them."""
    dgamma, dbeta = buf.unbind(0)
    return dgamma, dbeta


def _count(wrapper, kind: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_path[kind] += 1


def _forward_launch(x, gamma, beta, eps: float, code: int, path):
    """The forward kernels on ``path`` (:func:`gn_path`'s form; a cluster
    size above 8 is a non-portable one), for checked CUDA inputs."""
    kind, n = path
    k, splits = (n, 0) if kind == "cluster" else (0, n)
    b, c, h, w = x.shape
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    size = b * c + 2 * b if k else _partial_offset(b, c) + 2 * b * splits
    stats = torch.empty(size, dtype=torch.float32, device=x.device)
    rc = _library().betavae_gn_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        stats.data_ptr(), b, c, h, w, eps, code, k, splits,
        raw_stream(x.device), x.device.index)
    if rc != 0:
        raise RuntimeError(f"GN forward kernel launch ({kind}, {n}) failed "
                           f"with CUDA error {rc}")
    _count(gn_forward, kind)
    return (y, *_stats_views(stats, b, c))


def gn_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6):
    """``(y in x's dtype, pooled fp32 [B, C], m [B], rstd [B])`` without
    autograd: the kernels for CUDA tensors, the plain version for CPU."""
    if _device_of(x, gamma, beta).type == "cpu":
        y, pooled, m, rstd = gn_forward_reference(x, gamma, beta, eps)
        return y.to(x.dtype), pooled, m, rstd
    code = _check(x, gamma, beta)
    return _forward_launch(x, gamma, beta, float(eps), code,
                           _path_of(x.shape, x.dtype))


gn_forward.launches = 0
gn_forward.launches_by_path = {"cluster": 0, "generic": 0}


def _backward_launch(x, gamma, beta, m, rstd, gy, gp, code: int, path):
    """The backward kernels on ``path``, for checked CUDA inputs."""
    kind, n = path
    k = n if kind == "cluster" else 0
    b, c, h, w = x.shape
    x, gy, gp = x.contiguous(), gy.contiguous(), gp.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    m, rstd = m.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x)
    dparams = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    rc = _library().betavae_gn_bwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), m.data_ptr(),
        rstd.data_ptr(), gy.data_ptr(), gp.data_ptr(), dx.data_ptr(),
        dparams.data_ptr(), b, c, h, w, code, k, raw_stream(x.device),
        x.device.index)
    if rc != 0:
        raise RuntimeError(f"GN backward kernel launch ({kind}, {n}) failed "
                           f"with CUDA error {rc}")
    _count(gn_backward, kind)
    return (dx, *_param_views(dparams))


def gn_backward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                m: torch.Tensor, rstd: torch.Tensor, gy: torch.Tensor,
                gp: torch.Tensor):
    """``(dx in x's dtype, dγ [B, C], dβ [B, C])`` per sample, without
    autograd: the kernels for CUDA tensors, the plain version for CPU."""
    if _device_of(x, gamma, beta, m, rstd, gy, gp).type == "cpu":
        return gn_backward_reference(x, gamma, beta, m, rstd, gy, gp)
    code = _check(x, gamma, beta)
    b, c, h, w = x.shape
    if gy.shape != x.shape or gy.dtype != x.dtype:
        raise ValueError(f"GN backward takes gy like x {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(gy.shape)} {gy.dtype}")
    if gp.shape != (b, c) or m.shape != (b,) or rstd.shape != (b,) or any(
            t.dtype != torch.float32 for t in (gp, m, rstd)):
        raise ValueError("GN backward takes float32 gp [B, C], m and rstd [B]")
    return _backward_launch(x, gamma, beta, m, rstd, gy, gp, code,
                            _path_of(x.shape, x.dtype))


gn_backward.launches = 0
gn_backward.launches_by_path = {"cluster": 0, "generic": 0}


def _active_clusters(shape, dtype: torch.dtype, k: int, backward: bool,
                     device: torch.device) -> int:
    """Clusters of ``k`` CTAs of the forward or backward cluster kernel the
    card holds at once for ``shape`` (``cudaOccupancyMaxActiveClusters``);
    raises where the query fails."""
    b, c, h, w = shape
    n = _library().betavae_gn_active_clusters(
        b, c, h, w, _DTYPE_CODES[dtype], k, int(backward), device.index or 0)
    if n < 0:
        raise RuntimeError(f"GN cluster occupancy query failed with CUDA "
                           f"error {-n}")
    return n


class _FusedGNReLUPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, pooled, m, rstd = gn_forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, beta, m, rstd)
        return y, pooled

    @staticmethod
    def backward(ctx, gy, gp):
        x, gamma, beta, m, rstd = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        if gp is None:
            gp = torch.zeros(x.shape[:2], dtype=torch.float32,
                             device=x.device)
        dx, dgamma, dbeta = gn_backward(x, gamma, beta, m, rstd,
                                        gy.to(x.dtype), gp.float())
        return (dx, dgamma.sum(dim=0).to(gamma.dtype),
                dbeta.sum(dim=0).to(beta.dtype), None)


def fused_gn_relu_pool(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-6):
    """``(y, pooled)``: ``relu(GroupNorm₁(x)·γ + β)`` in x's dtype and its
    fp32 per-channel H·W mean, differentiable in x, γ and β through both
    outputs."""
    return _FusedGNReLUPool.apply(x, gamma, beta, float(eps))


def fused_groupnorm_relu(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float = 1e-6):
    """``relu(GroupNorm₁(x)·γ + β)`` in x's dtype; the pool is dropped."""
    return fused_gn_relu_pool(x, gamma, beta, eps)[0]
