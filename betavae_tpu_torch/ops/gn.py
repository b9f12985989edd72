"""GroupNorm with one group → ReLU → per-channel spatial mean: the CUDA
kernels and their plain PyTorch versions.

Counterpart of ``betavae_tpu/ops/pallas_gn.py::fused_gn_relu_pool``: every
block of the flagship ends GroupNorm(1) → ReLU → SE, and the SE squeeze is
the per-channel mean of the ReLU output.  Per sample, over all C·H·W
values, in fp32::

    m, v = the sample's mean and variance ;  rstd = rsqrt(v + eps)
    a = rstd·γ ;  z = a·x + (β − a·m) ;  y = max(z, 0)
    pooled[b, c] = mean_hw(rd(y))

and backward, given ``gy`` and ``gp`` (the gradients of ``y`` and
``pooled``)::

    gz = rd(gy + rd(gp/HW))·1[z > 0] ;  x̂ = (x − m)·rstd
    dβ[b,c] = Σ_hw gz ;  dγ[b,c] = Σ_hw gz·x̂
    dx̂ = gz·γ ;  dx = rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂))

with the per-sample ``dγ``/``dβ`` summed over B outside the kernel, as
``pallas_gn.py:192-197`` does.  ``rd`` rounds to x's dtype (a no-op in
fp32): the squeeze is the mean of ``y`` as the block passes it on, and the
gradient of ``y`` is its two parts (the second the mean's backward in
``y``'s dtype) summed in ``y``'s dtype, as autograd gives them in a bf16
model.  So a bf16 block gives what the JAX model's flax blocks (GroupNorm,
then the SE block's mean of the bf16 activations) and PyTorch's GroupNorm
under autocast give, to their statistics' rounding; the Pallas kernel
pools the fp32 ``y``.  The kernels' m, v and z are PyTorch's GroupNorm's
on the card, bit for bit (its Welford chains and their merge order, and
its rounding of z; ``csrc/gn.cu``), where the JAX kernel takes v = Σx²/n
− m² and z = x̂·γ + β: so a block's forward gives ``nn.GroupNorm``'s bits
under autocast, which the benchmark's reference runs.  The plain versions
take m and v in float64.  Layout is the port's: ``x`` NCHW ``[B, C, H,
W]`` in bf16 or fp32, ``γ``/``β`` fp32 ``[C]``; ``y`` comes back in x's
dtype, ``pooled`` fp32 ``[B, C]``.

Two kernel launchers (``csrc/gn.cu``, whose header gives their bound on an
H100 and their design): :func:`gn_forward`, at every shape the statistics
pass and an apply pass (the ``"generic"`` path), and :func:`gn_backward`,
on one of two paths by :func:`gn_path` (shape and dtype alone):
``"cluster"``, one launch with one thread-block cluster of ``k`` CTAs per
sample holding the sample in shared memory (every sample within the
budget: the flagship's block shapes but its largest, and the bench
canary's), or ``"generic"``, a sums pass and a dx pass.  Each launches
its kernels for CUDA tensors and takes the plain version only for CPU
tensors; ``.launches`` counts the calls that launch kernels,
``.launches_by_path`` counts them by path, and ``.kernels_by_path`` is the
kernels a call launches on each path, which a captured graph's replays
count as ``gn.<path>_launches`` (``train/chunks.py``).  The plain versions
round ``z`` as the kernels do, so that given the same ``m`` and ``rstd``
the two agree on every ReLU mask bit.

Every block of the model whose norm is ``layer`` and whose activation is
``relu`` runs :func:`fused_gn_relu_pool` on its conv output
(``models/beta_vae.py::_norm_act``), and its SE block takes ``pooled`` as
its squeeze: every encoder and decoder block of the shipped configs, in
training, validation, evaluation and inference, under remat's recompute
too.  The JAX model runs flax GroupNorm there and keeps its kernel for its
bench canary (``bench.py:229``); the port's bench canary
(``betavae_tpu_torch/bench.py``) runs this kernel too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..device import raw_stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the statistics pass's Welford slots a sample, 3 floats each (kSlots in
# csrc/gn.cu)
_SLOTS = 16
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
    """``(m, rstd)`` ``[B]`` of fp32 ``x32`` over each sample: the mean and
    variance in float64, rounded to fp32 (the kernels' Welford chains give
    them to fp32's last bits)."""
    var, m = torch.var_mean(x32.reshape(x32.shape[0], -1).double(), dim=1,
                            correction=0)
    return m.float(), torch.rsqrt(var.float() + eps)


def _pre_relu(x32, gamma, beta, m, rstd):
    """``(x̂, z)`` as the kernels round them: ``x̂ = (x − m)·rstd``; ``a =
    rstd·γ`` and ``b = −a·m + β`` each rounded, then ``z = a·x + b`` with
    one rounding (float64 holds the product exactly)."""
    xhat = (x32 - m[:, None, None, None]) * rstd[:, None, None, None]
    a = rstd[:, None] * gamma.float()[None, :]
    b = -a * m[:, None] + beta.float()[None, :]
    z = (a.double()[:, :, None, None] * x32.double()
         + b.double()[:, :, None, None]).float()
    return xhat, z


def gn_forward_reference(x, gamma, beta, eps: float = 1e-6):
    """``(y fp32, pooled, m, rstd)``, differentiable in every input;
    ``pooled`` the mean of ``y`` rounded to x's dtype."""
    with torch.autocast(x.device.type, enabled=False):
        x32 = x.float()
        m, rstd = _stats(x32, eps)
        _, z = _pre_relu(x32, gamma, beta, m, rstd)
        y = torch.clamp_min(z, 0.0)
        return y, y.to(x.dtype).float().mean(dim=(2, 3)), m, rstd


def gn_relu_pool_reference(x, gamma, beta, eps: float = 1e-6):
    """``(y, pooled)`` in fp32: ``reference_gn_relu_pool`` of the JAX
    package for fp32 x (for bf16 x, ``pooled`` is the mean of the bf16
    ``y``)."""
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
        gp_hw = (gp.float() * (1.0 / hw)).to(x.dtype).float()
        g = (gy.float() + gp_hw[:, :, None, None]).to(x.dtype).float()
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
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int]
    lib.betavae_gn_fwd.restype = ctypes.c_int
    lib.betavae_gn_bwd.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int]
    lib.betavae_gn_bwd.restype = ctypes.c_int
    lib.betavae_gn_path.argtypes = [ctypes.c_int] * 5
    lib.betavae_gn_path.restype = ctypes.c_int
    lib.betavae_gn_active_clusters.argtypes = [ctypes.c_int] * 7
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


def gn_path(shape, dtype: torch.dtype) -> tuple[str, int]:
    """The path the backward kernels take for x of ``shape`` ``[B, C, H,
    W]`` and ``dtype`` (the forward's is always generic): ``("cluster",
    k)``, one launch with clusters of ``k`` CTAs, or ``("generic", 0)``, two
    launches.  ``k`` starts at ``min(8, 264 // B, C)``, so that B·k CTAs
    put two on each of the card's SMs where B allows, and is the least
    from there to ``min(8, C)`` whose largest slice, ``ceil(C/k)``
    channels, fits the shared-memory budget.
    ``betavae_gn_path`` in ``csrc/gn.cu`` states the same rule."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"GN kernel takes float32 or bfloat16, got {dtype}")
    b, c, h, w = shape
    plane_bytes = h * w * (2 if dtype == torch.bfloat16 else 4)
    k_max = min(_CLUSTER_MAX, c)
    for k in range(min(k_max, max(1, _CLUSTER_CTAS // b)), k_max + 1):
        if -(-c // k) * (plane_bytes + _PER_CHANNEL) <= _SLICE_BUDGET:
            return ("cluster", k)
    return ("generic", 0)


# one dictionary lookup per call; shapes are few
_path_of = functools.lru_cache(maxsize=1024)(gn_path)


def _partial_offset(b: int, c: int) -> int:
    """Where the statistics pass's Welford slots start in the forward's
    fp32 buffer, after pooled, m and rstd (``partial_offset`` in
    ``gn.cu``)."""
    return (b * c + 2 * b + 3) // 4 * 4


def _stats_views(buf: torch.Tensor, b: int, c: int):
    """``(pooled [B, C], m [B], rstd [B])``: views of the forward's fp32
    buffer, in the order ``betavae_gn_fwd`` writes them (the statistics
    pass's slots, if any, after them)."""
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


def _forward_launch(x, gamma, beta, eps: float, code: int):
    """The forward kernels, for checked CUDA inputs."""
    b, c, h, w = x.shape
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    stats = torch.empty(_partial_offset(b, c) + 3 * _SLOTS * b,
                        dtype=torch.float32, device=x.device)
    rc = _library().betavae_gn_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        stats.data_ptr(), b, c, h, w, eps, code, raw_stream(x.device),
        x.device.index)
    if rc != 0:
        raise RuntimeError(f"GN forward kernel launch failed with CUDA "
                           f"error {rc}")
    _count(gn_forward, "generic")
    return (y, *_stats_views(stats, b, c))


def gn_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6):
    """``(y in x's dtype, pooled fp32 [B, C], m [B], rstd [B])`` without
    autograd: the kernels for CUDA tensors, the plain version for CPU."""
    if _device_of(x, gamma, beta).type == "cpu":
        y, pooled, m, rstd = gn_forward_reference(x, gamma, beta, eps)
        return y.to(x.dtype), pooled, m, rstd
    code = _check(x, gamma, beta)
    return _forward_launch(x, gamma, beta, float(eps), code)


gn_forward.launches = 0
gn_forward.launches_by_path = {"generic": 0}
gn_forward.kernels_by_path = {"generic": 2}


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
gn_backward.kernels_by_path = {"cluster": 1, "generic": 2}


def _active_clusters(shape, dtype: torch.dtype, k: int,
                     device: torch.device) -> int:
    """Clusters of ``k`` CTAs of the backward's cluster kernel the card
    holds at once for ``shape`` (``cudaOccupancyMaxActiveClusters``);
    raises where the query fails."""
    b, c, h, w = shape
    n = _library().betavae_gn_active_clusters(
        b, c, h, w, _DTYPE_CODES[dtype], k, device.index or 0)
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
