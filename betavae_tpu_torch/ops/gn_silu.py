"""GroupNorm(G) → swish in x's dtype, forward and backward: the CUDA
kernels and their plain PyTorch versions.

Every norm of the kl-f8 autoencoder (``models/autoencoder_kl.py``): the
50 a swish follows and, with ``swish=False``, the 2 of its attention
blocks.  The port ran ``F.silu(nn.GroupNorm(x.float()).to(x.dtype))``
under autocast there, an fp32 GroupNorm between two casts and a separate
``silu``; the op takes x as given (a custom ``autograd.Function`` is
outside autocast's casting) and gives the same function in x's dtype.
Per (sample, group) row of ``(C/G)·H·W`` values, in fp32::

    m, var = the row's mean and centred variance ;  rstd = rsqrt(var + eps)
    a = rstd·γ_c ;  b = fma(−a, m, β_c) ;  z = rd(fma(x, a, b))
    y = rd(z·σ(z)) with the swish (PyTorch's silu, z / (1 + exp(−z))), else z

and backward, given ``dy``::

    dz = rd(silu_backward(dy, z)) with the swish, else dy
    x̂ = (x − m)·rstd ;  dβ = Σ dz ;  dγ = Σ dz·x̂   (per channel, over B·H·W)
    dx = rd(rstd·(dz·γ_c − mean(dz·γ) − x̂·mean(dz·γ·x̂)))   (means over the row)

``rd`` rounds to x's dtype, as the library composition rounds at its casts
and its bf16 ``silu``; dz as autograd's bf16 ``silu`` backward gives it.
The kernels' forward is the composition's on the card, bit for bit: m and
rstd are ``nn.GroupNorm``'s (its Welford chains and their merge order), a
and b rounded as its CUDA kernels round them (``b = −a·m + β``, two
roundings).  The plain version rounds ``b`` as its CPU kernel does (one
fused multiply-add) and takes m and rstd in float64: given ``nn.GroupNorm``'s
statistics its forward is the composition's on the CPU, bit for bit.

Two launchers (``csrc/gn_silu.cu``, whose header gives their bound on an
H100 and their design): :func:`gn_silu_forward`, at every shape the
statistics pass and an apply pass (the ``"generic"`` path), and
:func:`gn_silu_backward`, on one of two paths by :func:`gn_silu_path`
(shape and dtype alone): ``"cluster"``, one launch with one thread-block
cluster of ``k`` CTAs a row holding the row's x in shared memory, or
``"generic"``, a sums pass and a dx pass; either adds one launch that sums
dγ and dβ over the batch.  Each launches its kernels for CUDA tensors
and takes the plain version only for CPU tensors; ``.launches`` counts the
calls that launch kernels, ``.launches_by_path`` counts them by path, and
``.kernels_by_path`` is the kernels a call launches on each path, which a
captured graph's replays count as ``gn_silu.<path>_launches``
(``train/chunks.py``).  :func:`gn_silu` counts every call it takes, on any
device, in ``gn_silu.calls`` by ``"swish"`` and ``"norm"``.

Saved for the backward: x in its own dtype and the fp32 ``[B, G]`` mean and
rstd; γ and β are the module's parameters, held by reference.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build
from ..device import raw_stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's path rule (_plan); csrc/gn_silu.cu checks the plan against
# its own limits (the span's shared memory, the channels a span meets)
_THREADS = 512
_GENERIC_SPAN = _THREADS * 4
_MAX_CLUSTER = 8
_TARGET_CTAS = 2 * 132
_PAIR_BUDGET = 96 * 1024
_SOLO_BUDGET = 208 * 1024
_MAX_Q = 32
_MAX_ROWS = 65535


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _per_channel(t: torch.Tensor, channels: int) -> torch.Tensor:
    """``[B, G]`` → ``[B, C, 1, 1]``, each group's value on its channels."""
    b, g = t.shape
    return t.repeat_interleave(channels // g, dim=1).reshape(b, channels, 1, 1)


def _z(x32, gamma, beta, m, rstd):
    """``(x̂, z)`` in fp32 as ``nn.GroupNorm`` applies the statistics on the
    CPU: ``a = rstd·γ`` rounded, ``b = fma(−a, m, β)`` and ``z = fma(x, a,
    b)`` (float64 holds each product exactly)."""
    c = x32.shape[1]
    mc, rc = _per_channel(m, c), _per_channel(rstd, c)
    g = gamma.float().reshape(1, c, 1, 1)
    a = rc * g
    b = (-a.double() * mc.double() + beta.float().reshape(1, c, 1, 1)
         .double()).float()
    z = (x32.double() * a.double() + b.double()).float()
    return (x32 - mc) * rc, z


def gn_silu_stats_reference(x: torch.Tensor, groups: int, eps: float = 1e-6):
    """``(m, rstd)`` ``[B, G]`` fp32: the mean and variance in float64,
    rounded to fp32."""
    var, m = torch.var_mean(
        x.float().reshape(x.shape[0], groups, -1).double(), dim=2,
        correction=0)
    return m.float(), torch.rsqrt(var.float() + eps)


def gn_silu_reference(x, gamma, beta, groups: int, eps: float = 1e-6,
                      swish: bool = True, stats=None):
    """``(y in x's dtype, m, rstd)``; ``stats`` ``(m, rstd)`` in place of
    the row's own (:func:`gn_silu_stats_reference`)."""
    with torch.autocast(x.device.type, enabled=False):
        m, rstd = stats if stats is not None else gn_silu_stats_reference(
            x, groups, eps)
        _, z = _z(x.float(), gamma, beta, m, rstd)
        z = z.to(x.dtype)
        return (F.silu(z) if swish else z), m, rstd


def gn_silu_backward_reference(x, gamma, beta, m, rstd, dy, groups: int,
                               swish: bool = True):
    """``(dx in x's dtype, dγ [C], dβ [C])`` from the saved ``m`` and
    ``rstd``."""
    with torch.autocast(x.device.type, enabled=False):
        x32 = x.float()
        b, c = x.shape[:2]
        xhat, z = _z(x32, gamma, beta, m, rstd)
        dz = (torch.ops.aten.silu_backward(dy, z.to(x.dtype)) if swish
              else dy).float()
        dxhat = dz * gamma.float().reshape(1, c, 1, 1)
        rows = (b, groups, -1)
        n = x[0].numel() // groups
        mean_dxhat = dxhat.reshape(rows).sum(dim=2) / n
        mean_dxhat_xhat = (dxhat * xhat).reshape(rows).sum(dim=2) / n
        dx = _per_channel(rstd, c) * (
            dxhat - _per_channel(mean_dxhat, c)
            - xhat * _per_channel(mean_dxhat_xhat, c))
        return (dx.to(x.dtype), (dz * xhat).sum(dim=(0, 2, 3)),
                dz.sum(dim=(0, 2, 3)))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    lib = _build.load("gn_silu")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.betavae_gn_silu_fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p, ctypes.c_int]
    lib.betavae_gn_silu_fwd.restype = ctypes.c_int
    lib.betavae_gn_silu_bwd.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p,
                                                   ctypes.c_int]
    lib.betavae_gn_silu_bwd.restype = ctypes.c_int
    lib.betavae_gn_silu_work.argtypes = [ctypes.c_int] * 7
    lib.betavae_gn_silu_work.restype = ctypes.c_longlong
    return lib


def _check(x, gamma, beta, groups: int) -> int:
    """x's dtype code; raises on what the kernels do not take."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"gn_silu takes a non-empty [B, C, H, W] x, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"gn_silu takes float32 or bfloat16 x, got {x.dtype}")
    b, c, h, w = x.shape
    if groups < 1 or c % groups:
        raise ValueError(f"gn_silu takes G dividing C = {c}, got {groups}")
    if b * groups > _MAX_ROWS or (c // groups) * h * w >= 2 ** 31:
        raise ValueError(f"gn_silu takes at most {_MAX_ROWS} rows of under "
                         f"2^31 values, got {b}·{groups} of "
                         f"{(c // groups) * h * w}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"gn_silu takes float32 {name} of shape ({c},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if len({x.device, gamma.device, beta.device}) != 1:
        raise ValueError("gn_silu's inputs must share one device")
    return _DTYPE_CODES[x.dtype]


@functools.lru_cache(maxsize=1024)
def _plan(shape, groups: int, dtype: torch.dtype) -> tuple[int, int]:
    """``(k, span)``: the backward's cluster CTAs a row (0: the generic
    path) and the 16-byte units (or values) a CTA takes.  The one statement
    of the rule: the library runs the plan it is given, after checking that
    its kernels can (``make_plan`` in ``csrc/gn_silu.cu``), and the CPU
    tests read the rule without a build."""
    b, c, h, w = shape
    hw, cpg, rows = h * w, c // groups, b * groups
    per16 = 16 // (2 if dtype == torch.bfloat16 else 4)
    p = per16 if hw % per16 == 0 else 1
    v = hw // p
    n = cpg * v
    if p > 1 and v % 32 == 0:
        k0 = min(_MAX_CLUSTER, max(1, -(-_TARGET_CTAS // rows)))
        for budget in (_PAIR_BUDGET, _SOLO_BUDGET):
            for k in range(k0, _MAX_CLUSTER + 1):
                per = -(-n // k)
                span = -(-per // 32) * 32
                q = min(cpg, (span - 1) // v + 2)
                if span * 16 <= budget and q <= _MAX_Q:
                    return k, span
    return 0, _GENERIC_SPAN


@functools.lru_cache(maxsize=1024)
def gn_silu_path(shape, groups: int, dtype: torch.dtype) -> tuple[str, int]:
    """The path the backward kernels take for x of ``shape`` ``[B, C, H,
    W]`` in ``groups`` groups and ``dtype`` (the forward's is always
    generic): ``("cluster", k)``, one launch with clusters of ``k`` CTAs a
    row, or ``("generic", 0)``, two.  The cluster path takes rows of
    16-byte units whose channels hold a multiple of 32 of them; ``k``
    starts at ``min(8, ⌈264 / rows⌉)``, and is the least from there to 8
    whose span, ``⌈units / k⌉`` rounded up to 32 units, fits 96 KiB of
    shared memory (two CTAs an SM), else 208 KiB (one), and meets at most
    32 channels."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"gn_silu takes float32 or bfloat16, got {dtype}")
    k = _plan(tuple(shape), groups, dtype)[0]
    return ("cluster", k) if k else ("generic", 0)


@functools.lru_cache(maxsize=1024)
def _work_floats(shape, groups: int, dtype: torch.dtype) -> int:
    """fp32 scratch the backward takes on ``_plan``'s path, as the library
    counts it (per-channel partials of each span and, on the generic path,
    each span's two sums)."""
    b, c, h, w = shape
    n = _library().betavae_gn_silu_work(b, c, h * w, groups,
                                        _DTYPE_CODES[dtype],
                                        *_plan(shape, groups, dtype))
    if n < 0:
        raise ValueError(f"gn_silu: the library refuses the plan "
                         f"{_plan(shape, groups, dtype)} for {tuple(shape)} "
                         f"in {groups} groups, {dtype}")
    return n


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a view's offset can leave it
    unaligned; the kernels read 16 bytes a thread)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(wrapper, kind: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_path[kind] += 1


def gn_silu_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int, eps: float = 1e-6, swish: bool = True):
    """``(y in x's dtype, m [B, G], rstd [B, G])`` without autograd: the
    kernels for CUDA tensors, the plain version for CPU."""
    code = _check(x, gamma, beta, groups)
    if x.device.type == "cpu":
        return gn_silu_reference(x, gamma, beta, groups, eps, swish)
    b, c, h, w = x.shape
    x = _aligned(x)
    y = torch.empty_like(x)
    m = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rc = _library().betavae_gn_silu_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        m.data_ptr(), rstd.data_ptr(), b, c, h * w, groups, float(eps), code,
        int(swish), raw_stream(x.device), x.device.index)
    if rc != 0:
        raise RuntimeError(f"gn_silu forward kernel launch failed with CUDA "
                           f"error {rc}")
    _count(gn_silu_forward, "generic")
    return y, m, rstd


gn_silu_forward.launches = 0
gn_silu_forward.launches_by_path = {"generic": 0}
gn_silu_forward.kernels_by_path = {"generic": 2}


def gn_silu_backward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     m: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor,
                     groups: int, swish: bool = True):
    """``(dx in x's dtype, dγ [C], dβ [C])`` without autograd: the kernels
    for CUDA tensors, the plain version for CPU."""
    code = _check(x, gamma, beta, groups)
    b, c, h, w = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"gn_silu backward takes dy like x {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if any(t.shape != (b, groups) or t.dtype != torch.float32
           or t.device != x.device for t in (m, rstd)):
        raise ValueError(f"gn_silu backward takes float32 m and rstd "
                         f"[{b}, {groups}]")
    if x.device.type == "cpu":
        return gn_silu_backward_reference(x, gamma, beta, m, rstd, dy, groups,
                                          swish)
    k, span = _plan(tuple(x.shape), groups, x.dtype)
    kind = "cluster" if k else "generic"
    x, dy = _aligned(x), _aligned(dy)
    m, rstd = m.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    n = _work_floats(tuple(x.shape), groups, x.dtype)
    work = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = _library().betavae_gn_silu_bwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), m.data_ptr(),
        rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), work.data_ptr(), n, b, c, h * w, groups, code,
        int(swish), k, span, raw_stream(x.device), x.device.index)
    if rc != 0:
        raise RuntimeError(f"gn_silu backward kernel launch ({kind}, {k}) "
                           f"failed with CUDA error {rc}")
    _count(gn_silu_backward, kind)
    return dx, dgamma, dbeta


gn_silu_backward.launches = 0
gn_silu_backward.launches_by_path = {"cluster": 0, "generic": 0}
gn_silu_backward.kernels_by_path = {"cluster": 2, "generic": 3}


class _GNSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, swish):
        y, m, rstd = gn_silu_forward(x, gamma, beta, groups, eps, swish)
        ctx.save_for_backward(x, m, rstd)
        ctx.params, ctx.groups, ctx.swish = (gamma, beta), groups, swish
        return y

    @staticmethod
    def backward(ctx, dy):
        x, m, rstd = ctx.saved_tensors
        gamma, beta = ctx.params
        dx, dgamma, dbeta = gn_silu_backward(x, gamma, beta, m, rstd,
                                             dy.to(x.dtype), ctx.groups,
                                             ctx.swish)
        return dx, dgamma, dbeta, None, None, None


def gn_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            groups: int, eps: float = 1e-6, swish: bool = True):
    """``swish(GroupNorm_G(x)·γ + β)`` (without ``swish``: the norm alone)
    in x's dtype, differentiable in x, γ and β."""
    gn_silu.calls["swish" if swish else "norm"] += 1
    return _GNSiLU.apply(x, gamma, beta, int(groups), float(eps), bool(swish))


gn_silu.calls = {"swish": 0, "norm": 0}
