"""Batch reductions over a data-parallel group.

Under the JAX package's mesh every batch reduction is over the global
batch, because the step is one program over the sharded batch.  Here each
rank holds its rows, so a reduction is a local sum followed by
:func:`global_sum`, an all-reduce SUM that autograd differentiates: its
backward all-reduces the incoming gradient.  When every rank computes the
same loss ``L = f(Σ_r s_r)`` and runs ``backward()``, rank ``r`` receives
``W · f′(S) · ∂s_r/∂θ``, and ``DistributedDataParallel``'s mean over the
``W`` ranks gives exactly the single-process gradient.  That holds only if
every term of the loss reaches it through :func:`global_sum`: a purely
local term would come out divided by ``W``.

With ``group=None`` every function is the single-process identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _GlobalSum.apply(grad, ctx.group), None


def global_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``Σ_r t_r`` over the ranks of ``group``, identical on every rank and
    differentiable; ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    return _GlobalSum.apply(t, group)


def world_size(group=None) -> int:
    """The number of ranks of ``group``: 1 when it is None."""
    return 1 if group is None else dist.get_world_size(group)


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in rank order (all-gather,
    no gradient): rank ``r``'s rows ``[r·b, (r+1)·b)`` of the global batch
    back in place.  ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)
