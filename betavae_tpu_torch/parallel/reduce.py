"""Batch reductions over a data-parallel group.

Under the JAX package's mesh every batch reduction is over the global
batch, because the step is one program over the sharded batch.  Here each
rank holds its rows, so a reduction is a local sum followed by
:func:`global_sum`, an all-reduce SUM that autograd differentiates: its
backward all-reduces the incoming gradient.  When every rank computes the
same loss ``L = f(Σ_r s_r)`` and runs ``backward()``, rank ``r`` receives
``W · f′(S) · ∂s_r/∂θ``, and the mean over the ``W`` ranks
(:func:`mean_over_ranks_`: one all-reduce SUM of the flat gradient buffer,
then the division by ``W``) gives exactly the single-process gradient.
That holds only if every term of the loss reaches it through
:func:`global_sum`: a purely local term would come out divided by ``W``.
Every collective here is a device kernel under NCCL, which a CUDA graph
captures; under gloo it is a host call, which none can.  Each first
fences the run's threaded queue of device work on the thread that
submitted to it (:func:`..device.fence_device_queues`), so that it comes
after the collectives the queued jobs issue, as NCCL requires.

With ``group=None`` every function is the single-process identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import fence_device_queues


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        fence_device_queues()
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


def mean_over_ranks_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` replaced, in place, by its mean over the ranks of ``group``:
    one all-reduce SUM, then the division by ``W``.  For ``W`` a power of
    two the division is exact, so this is bitwise the mean
    ``DistributedDataParallel`` forms by dividing first."""
    fence_device_queues()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(world_size(group))


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
    fence_device_queues()
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)
