"""One training step: gather → augment → encode → fused reparam+KL → decode
→ loss → backward → clip → update; and one validation batch.

Counterpart of the step body in ``betavae_tpu/train/loop.py``
(``_build_step_fn``, ``_forward_with_loss``, ``_scalar_metrics``,
``make_eval_multi_step``).  Where the JAX step is one jitted program over
immutable state, this one updates the model and optimizer in place and
returns the step's scalar metrics as device tensors, so nothing waits for
the card until a caller reads them.

Every random draw of step ``n`` is a function of ``(seed, n)``, as the
JAX step's key ``fold_in(root_key, n)`` is: the noise is the kernel's
Philox stream at ``(seed, n)`` and the augmentation's generator is seeded
from ``(seed, n)``, its uniforms drawn ahead of the step
(:func:`draw_step_augment`), so a resumed run replays the uninterrupted
one.

With a data mesh (:mod:`..parallel.mesh`) each rank runs the step on its
rows of the global batch and computes what the single process computes:
its augmentation draws and its ε are its rows of the whole batch's (the
kernel's counter starts at the rank's first row), every batch reduction of
the loss and the metrics is over the group (:mod:`..parallel.reduce`), and
after ``backward()`` the gradients, views of one flat buffer, are averaged
over the ranks by one all-reduce, which gives the single-process gradient;
the clip and the update follow the sync, identically on every rank.  The
step is one path, eager and captured in a CUDA graph (NCCL's collectives
run inside the graph).
"""

from __future__ import annotations

import torch

from ..data.augment import apply_augment, draw_augment
from ..data.pipeline import gather_batch
from ..models.beta_vae import BetaVAEModule, FlaxBatchNorm2d
from ..models.losses import LossSpec, compute_loss
from ..ops.elbo import fused_reparam_kl
from ..ops.reparam import reparameterize_and_kl
from ..parallel.reduce import global_sum, mean_over_ranks_
from .optim import OptimizerChain


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                group=None) -> torch.Tensor:
    msum = torch.clamp_min(global_sum(mask.sum(), group), 1.0)
    return global_sum((x.mean(dim=tuple(range(1, x.ndim))) * mask).sum(),
                      group) / msum


def masked_std(x: torch.Tensor, mask: torch.Tensor,
               group=None) -> torch.Tensor:
    """Unbiased std over the masked rows (``Tensor.std()`` semantics)."""
    d = x.shape[1] if x.ndim > 1 else 1
    n = torch.clamp_min(global_sum(mask.sum(), group) * d, 2.0)
    m = mask[:, None] if x.ndim > 1 else mask
    mean = global_sum((x * m).sum(), group) / n
    return torch.sqrt(global_sum((((x - mean) ** 2) * m).sum(), group)
                      / (n - 1.0))


def scalar_metrics(losses: dict, mask: torch.Tensor, group=None) -> dict:
    return {
        "total": losses["total"].detach(),
        "recon": losses["recon"].detach(),
        "recon_base": losses["recon_base"].detach(),
        "recon_lpips": losses["recon_lpips"].detach(),
        "recon_ffl": losses["recon_ffl"].detach(),
        "kl_mean": losses["kl_mean"].detach(),
        "kl_effective": losses["kl_effective"].detach(),
        "kl_per_dim_mean": losses["kl_per_dim"].detach().mean(),
        "mu_mean_batch": masked_mean(losses["mu"].detach(), mask, group),
        "z_std_batch": masked_std(losses["z"].detach(), mask, group),
    }


def augment_seed(seed: int, step_index: int) -> int:
    """The augmentation generator's seed for step ``step_index``: a
    63-bit mix of the pair, as ``BatchPlan`` mixes (seed, epoch)."""
    return (int(seed) * 1_000_003 + int(step_index)) & (2**63 - 1)


def _forward_losses(model, x, mask, sched: dict, *, spec: LossSpec,
                    use_capacity: bool, seed: int, offset,
                    lpips_fn=None, row0: int = 0, group=None) -> dict:
    """The loss of ``x``, which is rows ``row0…`` of the batch whose noise
    the step draws, and of ``group``'s batch when ``group`` is given."""
    mu, logvar = model.encode(x)
    if spec.deterministic:
        z, kl_elem = reparameterize_and_kl(mu, logvar, deterministic=True)
    else:
        z, kl_elem = fused_reparam_kl(mu, logvar, seed, offset,
                                      row0 * mu.shape[1])
    recon = model.decode(z)
    return compute_loss(
        (recon, mu, logvar, z, kl_elem), x, spec=spec, beta=sched["beta"],
        capacity=sched["capacity"] if use_capacity else None,
        capacity_weight=sched["capacity_weight"] if use_capacity else None,
        free_bits=sched["free_bits"], mask=mask, lpips_fn=lpips_fn,
        group=group)


def _join_mesh(model: BetaVAEModule, mesh) -> None:
    """Point ``model``'s BatchNorms at ``mesh``'s group, so that their
    batch statistics are the global batch's."""
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.group = mesh.group


def _rows(mesh, local_batch: int):
    """``(rows, global batch)`` of a rank holding ``local_batch`` rows;
    ``(None, local_batch)`` without a mesh."""
    if mesh is None:
        return None, local_batch
    batch = local_batch * mesh.world
    return mesh.rows(batch), batch


def make_train_step(model: BetaVAEModule, optimizer: OptimizerChain,
                    spec: LossSpec, *, aug_kwargs: dict, use_capacity: bool,
                    seed: int, lpips_fn=None, mesh=None):
    """Build ``step(images, idx, mask, sched, step_index, draws) ->
    metrics``.

    ``images`` is the device-resident uint8 split, ``idx`` (B,) int64 and
    ``mask`` (B,) float tensors on the same device, ``sched`` the values
    ``{beta, capacity, capacity_weight, free_bits, lr}``.  The noise of step
    ``step_index`` is the kernel's Philox stream at ``(seed, step_index)``;
    ``draws`` are its augmentation's ``[3, B]`` uniforms, which
    :func:`draw_step_augment` draws from a generator seeded from the same
    pair.

    A captured step (``train/chunks.py``) reads no host value: it passes
    ``sched`` as 0-d fp32 tensors and ``step_index`` as a 0-d int64 tensor
    on the device.  Floats and an int compute bitwise the same step.
    ``lpips_fn`` is the perceptual distance the loss adds when the spec
    turns LPIPS on (:func:`..ops.lpips.build_lpips_fn`).

    With a ``mesh`` (:func:`..parallel.mesh.data_parallel_mesh`), ``idx``
    and ``mask`` are this rank's rows of the global batch, the metrics are
    the global batch's, and the gradients are views of one flat buffer
    (:meth:`.optim.OptimizerChain.flatten_grads`) that one all-reduce
    averages over the ranks after ``backward()``
    (:func:`..parallel.reduce.mean_over_ranks_`).  Under
    ``model.deterministic_overfit`` ``fc_logvar`` gets no gradient: its
    view stays zero, and the update moves it as the single process's does.
    """
    group = None if mesh is None else mesh.group
    if mesh is not None:
        _join_mesh(model, mesh)
        optimizer.flatten_grads()
    loss_kwargs = dict(spec=spec, use_capacity=use_capacity, seed=seed,
                       lpips_fn=lpips_fn, group=group)

    def step(images, idx, mask, sched: dict, step_index, draws) -> dict:
        model.train()
        rows, _ = _rows(mesh, len(idx))
        x = apply_augment(gather_batch(images, idx), draws, rows=rows,
                          **aug_kwargs)
        optimizer.zero_grad()
        losses = _forward_losses(model, x, mask, sched, offset=step_index,
                                 row0=0 if rows is None else rows.start,
                                 **loss_kwargs)
        losses["total"].backward()
        if group is not None:
            mean_over_ranks_(optimizer.flat_grad, group)
        optimizer.step(sched["lr"])
        return scalar_metrics(losses, mask, group)

    return step


def draw_step_augment(generator: torch.Generator, seed: int,
                      step_index: int, batch: int, aug_kwargs: dict,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``[3, batch]`` augmentation uniforms of step ``step_index`` of a
    global batch of ``batch``: ``generator`` seeded from ``(seed,
    step_index)``, drawn in ``data.augment.augment_batch``'s order, so that
    applying them is bitwise ``augment_batch`` with that generator."""
    generator.manual_seed(augment_seed(seed, step_index))
    return draw_augment(generator, batch, out=out, **aug_kwargs)


def make_eval_step(model: BetaVAEModule, spec: LossSpec, *,
                   use_capacity: bool, seed: int, lpips_fn=None, mesh=None):
    """Build ``eval_step(images, idx, mask, sched, offset) -> (metrics,
    mu)``: one stochastic validation batch in eval mode without autograd,
    its noise the kernel's Philox stream at ``(seed, offset)`` (an int, or
    a 0-d int64 tensor on the device in a captured pass).  With a
    ``mesh``, ``idx`` and ``mask`` are this rank's rows, the metrics the
    global batch's and ``mu`` this rank's rows."""
    group = None if mesh is None else mesh.group

    @torch.no_grad()
    def eval_step(images, idx, mask, sched: dict, offset):
        model.eval()
        rows, _ = _rows(mesh, len(idx))
        losses = _forward_losses(model, gather_batch(images, idx), mask,
                                 sched, spec=spec, use_capacity=use_capacity,
                                 seed=seed, offset=offset, lpips_fn=lpips_fn,
                                 row0=0 if rows is None else rows.start,
                                 group=group)
        return scalar_metrics(losses, mask, group), losses["mu"]

    return eval_step
