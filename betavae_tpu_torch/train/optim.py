"""The optimizer chain of ``betavae_tpu/train/optim.py``, rebuilt in torch.

The JAX package chains optax transforms: global-norm clipping at
``training.grad_clip``, then adam (L2 coupled into the gradient), adamw
(decoupled decay) or sgd with momentum 0.9, all with eps 1e-8, and a
learning rate set per step from ``schedules.lr_at``.  Here the update is a
``torch.optim`` optimizer with the same rule, and the clip is optax's:
``g · clip / max(norm, clip)``.  (``torch.nn.utils.clip_grad_norm_``
divides by ``norm + 1e-6`` and so differs.)  Grads and optimizer state
stay fp32; there is no loss scaling under bf16.
"""

from __future__ import annotations

import torch

from ..config import get, get_config


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``, the
    ``optax.clip_by_global_norm`` rule, without a host sync.  Returns the
    global norm before clipping."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    torch._foreach_mul_(grads, max_norm / torch.clamp_min(norm, max_norm))
    return norm


class OptimizerChain:
    """clip → update, with the learning rate given at every step."""

    def __init__(self, optimizer: torch.optim.Optimizer, grad_clip: float):
        self.optimizer = optimizer
        self.grad_clip = grad_clip

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, lr: float) -> None:
        # optax updates every parameter, one the loss does not reach (fc_
        # logvar under model.deterministic_overfit) with a zero gradient,
        # so its moments and the step count move on; torch skips a
        # parameter without a gradient
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if self.grad_clip > 0 and grads:
            clip_by_global_norm_(grads, self.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()


def build_optimizer(params, cfg=None) -> OptimizerChain:
    cfg = cfg or get_config()
    opt_cfg = cfg.optimization
    name = str(opt_cfg.optimizer).lower()
    lr = float(opt_cfg.lr)
    wd = float(get(opt_cfg, "weight_decay", 0.0) or 0.0)
    clip = float(get(cfg.training, "grad_clip", 0.0) or 0.0)
    params = list(params)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=wd)
    else:
        raise ValueError("unsupported optimizer")
    return OptimizerChain(opt, clip)
