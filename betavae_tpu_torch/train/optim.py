"""The optimizer chain of ``betavae_tpu/train/optim.py``, rebuilt in torch.

The JAX package chains optax transforms: global-norm clipping at
``training.grad_clip``, then adam (L2 coupled into the gradient), adamw
(decoupled decay) or sgd with momentum 0.9, all with eps 1e-8, and a
learning rate set per step from ``schedules.lr_at``.  Here the clip is
optax's, ``g · clip / max(norm, clip)`` (``torch.nn.utils.clip_grad_norm_``
divides by ``norm + 1e-6`` and so differs), and the update is optax's rule
written with ``torch._foreach_*`` ops on the parameters' device:

    adam   g ← g + wd·p;  m ← b1·m + (1−b1)·g;  v ← b2·v + (1−b2)·g²
           p ← p − lr · (m / (1 − b1ᵗ)) / (√(v / (1 − b2ᵗ)) + eps)
    adamw  the same without the L2 term, then p ← p − lr · (update + wd·p)
    sgd    g ← g + wd·p;  t ← g + 0.9·t;  p ← p − lr·t

with ``b1``, ``b2`` from ``optimization.betas`` (default (0.9, 0.999),
optax's), the learning rate, the step count t and the bias corrections
``1 − bᵗ`` device tensors (fp32, as optax computes them), so a step reads
no host scalar and a CUDA graph of it replays the update of whatever
learning rate its step wrote (``train/chunks.py``).  The moments and the
count live in a ``torch.optim`` optimizer's ``state`` (``exp_avg``,
``exp_avg_sq``, ``step``; ``momentum_buffer``), which is only their
container: checkpoints save and load it as ``torch.optim.Adam`` /
``AdamW`` / ``SGD`` state, as before.  Grads and optimizer state stay fp32;
there is no loss scaling under bf16.
"""

from __future__ import annotations

import torch

from ..config import get, get_config

B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``, the
    ``optax.clip_by_global_norm`` rule, without a host sync.  Returns the
    global norm before clipping."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    torch._foreach_mul_(grads, max_norm / torch.clamp_min(norm, max_norm))
    return norm


class OptimizerChain:
    """clip → update, with the learning rate given at every step: a Python
    float or a 0-d fp32 tensor on the parameters' device."""

    def __init__(self, optimizer: torch.optim.Optimizer, grad_clip: float,
                 name: str, weight_decay: float, betas: tuple = (B1, B2)):
        self.optimizer = optimizer
        self.grad_clip = grad_clip
        self.name = name
        self.weight_decay = weight_decay
        self.betas = tuple(float(b) for b in betas)
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]
        self._bound_to = None
        self._lr = None
        self.flat_grad = None
        self._grad_views = []

    def flatten_grads(self) -> torch.Tensor:
        """Make every parameter's gradient a view of one flat buffer,
        allocated once, and return it: one all-reduce of it syncs a data
        mesh's gradients.  From then on :meth:`zero_grad` zeros the buffer
        in place and keeps the views (``backward()`` accumulates into
        them), so a captured CUDA graph's all-reduce reads where the
        gradients are."""
        if self.flat_grad is not None:
            return self.flat_grad
        kinds = {(p.dtype, p.device) for p in self.params}
        if len(kinds) != 1:
            raise ValueError(f"one flat gradient buffer needs parameters of "
                             f"one dtype and device, got {sorted(map(str, kinds))}")
        self.flat_grad = torch.zeros(sum(p.numel() for p in self.params),
                                     dtype=self.params[0].dtype,
                                     device=self.params[0].device)
        at = 0
        for p in self.params:
            self._grad_views.append(self.flat_grad[at:at + p.numel()]
                                    .view_as(p))
            at += p.numel()
        self.zero_grad()
        return self.flat_grad

    def zero_grad(self) -> None:
        if self.flat_grad is None:
            self.optimizer.zero_grad(set_to_none=True)
            return
        self.flat_grad.zero_()
        for p, view in zip(self.params, self._grad_views):
            if p.grad is not view:
                p.grad = view

    def bind_state(self) -> None:
        """Point the update at the tensors of ``self.optimizer.state``,
        creating them (zero moments, count 0) where a parameter has none;
        the count is one fp32 tensor on the parameters' device, shared by
        every parameter's ``step``.  Runs again whenever ``load_state_dict``
        has replaced the state (a resume), never between the steps of a
        captured graph."""
        state = self.optimizer.state
        if self._bound_to is state:
            return
        dev = self.params[0].device
        first = state.get(self.params[0], {})
        count = torch.as_tensor(first.get("step", 0.0)).to(
            device=dev, dtype=torch.float32).reshape(())
        fields = (("momentum_buffer",) if self.name == "sgd"
                  else ("exp_avg", "exp_avg_sq"))
        for p in self.params:
            st = state[p]
            for field in fields:
                if st.get(field) is None:
                    st[field] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            if self.name != "sgd":
                st["step"] = count
        self._count = count
        self._moments = [[state[p][field] for p in self.params]
                         for field in fields]
        self._bound_to = state

    def state_tensors(self) -> list:
        """Every tensor the update changes in place but the parameters:
        the moments and the count (after :meth:`bind_state`)."""
        counts = [] if self.name == "sgd" else [self._count]
        return [t for field in self._moments for t in field] + counts

    def _lr_tensor(self, lr) -> torch.Tensor:
        if isinstance(lr, torch.Tensor):
            return lr
        if self._lr is None:
            self._lr = torch.zeros((), device=self.params[0].device)
        return self._lr.fill_(float(lr))

    @torch.no_grad()
    def step(self, lr) -> None:
        # optax updates every parameter, one the loss does not reach (fc_
        # logvar under model.deterministic_overfit) with a zero gradient,
        # so its moments and the step count move on
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if not grads:
            return
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip)
        self.bind_state()
        lr = self._lr_tensor(lr)
        wd = self.weight_decay
        if wd > 0 and self.name in ("adam", "sgd"):
            grads = torch._foreach_add(grads, params, alpha=wd)
        if self.name == "sgd":
            (trace,) = self._moments
            torch._foreach_mul_(trace, MOMENTUM)
            torch._foreach_add_(trace, grads)
            torch._foreach_sub_(params, torch._foreach_mul(trace, lr))
            return
        m, v = self._moments
        b1, b2 = self.betas
        count = self._count
        count.add_(1.0)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        bc1 = 1.0 - torch.pow(b1, count)
        bc2 = 1.0 - torch.pow(b2, count)
        denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        if wd > 0 and self.name == "adamw":
            torch._foreach_add_(update, params, alpha=wd)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)


def build_optimizer(params, cfg=None) -> OptimizerChain:
    cfg = cfg or get_config()
    opt_cfg = cfg.optimization
    name = str(opt_cfg.optimizer).lower()
    lr = float(opt_cfg.lr)
    wd = float(get(opt_cfg, "weight_decay", 0.0) or 0.0)
    clip = float(get(cfg.training, "grad_clip", 0.0) or 0.0)
    betas = tuple(float(b) for b in get(opt_cfg, "betas", None) or (B1, B2))
    if len(betas) != 2:
        raise ValueError(f"optimization.betas must be two numbers, got "
                         f"{betas}")
    params = list(params)
    # the state's container, whose step() is never called
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=EPS,
                               weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=EPS,
                                weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=MOMENTUM,
                              weight_decay=wd)
    else:
        raise ValueError("unsupported optimizer")
    return OptimizerChain(opt, clip, name, wd, betas)
