"""Epoch-level β / KL-capacity / learning-rate schedules as pure functions.

The port's own copy of ``betavae_tpu/train/schedules.py`` (which imports
JAX through its package): β constant / linear / cosine / cyclical with the
reference's key aliases, capacity ``C_start → C_end`` over
``warmup_epochs`` then hold (``None`` when disabled), and ``lr_at`` with
cosine stepped per epoch and ``step`` per batch.
"""

from __future__ import annotations

import math

from ..config import get, get_config


def _bs_get(bs, *names, default=None):
    for n in names:
        v = get(bs, n, None)
        if v is not None:
            return v
    return default


class BetaSchedule:
    def __init__(self, root_cfg, total_epochs: int):
        bs = get(root_cfg, "beta_schedule", None)
        if bs is None:
            model_beta = get(get(root_cfg, "model", None), "beta", 1.0)
            self.type = "constant"
            self.start = self.end = float(model_beta)
            self.warm = 0
            self.cycle = 0
        else:
            self.type = _bs_get(bs, "type", default="constant")
            end_like = _bs_get(bs, "end_beta", "end", default=1.0)
            self.start = float(
                _bs_get(bs, "start_beta", "start", default=end_like))
            self.end = float(_bs_get(bs, "end_beta", "end", default=self.start))
            self.warm = _bs_get(bs, "warmup_epochs", "warmup", default=0)
            self.cycle = _bs_get(bs, "cycle_length", "cycle", default=0)
        self.total_epochs = total_epochs

    def value(self, epoch: int) -> float:
        """β at 0-based ``epoch``."""
        kind = self.type
        if kind == "linear" and self.warm > 0:
            frac = min(1.0, epoch / float(self.warm))
        elif kind == "cosine" and self.total_epochs > 1:
            frac = 0.5 - 0.5 * math.cos(
                math.pi * epoch / (self.total_epochs - 1))
        elif kind in ("cyclical", "cyc") and self.cycle > 0:
            frac = (epoch % self.cycle) / float(self.cycle)
        else:
            return self.end
        return self.start + (self.end - self.start) * frac


class CapacitySchedule:
    def __init__(self, root_cfg, total_epochs: int):
        cap = get(get(root_cfg, "loss", None), "capacity_schedule", None)
        self.enabled = bool(get(cap, "enabled", False)) if cap is not None else False
        self.C0 = float(get(cap, "C_start", 0.0)) if cap is not None else 0.0
        self.C1 = float(get(cap, "C_end", self.C0)) if cap is not None else self.C0
        self.warm = get(cap, "warmup_epochs", 0) if cap is not None else 0
        self.total = get(cap, "total_epochs", total_epochs) if cap is not None else total_epochs
        self.total_epochs = total_epochs

    def value(self, epoch: int):
        if not self.enabled:
            return None
        e = max(0, epoch)
        span = max(1, self.warm)
        if e <= self.warm:
            return self.C0 + min(1.0, e / span) * (self.C1 - self.C0)
        return self.C1


def lr_at(epoch: int, step_in_run: int, *, base_lr: float, scheduler: str,
          total_epochs: int) -> float:
    """Learning rate for (1-based) ``epoch`` / global batch ``step_in_run``:
    cosine is CosineAnnealingLR(T_max=total_epochs) advanced per epoch, step
    is StepLR(30, 0.5) advanced per batch."""
    sch = scheduler.lower()
    if sch == "none":
        return base_lr
    if sch == "cosine":
        t = min(epoch - 1, total_epochs)
        return 0.5 * base_lr * (1 + math.cos(math.pi * t / total_epochs))
    if sch == "step":
        return base_lr * (0.5 ** (step_in_run // 30))
    raise ValueError("unsupported scheduler")


def resolve_total_epochs(cfg) -> int:
    """``debug.epochs`` when debug mode is on, else ``training.epochs``."""
    debug_enabled = bool(get(get(cfg, "debug", None), "enabled", False))
    return int(cfg.debug.epochs if debug_enabled else cfg.training.epochs)


def schedules_from_config(cfg=None, total_epochs: int | None = None):
    cfg = cfg or get_config()
    if total_epochs is None:
        total_epochs = resolve_total_epochs(cfg)
    return BetaSchedule(cfg, total_epochs), CapacitySchedule(cfg, total_epochs)
