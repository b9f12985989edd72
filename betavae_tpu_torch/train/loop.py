"""The few-step trainer: config → data, model, optimizer, schedules → steps.

The first slice of ``betavae_tpu/train/loop.py::train``: the same set-up
(seeded model, the split on the device, β / capacity / lr schedules, free
bits only when capacity is off) and the same ``CONFIG`` line and
running-average ``METRICS`` train lines every ``log_every_n_steps``, for at
most ``max_steps`` steps.  The validation pass, checkpoints, resume, early
stopping and recon panels are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import get, get_config
from ..data.augment import augment_config_kwargs
from ..data.dataset import load_split
from ..data.pipeline import BatchPlan, DeviceData
from ..device import resolve_device
from ..logging_utils import log_config, log_metrics
from ..models.beta_vae import model_from_config
from ..models.losses import loss_spec_from_config
from .optim import build_optimizer
from .schedules import lr_at, resolve_total_epochs, schedules_from_config
from .step import make_train_step

RUNNING_KEYS = ("total", "recon", "recon_base", "recon_lpips", "recon_ffl",
                "kl_mean")
# steps left out of the timed window: the first ones pay for cuDNN's
# algorithm choice, the allocator's growth and the kernel library's load
WARMUP_STEPS = 5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_steps(config_path: str, max_steps: int,
                device: str | torch.device = "cuda") -> dict:
    """Train for at most ``max_steps`` steps from the config at
    ``config_path``.  Returns ``{"steps", "totals", "timed_steps",
    "timed_seconds", "batch_size"}``: the per-step total losses and the wall
    time of the steps after the warm-up, ended by a device sync."""
    dev = resolve_device(device)
    cfg = get_config(config_path)
    log_config()
    seed = int(cfg.data.seed)
    debug_cfg = get(cfg, "debug", None)
    debug_enabled = bool(get(debug_cfg, "enabled", False))
    epochs = resolve_total_epochs(cfg)

    train_ds = load_split("train", sample_limit=(
        get(debug_cfg, "train_samples", None) if debug_enabled else None))
    train_dev = DeviceData.from_dataset(train_ds, dev)
    model = model_from_config(cfg, device=dev)
    spec = loss_spec_from_config(cfg)
    optimizer = build_optimizer(model.parameters(), cfg)

    beta_sched, cap_sched = schedules_from_config(cfg, total_epochs=epochs)
    loss_cfg = get(cfg, "loss", None)
    capacity_weight = get(loss_cfg, "capacity_weight", None)
    use_capacity = cap_sched.enabled and capacity_weight is not None
    free_bits_cfg = float(get(loss_cfg, "free_bits", 0.0) or 0.0)
    step = make_train_step(model, optimizer, spec,
                           aug_kwargs=augment_config_kwargs(cfg),
                           use_capacity=use_capacity, seed=seed)

    batch_size = int(cfg.training.batch_size)
    plan = BatchPlan(len(train_ds), batch_size, shuffle=True, seed=seed)
    max_batches = int(debug_cfg.max_train_batches) if debug_enabled else None
    log_every = int(cfg.logging.log_every_n_steps)
    detect_anomalies = bool(get(cfg.training, "detect_anomalies", True))
    base_lr = float(cfg.optimization.lr)
    scheduler = str(cfg.optimization.scheduler)
    warmup = min(WARMUP_STEPS, max_steps // 2)

    totals = []
    total_steps = 0
    t_warm = time.perf_counter()
    for epoch in range(1, epochs + 1):
        if total_steps >= max_steps:
            break
        beta = beta_sched.value(epoch - 1)
        capacity = cap_sched.value(epoch) if cap_sched.enabled else None
        free_bits = free_bits_cfg if capacity is None else 0.0
        running = {k: torch.zeros((), device=dev) for k in RUNNING_KEYS}
        denom = 0
        for i, (idx_np, mask_np) in enumerate(plan.batches(epoch)):
            if total_steps >= max_steps or (max_batches is not None
                                            and i >= max_batches):
                break
            lr = lr_at(epoch, total_steps, base_lr=base_lr,
                       scheduler=scheduler, total_epochs=epochs)
            sched = {"beta": beta,
                     "capacity": capacity if capacity is not None else 0.0,
                     "capacity_weight": (float(capacity_weight)
                                         if capacity_weight is not None
                                         else 1.0),
                     "free_bits": free_bits, "lr": lr}
            idx = torch.from_numpy(idx_np.astype(np.int64)).to(dev)
            mask = torch.from_numpy(mask_np).to(dev)
            last = step(train_dev.images, idx, mask, sched, total_steps + 1)
            for k in RUNNING_KEYS:
                running[k] += last[k]
            totals.append(last["total"])
            denom += 1
            total_steps += 1
            if total_steps == warmup:
                _sync(dev)
                t_warm = time.perf_counter()
            if total_steps % log_every == 0:
                avg = {k: float(v) / denom for k, v in running.items()}
                if detect_anomalies and not np.isfinite(float(last["total"])):
                    raise FloatingPointError(
                        f"non-finite training loss at step {total_steps} "
                        f"(epoch {epoch}): total={float(last['total'])}")
                log_metrics({
                    "epoch": epoch,
                    "beta": float(beta),
                    "capacity": float(capacity) if capacity is not None else 0.0,
                    "train_total_loss": avg["total"],
                    "train_recon_loss": avg["recon"],
                    "train_recon_base": avg["recon_base"],
                    "train_recon_lpips": avg["recon_lpips"],
                    "train_recon_ffl": avg["recon_ffl"],
                    "train_kl": avg["kl_mean"],
                    "train_kl_mean": avg["kl_mean"],
                    "train_kl_effective_last": float(last["kl_effective"]),
                    "train_kl_per_dim_mean": float(last["kl_per_dim_mean"]),
                    "loss_mode": "capacity" if use_capacity else "beta",
                    "mu_mean_batch": float(last["mu_mean_batch"]),
                    "z_std_batch": float(last["z_std_batch"]),
                    "lr": lr,
                }, step=total_steps, phase="train")
    _sync(dev)
    timed_seconds = time.perf_counter() - t_warm
    return {
        "steps": total_steps,
        "totals": torch.stack(totals).cpu().tolist() if totals else [],
        "timed_steps": total_steps - warmup,
        "timed_seconds": timed_seconds,
        "batch_size": batch_size,
    }
