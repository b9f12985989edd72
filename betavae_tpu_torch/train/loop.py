"""The trainers: config → data, model, optimizer, schedules → steps.

Counterpart of ``betavae_tpu/train/loop.py``.  :func:`train` is its
``train()``: seeded set-up, β / capacity / lr schedules (β at ``epoch−1``,
capacity at ``epoch``, free bits only when capacity is off), running-average
train ``METRICS`` every ``log_every_n_steps``, per-epoch stochastic
validation with latent collection and probe metrics, ``latest`` / ``best``
sharded checkpoints, a deterministic reconstruction panel, early stopping
and ``resume="best"|"latest"``.  It carries the JAX loop's semantics, not
its XLA mechanism: steps run one by one, with no scan chunks, no epoch
rotation and no background writers, and the host reads the card once per
log step and once per validation pass.

:func:`train_steps` is the few-step trainer: the same set-up and train
lines for at most ``max_steps`` steps, with the wall time of the steps
after a warm-up, and no validation, checkpoints or panels.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..config import get, get_config
from ..data.augment import augment_config_kwargs
from ..data.dataset import load_image, load_split
from ..data.pipeline import BatchPlan, DeviceData
from ..device import resolve_device
from ..eval.probes import NAN_METRICS, compute_probe_metrics
from ..io.artifacts import ensure_dirs, model_checkpoint_path, save_image_grid
from ..io.checkpoint import load_sharded_checkpoint
from ..logging_utils import log_config, log_metrics
from ..models.beta_vae import model_from_config
from ..models.losses import loss_spec_from_config
from .callbacks import CheckpointManager, EarlyStopping, restore_training_state
from .optim import build_optimizer
from .schedules import lr_at, resolve_total_epochs, schedules_from_config
from .step import make_eval_step, make_train_step

RUNNING_KEYS = ("total", "recon", "recon_base", "recon_lpips", "recon_ffl",
                "kl_mean")
# steps left out of the timed window: the first ones pay for cuDNN's
# algorithm choice, the allocator's growth and the kernel library's load
WARMUP_STEPS = 5
# the noise of validation batch j of epoch e is the Philox stream at offset
# VAL_OFFSET + e·100 000 + j, the JAX package's val keys
# (fold_in(root, 2³¹ + e·100 000 + j)): far above any train step's offset
VAL_OFFSET = 2**31
PANEL_IMAGES = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Run:
    """What both trainers build from the config: data on the device, the
    seeded model, the optimizer, the loss, the schedules and the step."""

    def __init__(self, cfg, dev: torch.device, *, with_test: bool):
        self.dev = dev
        self.seed = int(cfg.data.seed)
        debug_cfg = get(cfg, "debug", None)
        self.debug = bool(get(debug_cfg, "enabled", False))
        self.epochs = resolve_total_epochs(cfg)
        self.train_ds = load_split("train", sample_limit=(
            get(debug_cfg, "train_samples", None) if self.debug else None))
        self.train_dev = DeviceData.from_dataset(self.train_ds, dev)
        if with_test:
            self.test_ds = load_split("test", sample_limit=(
                get(debug_cfg, "test_samples", None) if self.debug else None))
            if self.debug and get(cfg.model, "deterministic_overfit", False):
                self.test_ds = self.train_ds
            self.test_dev = DeviceData.from_dataset(self.test_ds, dev)
        self.max_train_batches = (int(debug_cfg.max_train_batches)
                                  if self.debug else None)
        self.max_val_batches = (int(debug_cfg.max_val_batches)
                                if self.debug else None)

        self.model = model_from_config(cfg, device=dev)
        self.spec = loss_spec_from_config(cfg)
        self.optimizer = build_optimizer(self.model.parameters(), cfg)
        self.beta_sched, self.cap_sched = schedules_from_config(
            cfg, total_epochs=self.epochs)
        loss_cfg = get(cfg, "loss", None)
        self.capacity_weight = get(loss_cfg, "capacity_weight", None)
        self.use_capacity = (self.cap_sched.enabled
                             and self.capacity_weight is not None)
        self.free_bits_cfg = float(get(loss_cfg, "free_bits", 0.0) or 0.0)
        self.step = make_train_step(
            self.model, self.optimizer, self.spec,
            aug_kwargs=augment_config_kwargs(cfg),
            use_capacity=self.use_capacity, seed=self.seed)
        self.batch_size = int(cfg.training.batch_size)
        self.train_plan = BatchPlan(len(self.train_ds), self.batch_size,
                                    shuffle=True, seed=self.seed)
        self.log_every = int(cfg.logging.log_every_n_steps)
        self.detect_anomalies = bool(get(cfg.training, "detect_anomalies",
                                         True))
        self.base_lr = float(cfg.optimization.lr)
        self.scheduler = str(cfg.optimization.scheduler)

    def epoch_schedule(self, epoch: int):
        beta = self.beta_sched.value(epoch - 1)
        capacity = (self.cap_sched.value(epoch) if self.cap_sched.enabled
                    else None)
        free_bits = self.free_bits_cfg if capacity is None else 0.0
        return beta, capacity, free_bits

    def lr(self, epoch: int, step_in_run: int) -> float:
        return lr_at(epoch, step_in_run, base_lr=self.base_lr,
                     scheduler=self.scheduler, total_epochs=self.epochs)

    def sched(self, beta, capacity, free_bits, lr) -> dict:
        return {"beta": beta,
                "capacity": capacity if capacity is not None else 0.0,
                "capacity_weight": (float(self.capacity_weight)
                                    if self.capacity_weight is not None
                                    else 1.0),
                "free_bits": free_bits, "lr": lr}

    def train_batches(self, epoch: int) -> list:
        return list(self.train_plan.batches(epoch))[:self.max_train_batches]

    def to_device(self, idx_np, mask_np):
        return (torch.from_numpy(idx_np.astype(np.int64)).to(self.dev),
                torch.from_numpy(mask_np).to(self.dev))

    def check_finite(self, value: float, step: int, epoch: int) -> None:
        if self.detect_anomalies and not np.isfinite(value):
            raise FloatingPointError(
                f"non-finite training loss at step {step} (epoch {epoch}): "
                f"total={value} — check LR/grad_clip; resume from the last "
                "checkpoint with --resume latest")

    def train_line(self, *, epoch, beta, capacity, running, denom, last,
                   lr, step) -> None:
        avg = {k: float(v) / denom for k, v in running.items()}
        self.check_finite(float(last["total"]), step, epoch)
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
            "loss_mode": "capacity" if self.use_capacity else "beta",
            "mu_mean_batch": float(last["mu_mean_batch"]),
            "z_std_batch": float(last["z_std_batch"]),
            "lr": lr,
        }, step=step, phase="train")


def train_steps(config_path: str, max_steps: int,
                device: str | torch.device = "cuda") -> dict:
    """Train for at most ``max_steps`` steps from the config at
    ``config_path``.  Returns ``{"steps", "totals", "timed_steps",
    "timed_seconds", "batch_size"}``: the per-step total losses and the wall
    time of the steps after the warm-up, ended by a device sync."""
    dev = resolve_device(device)
    cfg = get_config(config_path)
    log_config()
    run = _Run(cfg, dev, with_test=False)
    warmup = min(WARMUP_STEPS, max_steps // 2)

    totals = []
    total_steps = 0
    t_warm = time.perf_counter()
    for epoch in range(1, run.epochs + 1):
        if total_steps >= max_steps:
            break
        beta, capacity, free_bits = run.epoch_schedule(epoch)
        running = {k: torch.zeros((), device=dev) for k in RUNNING_KEYS}
        denom = 0
        for idx_np, mask_np in run.train_batches(epoch):
            if total_steps >= max_steps:
                break
            lr = run.lr(epoch, total_steps)
            last = run.step(run.train_dev.images, *run.to_device(idx_np, mask_np),
                            run.sched(beta, capacity, free_bits, lr),
                            total_steps + 1)
            for k in RUNNING_KEYS:
                running[k] += last[k]
            totals.append(last["total"])
            denom += 1
            total_steps += 1
            if total_steps == warmup:
                _sync(dev)
                t_warm = time.perf_counter()
            if total_steps % run.log_every == 0:
                run.train_line(epoch=epoch, beta=beta, capacity=capacity,
                               running=running, denom=denom, last=last,
                               lr=lr, step=total_steps)
    _sync(dev)
    timed_seconds = time.perf_counter() - t_warm
    return {
        "steps": total_steps,
        "totals": torch.stack(totals).cpu().tolist() if totals else [],
        "timed_steps": total_steps - warmup,
        "timed_seconds": timed_seconds,
        "batch_size": run.batch_size,
    }


# ---------------------------------------------------------------------------
# reconstruction panels
# ---------------------------------------------------------------------------

def sample_reconstructions(x: np.ndarray, recon: np.ndarray, out_dir: str,
                           epoch: int, filenames=None) -> dict:
    """Deterministic recon panel + diff + stats for ``(N, H, W, C)`` images
    ``x`` and their reconstructions: ``recon_epoch{e}.png`` (originals row
    above recons), ``recon_epoch{e}_diff.png`` and
    ``recon_epoch{e}_stats.json``, the JAX package's files and keys."""
    recon = np.clip(recon, 0.0, 1.0)
    n = x.shape[0]
    per_img_mse = ((recon - x) ** 2).reshape(n, -1).mean(axis=1)
    rflat = recon.reshape(n, -1)
    mean_pairwise = 0.0
    if n > 1:
        dists = np.sqrt(np.maximum(
            ((rflat[:, None, :] - rflat[None, :, :]) ** 2).sum(-1), 0.0))
        mean_pairwise = float((dists.sum() - np.trace(dists)) / (n * n - n))
    os.makedirs(out_dir, exist_ok=True)
    save_image_grid(np.concatenate([x, recon], axis=0),
                    os.path.join(out_dir, f"recon_epoch{epoch}.png"),
                    nrow=n, normalize=True)
    save_image_grid(np.abs(recon - x),
                    os.path.join(out_dir, f"recon_epoch{epoch}_diff.png"),
                    nrow=n, normalize=True)
    stats = {
        "epoch": int(epoch),
        "filenames": list(filenames)[:n] if filenames is not None else None,
        "per_image_mse": [float(v) for v in per_img_mse],
        "mean_per_image_mse": float(per_img_mse.mean()),
        "mean_pairwise_recon_L2": mean_pairwise,
        "x_min": float(x.min()), "x_max": float(x.max()),
        "recon_min": float(recon.min()), "recon_max": float(recon.max()),
        "recon_mean": float(recon.mean()), "recon_std": float(recon.std()),
    }
    with open(os.path.join(out_dir, f"recon_epoch{epoch}_stats.json"),
              "w") as f:
        json.dump(stats, f, indent=2)
    print(f"[RECON DEBUG] epoch {epoch} per-image MSE: {per_img_mse}")
    print(f"[RECON DEBUG] epoch {epoch} mean pairwise recon L2: "
          f"{mean_pairwise:.6f}")
    return stats


def _panel_images(cfg, run: _Run, vbatches: list):
    """``(images (N, H, W, C) float in [0, 1], names)`` of the epoch's
    panel: ``debug.fixed_recon_paths`` when set, else the first real images
    of the first validation batch; ``None`` without either."""
    fixed = list(get(get(cfg, "debug", None), "fixed_recon_paths", None) or [])
    if fixed:
        names = fixed[:PANEL_IMAGES]
        return np.stack([load_image(p, cfg.data.grayscale, cfg.data.image_size)
                         for p in names]), names
    if not vbatches:
        return None
    idx0, mask0 = vbatches[0]
    idx0 = idx0[:int(mask0.sum())][:PANEL_IMAGES]
    return (run.test_ds.images[idx0].astype(np.float32) / 255.0,
            [run.test_ds.paths[k] for k in idx0])


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------

def train(config_path: str | None = None, resume: str = "none",
          device: str | torch.device = "cuda") -> dict:
    """Full training run from the config at ``config_path``.

    ``resume="best"|"latest"`` continues from ``<run_id>_<resume>.pt``
    (written by either package) at the epoch after the saved one, with the
    step count carried over, so the run replays the uninterrupted one;
    a missing checkpoint starts fresh.

    Returns ``{"model", "optimizer", "epoch", "total_steps"}``.

    The ``epoch_end`` line has the JAX keys; three name the JAX dispatch
    mechanism and mean here: ``rotated`` is always ``False`` (no epoch
    rotation), ``rotate_dispatch_seconds`` is 0.0, and
    ``val_dispatch_seconds`` is the host time to enqueue the validation
    batches and the panel forward before the one read of their results.
    """
    dev = resolve_device(device)
    cfg = get_config(config_path)
    ensure_dirs()
    extras = {}
    if get(cfg.training, "async_checkpoint", False):
        extras["async_checkpoint"] = "not ported: checkpoints are written " \
                                     "synchronously (the same files)"
    log_config(extras or None)
    run = _Run(cfg, dev, with_test=True)
    model, optimizer = run.model, run.optimizer
    eval_step = make_eval_step(model, run.spec, use_capacity=run.use_capacity,
                               seed=run.seed)
    test_plan = BatchPlan(len(run.test_ds), run.batch_size, shuffle=False,
                          seed=run.seed)
    early = EarlyStopping(
        patience=int(get(cfg.training, "early_stopping_patience", 20)))
    ckpt = CheckpointManager()
    ckpt_every = max(1, int(get(cfg.training, "checkpoint_every_epochs", 1)))
    figures_dir = cfg.paths.figures_dir
    os.makedirs(figures_dir, exist_ok=True)

    start_epoch, total_steps = 1, 0
    if resume in ("best", "latest"):
        path = model_checkpoint_path(tag=resume)
        try:
            payload = load_sharded_checkpoint(path)
        except FileNotFoundError:
            print(f"[RESUME] Requested '{resume}' but checkpoint not found at "
                  f"{path}; starting fresh.")
        else:
            restore_training_state(payload, model, optimizer)
            start_epoch = int(payload.get("epoch", 0)) + 1
            total_steps = int(payload.get("total_steps", 0))
            ckpt.restore_best_history()
            print(f"[RESUME] Loaded checkpoint '{resume}' from {path}, "
                  f"restarting at epoch {start_epoch}")
    elif resume != "none":
        raise ValueError(f"resume must be none, best or latest, got "
                         f"{resume!r}")

    no_val_warned = False
    epoch = start_epoch - 1
    for epoch in range(start_epoch, run.epochs + 1):
        beta, capacity, free_bits = run.epoch_schedule(epoch)
        running = {k: torch.zeros((), device=dev) for k in RUNNING_KEYS}
        totals = []
        last = {}
        denom = 0
        lr = run.lr(epoch, total_steps)
        epoch_t0 = time.perf_counter()
        for idx_np, mask_np in run.train_batches(epoch):
            lr = run.lr(epoch, total_steps)
            last = run.step(run.train_dev.images,
                            *run.to_device(idx_np, mask_np),
                            run.sched(beta, capacity, free_bits, lr),
                            total_steps + 1)
            for k in RUNNING_KEYS:
                running[k] += last[k]
            totals.append(last["total"])
            denom += 1
            total_steps += 1
            if total_steps % run.log_every == 0:
                run.train_line(epoch=epoch, beta=beta, capacity=capacity,
                               running=running, denom=denom, last=last,
                               lr=lr, step=total_steps)
        if totals and run.detect_anomalies:
            finite = torch.isfinite(torch.stack(totals)).cpu().numpy()
            if not finite.all():
                j = int(np.argmin(finite))
                run.check_finite(float(totals[j]), total_steps - denom + j + 1,
                                 epoch)
        _sync(dev)
        epoch_seconds = time.perf_counter() - epoch_t0
        train_drain_mono = epoch_t0 + epoch_seconds
        final_train_kl_mean = float(running["kl_mean"]) / max(1, denom)
        final_train_kl_effective = float(last.get("kl_effective", 0.0))

        # ---- validation: enqueue every batch, then read once ------------
        tail_t0 = time.perf_counter()
        sched_v = run.sched(beta, capacity, free_bits, lr)
        vbatches = list(test_plan.batches(epoch))[:run.max_val_batches]
        val_out = []
        for j, (idx_np, mask_np) in enumerate(vbatches):
            val_out.append(eval_step(
                run.test_dev.images, *run.to_device(idx_np, mask_np),
                sched_v, VAL_OFFSET + epoch * 100_000 + j))
        panel = _panel_images(cfg, run, vbatches)
        recon_dev = None
        if panel is not None:
            model.eval()
            with torch.no_grad():
                x_panel = torch.from_numpy(np.ascontiguousarray(
                    panel[0].transpose(0, 3, 1, 2))).to(dev)
                recon_dev = model(x_panel, deterministic=True)[0]
        val_dispatch_seconds = time.perf_counter() - tail_t0

        val_batches = len(vbatches)
        val_sums = {k: 0.0 for k in RUNNING_KEYS}
        val_kl_per_dim_mean = 0.0
        val_latents, val_labels = [], []
        if val_out:
            names = sorted(val_out[0][0])
            stacked = torch.stack([torch.stack([m[k].float() for k in names])
                                   for m, _ in val_out]).cpu().numpy()
            mk = {k: stacked[:, i] for i, k in enumerate(names)}
            mu_all = torch.stack([mu for _, mu in val_out]).cpu().numpy()
            if run.detect_anomalies:
                for k in RUNNING_KEYS:
                    finite = np.isfinite(mk[k])
                    if not finite.all():
                        j = int(np.argmin(finite))
                        raise FloatingPointError(
                            f"non-finite validation loss at epoch {epoch}, "
                            f"val batch {j}: {k}={float(mk[k][j])} — check "
                            "LR/grad_clip; resume from the last checkpoint "
                            "with --resume latest")
            for k in RUNNING_KEYS:
                val_sums[k] = float(mk[k].sum())
            val_kl_per_dim_mean = float(mk["kl_per_dim_mean"][-1])
            for j, (idx_np, mask_np) in enumerate(vbatches):
                real = int(mask_np.sum())
                val_latents.append(mu_all[j][:real])
                val_labels.extend(run.test_ds.labels[idx_np[:real]].tolist())
        val_seconds = time.perf_counter() - tail_t0

        vb = max(1, val_batches)
        val_total = val_sums["total"] / vb
        probe_metrics = {name: float("nan") for name in NAN_METRICS}
        if val_latents and len(val_labels) >= 2:
            probe_metrics = compute_probe_metrics(
                np.concatenate(val_latents, axis=0), val_labels)
        probe_seconds = time.perf_counter() - tail_t0 - val_seconds
        log_metrics({
            "epoch": epoch,
            "beta": float(beta),
            "capacity": float(capacity) if capacity is not None else 0.0,
            "val_total_loss": val_total,
            "val_recon_loss": val_sums["recon"] / vb,
            "val_recon_base": val_sums["recon_base"] / vb,
            "val_recon_lpips": val_sums["recon_lpips"] / vb,
            "val_recon_ffl": val_sums["recon_ffl"] / vb,
            "val_kl": val_sums["kl_mean"] / vb,
            "val_kl_per_dim_mean": val_kl_per_dim_mean,
            "loss_mode": "capacity" if run.use_capacity else "beta",
            "train_kl_mean": final_train_kl_mean,
            "train_kl_effective_last": final_train_kl_effective,
            **probe_metrics,
            "epoch_seconds": round(epoch_seconds, 3),
            "train_steps_per_sec": round(denom / max(epoch_seconds, 1e-9), 3),
            "train_images_per_sec": round(
                denom * run.batch_size / max(epoch_seconds, 1e-9), 1),
        }, step=total_steps, phase="val")

        t_ckpt = time.perf_counter()
        extra = {"val_total": val_total}
        saved_latest = epoch % ckpt_every == 0 or epoch == run.epochs
        if saved_latest:
            ckpt.save_latest(model, optimizer, epoch, total_steps, extra)
        # without validation batches val_total is a meaningless 0.0: it
        # must not become the best checkpoint or feed early stopping
        have_val = val_batches > 0
        if have_val:
            ckpt.save_best(model, optimizer, epoch, total_steps, extra,
                           monitor_value=val_total)
        elif not no_val_warned:
            no_val_warned = True
            print("[VAL] no validation batches this run — best-checkpoint "
                  "tracking and early stopping are disabled")
        ckpt_seconds = time.perf_counter() - t_ckpt

        t_panel = time.perf_counter()
        if panel is not None:
            sample_reconstructions(
                panel[0], recon_dev.float().cpu().numpy().transpose(0, 2, 3, 1),
                figures_dir, epoch, filenames=panel[1])
        panel_seconds = time.perf_counter() - t_panel

        tail_seconds = time.perf_counter() - tail_t0
        log_metrics({
            "epoch": epoch,
            "val_seconds": round(val_seconds, 3),
            "val_dispatch_seconds": round(val_dispatch_seconds, 3),
            "rotate_dispatch_seconds": 0.0,
            "rotated": False,
            "probe_seconds": round(probe_seconds, 3),
            "ckpt_seconds": round(ckpt_seconds, 3),
            "panel_seconds": round(panel_seconds, 3),
            "tail_seconds": round(tail_seconds, 3),
            "epoch_wall_seconds": round(epoch_seconds + tail_seconds, 3),
            "t_mono": round(time.perf_counter(), 6),
            "t_drain_mono": round(train_drain_mono, 6),
        }, step=total_steps, phase="epoch_end")

        if have_val:
            early.update(val_total)
        if early.should_stop:
            if not saved_latest:
                # the run ends here: without this save '--resume latest'
                # would replay up to checkpoint_every_epochs − 1 epochs
                ckpt.save_latest(model, optimizer, epoch, total_steps, extra)
            break
    return {"model": model, "optimizer": optimizer, "epoch": epoch,
            "total_steps": total_steps}
