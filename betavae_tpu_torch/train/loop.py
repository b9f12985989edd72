"""The trainers: config → data, model, optimizer, schedules → steps.

Counterpart of ``betavae_tpu/train/loop.py``.  :func:`train` is its
``train()``: seeded set-up, β / capacity / lr schedules (β at ``epoch−1``,
capacity at ``epoch``, free bits only when capacity is off), running-average
train ``METRICS`` every ``log_every_n_steps``, per-epoch stochastic
validation with latent collection and probe metrics, ``latest`` / ``best``
sharded checkpoints, a deterministic reconstruction panel, early stopping
and ``resume="best"|"latest"``, with ``training.async_checkpoint`` writing
the checkpoints on a background thread and SIGTERM draining it
(``training.graceful_shutdown``).  It carries the JAX loop's semantics, not
its XLA mechanism: steps run one by one, with no scan chunks, no epoch
rotation and no background panel writer (``training.scan_chunk_steps`` and
``epoch_rotation`` name that mechanism and are ignored), and the host reads
the card once per log step and once per validation pass.  The LPIPS term
(``loss.use_lpips``) runs under the JAX loop's gate: random-init features
only with ``loss.lpips_allow_random: true``, and the CONFIG line names the
weight source.  A split over ``training.max_device_dataset_mb`` stays in
host memory and is fed to the card batch by batch, staged up to
``training.host_feed_chunk_mb`` worth of batches ahead
(``data/pipeline.py``), with the same numbers as a resident split; and
``logging.profile_steps`` > 0 writes a ``torch.profiler`` trace of the
first train steps to ``<outputs_dir>/profile/`` (``utils/profiling.py``),
in both trainers.

:func:`train_steps` is the few-step trainer: the same set-up and train
lines for at most ``max_steps`` steps, with the wall time of the steps
after a warm-up, and no validation, checkpoints or panels.

Both take ``mesh=`` (:func:`..parallel.mesh.data_parallel_mesh`), as the
JAX ``train(mesh=...)`` does: each rank of the mesh calls the trainer in
its own process, holds the whole split (or, fed from the host, stages its
rows only), runs its rows of every global batch of
``training.batch_size`` (which must divide evenly over the ranks) and
validates its rows of every validation batch.  Every loss, metric and
decision is the global batch's, so every rank takes the same steps and
stops together, and the run computes what the single process does.  Only
rank 0 writes the checkpoints, panels, profiler traces and ``CONFIG`` /
``METRICS`` lines; the checkpoints are those of a single-process run and
resume in either mode.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np
import torch

from ..config import get, get_config
from ..data.augment import augment_config_kwargs
from ..data.dataset import load_image, load_split
from ..data.pipeline import BatchPlan, DeviceData, host_feed_chunk_limit
from ..device import deterministic_cudnn, resolve_device
from ..eval.probes import NAN_METRICS, compute_probe_metrics
from ..io.artifacts import ensure_dirs, model_checkpoint_path, save_image_grid
from ..io.checkpoint import load_sharded_checkpoint
from ..logging_utils import init_logger, log_config, log_metrics
from ..models.beta_vae import model_from_config
from ..models.losses import loss_spec_from_config
from ..ops.lpips import build_lpips_fn, resolve_weight_source
from ..parallel.reduce import gather_rows
from ..utils.profiling import StepProfiler
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
# the JAX loop's defaults: the device budget for a split (training.
# max_device_dataset_mb), above which it is fed from the host, and the
# host-fed batches' budget (training.host_feed_chunk_mb)
MAX_DEVICE_DATASET_MB = 4096
HOST_FEED_CHUNK_MB = 8.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lpips_on(cfg) -> bool:
    loss_cfg = get(cfg, "loss", None)
    return (bool(get(loss_cfg, "use_lpips", False))
            and float(get(loss_cfg, "lpips_weight", 0.0) or 0.0) > 0)


def _lpips_config_extras(cfg, warn: bool = True) -> dict:
    """The JAX loop's LPIPS gate (``train/loop.py:405-441`` of the JAX
    package), run before the CONFIG line: with LPIPS on and weighted,
    ``{"lpips_weights": "pretrained:<path>" | "random-init"}``; random-init
    raises unless ``loss.lpips_allow_random`` is true, and is logged as a
    warning (with ``warn``) when it is.  ``{}`` with LPIPS off."""
    if not _lpips_on(cfg):
        return {}
    loss_cfg = get(cfg, "loss", None)
    source = resolve_weight_source(get(loss_cfg, "lpips_weights_path", None))
    if source == "random-init":
        # random-init LPIPS trains, but is a different perceptual loss than
        # the reference's pretrained AlexNet: only as an explicit choice
        if not bool(get(loss_cfg, "lpips_allow_random", False)):
            raise RuntimeError(
                "use_lpips is ON but no pretrained weights were found. "
                "Refusing to train against deterministic RANDOM frozen "
                "features (a different perceptual loss than the "
                "reference's pretrained AlexNet). Either convert real "
                "weights: `python scripts/convert_lpips_weights.py` "
                "then set loss.lpips_weights_path (or $LPIPS_WEIGHTS), "
                "or opt in explicitly with loss.lpips_allow_random: "
                "true.")
        if warn:
            init_logger().warning(
                "use_lpips is ON with loss.lpips_allow_random: true — "
                "training against deterministic RANDOM frozen features "
                "(lpips_weights=random-init in the CONFIG line). Set "
                "loss.lpips_weights_path or $LPIPS_WEIGHTS for the "
                "reference's pretrained-AlexNet loss.")
    return {"lpips_weights": source}


def _device_data(cfg, ds, split: str, dev: torch.device,
                 say: bool = True) -> DeviceData:
    """``split`` on ``dev``, or fed from the host when its uint8 images
    exceed ``training.max_device_dataset_mb``, staged ahead by
    ``host_feed_chunk_limit`` batches of ``training.host_feed_chunk_mb``
    (counted at the global batch, as the JAX package counts them)."""
    budget_mb = int(get(cfg.training, "max_device_dataset_mb",
                        MAX_DEVICE_DATASET_MB))
    depth = host_feed_chunk_limit(
        int(cfg.training.batch_size), ds.images.shape[1:],
        float(get(cfg.training, "host_feed_chunk_mb", HOST_FEED_CHUNK_MB)))
    data = DeviceData.from_dataset(ds, dev,
                                   max_device_bytes=budget_mb * 1024 * 1024,
                                   depth=depth)
    if data.host_feed and say:
        print(f"[DATA] the {split} split ({ds.images.nbytes} bytes) exceeds "
              f"training.max_device_dataset_mb={budget_mb}: fed from the "
              f"host, up to {depth} batch(es) ahead")
    return data


class _Run:
    """What both trainers build from the config: data on the device, the
    seeded model, the optimizer, the loss, the schedules and the step; with
    a ``mesh``, this rank's part of them."""

    def __init__(self, cfg, dev: torch.device, *, with_test: bool,
                 mesh=None):
        self.dev = dev
        self.mesh = mesh
        self.main = mesh is None or mesh.is_main
        self.batch_size = int(cfg.training.batch_size)
        # this rank's rows of every batch (raises unless they divide evenly)
        self.rows = None if mesh is None else mesh.rows(self.batch_size)
        self.seed = int(cfg.data.seed)
        debug_cfg = get(cfg, "debug", None)
        self.debug = bool(get(debug_cfg, "enabled", False))
        self.epochs = resolve_total_epochs(cfg)
        self.train_ds = load_split("train", sample_limit=(
            get(debug_cfg, "train_samples", None) if self.debug else None))
        self.train_dev = _device_data(cfg, self.train_ds, "train", dev,
                                      say=self.main)
        if with_test:
            self.test_ds = load_split("test", sample_limit=(
                get(debug_cfg, "test_samples", None) if self.debug else None))
            if self.debug and get(cfg.model, "deterministic_overfit", False):
                self.test_ds = self.train_ds
            self.test_dev = _device_data(cfg, self.test_ds, "test", dev,
                                         say=self.main)
        self.max_train_batches = (int(debug_cfg.max_train_batches)
                                  if self.debug else None)
        self.max_val_batches = (int(debug_cfg.max_val_batches)
                                if self.debug else None)

        self.model = model_from_config(cfg, device=dev)
        self.spec = loss_spec_from_config(cfg)
        self.lpips_fn = (build_lpips_fn(
            get(get(cfg, "loss", None), "lpips_weights_path", None), dev)
            if _lpips_on(cfg) else None)
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
            use_capacity=self.use_capacity, seed=self.seed,
            lpips_fn=self.lpips_fn, mesh=mesh)
        self.train_plan = BatchPlan(len(self.train_ds), self.batch_size,
                                    shuffle=True, seed=self.seed)
        self.log_every = int(cfg.logging.log_every_n_steps)
        self.detect_anomalies = bool(get(cfg.training, "detect_anomalies",
                                         True))
        self.base_lr = float(cfg.optimization.lr)
        self.scheduler = str(cfg.optimization.scheduler)
        # rank 0 alone traces: the ranks would write the same files
        self.profiler = StepProfiler(
            get(cfg.logging, "profile_steps", 0) if self.main else 0,
            os.path.join(cfg.paths.outputs_dir, "profile"), dev)

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

    def log(self, metrics: dict, **kw) -> None:
        """A ``METRICS`` line, from rank 0 alone."""
        if self.main:
            log_metrics(metrics, **kw)

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
        self.log({
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


def _rank_device(device, mesh) -> torch.device:
    """The trainer's device: ``device``, or with a mesh the rank's, which
    must be of the kind asked for."""
    if mesh is None:
        return resolve_device(device)
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {str(device)!r} asked for, but this rank "
                         f"of the mesh runs on {mesh.device}")
    return mesh.device


def train_steps(config_path: str, max_steps: int,
                device: str | torch.device = "cuda", mesh=None) -> dict:
    """Train for at most ``max_steps`` steps from the config at
    ``config_path``.  Returns ``{"steps", "totals", "timed_steps",
    "timed_seconds", "batch_size", "traces", "model"}``: the per-step total
    losses, the wall time of the steps after the warm-up, ended by a device
    sync, the paths of the ``logging.profile_steps`` traces and the trained
    model.  With ``mesh``, this rank's part of a data-parallel run (the
    module docstring).  cuDNN runs its deterministic algorithms meanwhile
    (:func:`..device.deterministic_cudnn`), so the run replays in fp32
    too."""
    with deterministic_cudnn():
        return _train_steps(config_path, max_steps, device, mesh)


def _train_steps(config_path: str, max_steps: int, device, mesh) -> dict:
    dev = _rank_device(device, mesh)
    cfg = get_config(config_path)
    main = mesh is None or mesh.is_main
    extras = _lpips_config_extras(cfg, warn=main)
    if main:
        log_config(extras or None)
    run = _Run(cfg, dev, with_test=False, mesh=mesh)
    warmup = min(WARMUP_STEPS, max_steps // 2)

    totals = []
    total_steps = 0
    t_warm = time.perf_counter()
    try:
        for epoch in range(1, run.epochs + 1):
            if total_steps >= max_steps:
                break
            beta, capacity, free_bits = run.epoch_schedule(epoch)
            running = {k: torch.zeros((), device=dev) for k in RUNNING_KEYS}
            denom = 0
            batches = run.train_batches(epoch)[:max_steps - total_steps]
            run.profiler.maybe_start(total_steps + 1)
            for images, idx, mask in run.train_dev.feed(batches, run.rows):
                lr = run.lr(epoch, total_steps)
                last = run.step(images, idx, mask,
                                run.sched(beta, capacity, free_bits, lr),
                                total_steps + 1)
                for k in RUNNING_KEYS:
                    running[k] += last[k]
                totals.append(last["total"])
                denom += 1
                total_steps += 1
                run.profiler.after_step(total_steps)
                if total_steps == warmup:
                    _sync(dev)
                    t_warm = time.perf_counter()
                if total_steps % run.log_every == 0:
                    run.train_line(epoch=epoch, beta=beta, capacity=capacity,
                                   running=running, denom=denom, last=last,
                                   lr=lr, step=total_steps)
            run.profiler.stop()
        _sync(dev)
    finally:
        run.profiler.stop()
    timed_seconds = time.perf_counter() - t_warm
    return {
        "steps": total_steps,
        "totals": torch.stack(totals).cpu().tolist() if totals else [],
        "timed_steps": total_steps - warmup,
        "timed_seconds": timed_seconds,
        "batch_size": run.batch_size,
        "traces": run.profiler.paths,
        "model": run.model,
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

def _install_sigterm(cfg):
    """With ``training.graceful_shutdown`` (default true) and on the main
    thread, make SIGTERM raise ``KeyboardInterrupt``, so a preempted run
    unwinds through the trainer's ``finally`` and drains the checkpoint
    writer.  The handler restores the default at once: a second SIGTERM
    kills the process, for an unwind that is itself stuck.  Returns the
    handler to put back, or ``None`` when none was installed."""
    if not (bool(get(cfg.training, "graceful_shutdown", True))
            and threading.current_thread() is threading.main_thread()):
        return None

    def on_sigterm(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        raise KeyboardInterrupt("SIGTERM")

    return signal.signal(signal.SIGTERM, on_sigterm)


def _finish(ckpt: CheckpointManager, run_error, old_sigterm) -> None:
    """The trainer's exit, however it ends: every queued checkpoint lands
    (a failed write is raised, unless the loop already raised), and the
    SIGTERM handler is put back."""
    try:
        try:
            ckpt.drain()
        except Exception as drain_err:
            if run_error is None:
                raise
            print(f"[CKPT] background writer also failed: {drain_err!r}")
    finally:
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
        if isinstance(run_error, KeyboardInterrupt):
            print("[SHUTDOWN] interrupted — in-flight checkpoint drained; "
                  "resume with --resume latest", flush=True)


def train(config_path: str | None = None, resume: str = "none",
          device: str | torch.device = "cuda", mesh=None) -> dict:
    """Full training run from the config at ``config_path``.

    ``resume="best"|"latest"`` continues from ``<run_id>_<resume>.pt``
    (written by either package) at the epoch after the saved one, with the
    step count carried over, so the run replays the uninterrupted one;
    a missing checkpoint starts fresh.  With ``mesh``, this rank's part of
    a data-parallel run (the module docstring): every rank reads the
    checkpoint it resumes from, and rank 0 alone writes.

    Returns ``{"model", "optimizer", "epoch", "total_steps", "traces",
    "checkpoint_writes"}``, ``traces`` the paths of the
    ``logging.profile_steps`` traces and ``checkpoint_writes`` the
    checkpoints this process wrote (none on a rank other than 0).

    The ``epoch_end`` line has the JAX keys; three name the JAX dispatch
    mechanism and mean here: ``rotated`` is always ``False`` (no epoch
    rotation), ``rotate_dispatch_seconds`` is 0.0, and
    ``val_dispatch_seconds`` is the host time to enqueue the validation
    batches and the panel forward before the one read of their results.

    cuDNN runs its deterministic algorithms meanwhile
    (:func:`..device.deterministic_cudnn`), so the run replays in fp32 too.
    """
    with deterministic_cudnn():
        return _train(config_path, resume, device, mesh)


def _train(config_path, resume: str, device, mesh) -> dict:
    dev = _rank_device(device, mesh)
    cfg = get_config(config_path)
    main = mesh is None or mesh.is_main
    group = None if mesh is None else mesh.group
    ensure_dirs()
    extras = _lpips_config_extras(cfg, warn=main)
    if main:
        log_config(extras or None)
    run = _Run(cfg, dev, with_test=True, mesh=mesh)
    model, optimizer = run.model, run.optimizer
    eval_step = make_eval_step(model, run.spec, use_capacity=run.use_capacity,
                               seed=run.seed, lpips_fn=run.lpips_fn,
                               mesh=mesh)
    test_plan = BatchPlan(len(run.test_ds), run.batch_size, shuffle=False,
                          seed=run.seed)
    early = EarlyStopping(
        patience=int(get(cfg.training, "early_stopping_patience", 20)))
    ckpt = CheckpointManager(
        async_io=bool(get(cfg.training, "async_checkpoint", False)))
    ckpt_every = max(1, int(get(cfg.training, "checkpoint_every_epochs", 1)))
    figures_dir = cfg.paths.figures_dir
    os.makedirs(figures_dir, exist_ok=True)

    start_epoch, total_steps = 1, 0
    if resume in ("best", "latest"):
        path = model_checkpoint_path(tag=resume)
        try:
            payload = load_sharded_checkpoint(path)
        except FileNotFoundError:
            if main:
                print(f"[RESUME] Requested '{resume}' but checkpoint not "
                      f"found at {path}; starting fresh.")
        else:
            restore_training_state(payload, model, optimizer)
            start_epoch = int(payload.get("epoch", 0)) + 1
            total_steps = int(payload.get("total_steps", 0))
            ckpt.restore_best_history()
            if main:
                print(f"[RESUME] Loaded checkpoint '{resume}' from {path}, "
                      f"restarting at epoch {start_epoch}")
    elif resume != "none":
        raise ValueError(f"resume must be none, best or latest, got "
                         f"{resume!r}")

    no_val_warned = False
    epoch = start_epoch - 1
    old_sigterm = _install_sigterm(cfg)
    run_error = None
    try:
        for epoch in range(start_epoch, run.epochs + 1):
            beta, capacity, free_bits = run.epoch_schedule(epoch)
            running = {k: torch.zeros((), device=dev) for k in RUNNING_KEYS}
            totals = []
            last = {}
            denom = 0
            lr = run.lr(epoch, total_steps)
            epoch_t0 = time.perf_counter()
            run.profiler.maybe_start(total_steps + 1)
            for images, idx, mask in run.train_dev.feed(
                    run.train_batches(epoch), run.rows):
                lr = run.lr(epoch, total_steps)
                last = run.step(images, idx, mask,
                                run.sched(beta, capacity, free_bits, lr),
                                total_steps + 1)
                for k in RUNNING_KEYS:
                    running[k] += last[k]
                totals.append(last["total"])
                denom += 1
                total_steps += 1
                run.profiler.after_step(total_steps)
                if total_steps % run.log_every == 0:
                    run.train_line(epoch=epoch, beta=beta, capacity=capacity,
                                   running=running, denom=denom, last=last,
                                   lr=lr, step=total_steps)
            run.profiler.stop()
            if totals and run.detect_anomalies:
                finite = torch.isfinite(torch.stack(totals)).cpu().numpy()
                if not finite.all():
                    j = int(np.argmin(finite))
                    run.check_finite(float(totals[j]),
                                     total_steps - denom + j + 1, epoch)
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
            for j, (images, idx, mask) in enumerate(
                    run.test_dev.feed(vbatches, run.rows)):
                val_out.append(eval_step(
                    images, idx, mask, sched_v,
                    VAL_OFFSET + epoch * 100_000 + j))
            panel = _panel_images(cfg, run, vbatches) if main else None
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
                stacked = torch.stack([
                    torch.stack([m[k].float() for k in names])
                    for m, _ in val_out]).cpu().numpy()
                mk = {k: stacked[:, i] for i, k in enumerate(names)}
                # [batches, rows, latent]: the ranks' rows back in row order
                mu_all = gather_rows(torch.stack(
                    [mu for _, mu in val_out]).transpose(0, 1),
                    group).transpose(0, 1).cpu().numpy()
                if run.detect_anomalies:
                    for k in RUNNING_KEYS:
                        finite = np.isfinite(mk[k])
                        if not finite.all():
                            j = int(np.argmin(finite))
                            raise FloatingPointError(
                                f"non-finite validation loss at epoch "
                                f"{epoch}, val batch {j}: "
                                f"{k}={float(mk[k][j])} — check LR/grad_clip; "
                                "resume from the last checkpoint with "
                                "--resume latest")
                for k in RUNNING_KEYS:
                    val_sums[k] = float(mk[k].sum())
                val_kl_per_dim_mean = float(mk["kl_per_dim_mean"][-1])
                for j, (idx_np, mask_np) in enumerate(vbatches):
                    real = int(mask_np.sum())
                    val_latents.append(mu_all[j][:real])
                    val_labels.extend(
                        run.test_ds.labels[idx_np[:real]].tolist())
            val_seconds = time.perf_counter() - tail_t0

            vb = max(1, val_batches)
            val_total = val_sums["total"] / vb
            probe_metrics = {name: float("nan") for name in NAN_METRICS}
            if main and val_latents and len(val_labels) >= 2:
                probe_metrics = compute_probe_metrics(
                    np.concatenate(val_latents, axis=0), val_labels)
            probe_seconds = time.perf_counter() - tail_t0 - val_seconds
            run.log({
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
                "train_steps_per_sec": round(
                    denom / max(epoch_seconds, 1e-9), 3),
                "train_images_per_sec": round(
                    denom * run.batch_size / max(epoch_seconds, 1e-9), 1),
            }, step=total_steps, phase="val")

            t_ckpt = time.perf_counter()
            extra = {"val_total": val_total}
            saved_latest = epoch % ckpt_every == 0 or epoch == run.epochs
            # without validation batches val_total is a meaningless 0.0: it
            # must not become the best checkpoint or feed early stopping
            have_val = val_batches > 0
            if main:
                if saved_latest:
                    ckpt.save_latest(model, optimizer, epoch, total_steps,
                                     extra)
                if have_val:
                    ckpt.save_best(model, optimizer, epoch, total_steps,
                                   extra, monitor_value=val_total)
                elif not no_val_warned:
                    no_val_warned = True
                    print("[VAL] no validation batches this run — "
                          "best-checkpoint tracking and early stopping are "
                          "disabled")
            ckpt_seconds = time.perf_counter() - t_ckpt

            t_panel = time.perf_counter()
            if panel is not None:
                sample_reconstructions(
                    panel[0],
                    recon_dev.float().cpu().numpy().transpose(0, 2, 3, 1),
                    figures_dir, epoch, filenames=panel[1])
            panel_seconds = time.perf_counter() - t_panel

            tail_seconds = time.perf_counter() - tail_t0
            run.log({
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
                if not saved_latest and main:
                    # the run ends here: without this save '--resume latest'
                    # would replay up to checkpoint_every_epochs − 1 epochs
                    ckpt.save_latest(model, optimizer, epoch, total_steps,
                                     extra)
                break
    except BaseException as err:
        run_error = err
        raise
    finally:
        run.profiler.stop()
        _finish(ckpt, run_error, old_sigterm)
    return {"model": model, "optimizer": optimizer, "epoch": epoch,
            "total_steps": total_steps, "traces": run.profiler.paths,
            "checkpoint_writes": ckpt.writes}
