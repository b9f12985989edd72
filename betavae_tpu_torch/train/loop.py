"""The trainers: config → data, model, optimizer, schedules → steps.

Counterpart of ``betavae_tpu/train/loop.py``.  :func:`train` is its
``train()``: seeded set-up, β / capacity / lr schedules (β at ``epoch−1``,
capacity at ``epoch``, free bits only when capacity is off), running-average
train ``METRICS`` every ``log_every_n_steps``, per-epoch stochastic
validation with latent collection and probe metrics, ``latest`` / ``best``
sharded checkpoints, a deterministic reconstruction panel, early stopping
and ``resume="best"|"latest"``, with ``training.async_checkpoint`` writing
the checkpoints on a background thread and SIGTERM draining it
(``training.graceful_shutdown``).  Its dispatch is the JAX loop's: each
epoch runs in chunks of K = max(1, min(``training.scan_chunk_steps``,
steps)) steps (default 192; fed from the host, at most
``host_feed_chunk_limit`` steps), the remainder one step a chunk, and on
the card a chunk is K launches of one CUDA graph of the train step, each
from the device, with one upload of the chunk's inputs before them and
one read of its metrics after them; the validation pass is a launch of a
captured batch a batch and one read (``train/chunks.py``), both captured
before the first epoch.  No launch waits for the card, so a chunk's
dispatch returns at once, as the JAX loop's does, and the epoch keys time
what the JAX loop's time.  In one of several NCCL ranks the graphs launch
from the host, and each dispatch (a chunk; the validation pass) is a job
of the run's FIFO queue of device work, which a dispatcher thread runs in
order (``DeviceQueue``, ``device.py``), so that the launches wait for room
in the launch queue there and the dispatch returns at once too; the
ordering rule of ``train/chunks.py`` says which later device work fences
the queue first.
``scan_chunk_steps: 1`` steps eagerly, one launch after the other; so do
the CPU and a gloo mesh, whose collectives are host calls (the CONFIG
line's ``step_dispatch`` says so).
With ``training.epoch_rotation`` (default true, as in JAX) the next
epoch's first chunk is dispatched from the current epoch's tail, after
the validation pass, the panel forward, their copies to the host and a
device snapshot of the training state are queued and before the host
waits for the validation metrics; the checkpoints are written from that
snapshot, and an early stop restores it, so the speculative chunk is
discarded.  The epoch's reconstruction panel is written on a background
thread, joined before the next one and when the trainer ends.  The LPIPS
term (``loss.use_lpips``) runs under the JAX loop's gate: random-init
features only with ``loss.lpips_allow_random: true``, and the CONFIG line
names the weight source.  A split over ``training.max_device_dataset_mb``
stays in host memory and is shipped to the card a chunk at a time
(``data/pipeline.py``), with the same numbers as a resident split; and
``logging.profile_steps`` > 0 writes a ``torch.profiler`` trace of the
first train steps to ``<outputs_dir>/profile/`` (``utils/profiling.py``),
in both trainers.

:func:`train_steps` is the few-step trainer: the same set-up and train
lines for at most ``max_steps`` steps, with the wall time of the steps
after a warm-up, and no validation, checkpoints or panels.

Both take ``mesh=`` (:func:`..parallel.mesh.data_parallel_mesh`), as the
JAX ``train(mesh=...)`` does: each rank of the mesh calls the trainer in
its own process, holds the whole split (or, fed from the host, ships its
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

import collections
import functools
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
from ..device import DeviceQueue, Job, deterministic_cudnn, resolve_device
from ..eval.probes import NAN_METRICS, compute_probe_metrics
from ..io.artifacts import ensure_dirs, model_checkpoint_path, save_image_grid
from ..io.checkpoint import load_sharded_checkpoint
from ..logging_utils import init_logger, log_config, log_metrics
from ..models.beta_vae import model_from_config
from ..models.losses import loss_spec_from_config
from ..ops.lpips import build_lpips_fn, resolve_weight_source
from ..parallel.reduce import gather_rows
from ..utils.profiling import SPANS, StepProfiler, span
from .callbacks import CheckpointManager, EarlyStopping, restore_training_state
from .chunks import (METRIC_KEYS, RUNNING_KEYS, EvalChunks, Pending,
                     TrainChunks, chunk_plan, device_queue)
from .optim import build_optimizer
from .schedules import lr_at, resolve_total_epochs, schedules_from_config
from .step import make_eval_step, make_train_step

# steps left out of the timed window of eager steps: the first ones pay for
# cuDNN's algorithm choice, the allocator's growth and the kernel library's
# load (a captured step pays them in its capture, before the window)
WARMUP_STEPS = 5
# training.scan_chunk_steps' default, the JAX loop's
SCAN_CHUNK_STEPS = 192
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
    exceed ``training.max_device_dataset_mb``, ``host_feed_chunk_limit``
    batches of ``training.host_feed_chunk_mb`` an upload (counted at the
    global batch, as the JAX package counts them)."""
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


def dispatch_way(k_cfg: int, device: torch.device, mesh=None) -> str:
    """``"cuda_graph"``, or why the steps run eagerly: ``scan_chunk_steps:
    1`` (the yardstick), a device other than CUDA, or a gloo mesh, whose
    collectives are host calls that a CUDA graph cannot hold (an NCCL
    mesh's are kernels, captured with the step, and its replays are
    bitwise its eager steps; over several cards the graphs launch from the
    host (``chunks._several_ranks``) on the run's dispatcher thread, so a
    dispatch returns at once there too)."""
    if k_cfg == 1:
        return "eager: scan_chunk_steps 1"
    if device.type != "cuda":
        return f"eager: {device.type}"
    if mesh is not None and mesh.backend == "gloo":
        return "eager: gloo"
    return "cuda_graph"


def dispatch_note(way: str, device: torch.device) -> dict:
    """The CONFIG line's ``{"step_dispatch": way}`` where the steps run
    eagerly on the card for a reason the JAX package does not have (a gloo
    mesh), so that the log says so; ``{}`` elsewhere, where the line is the
    JAX package's."""
    if device.type == "cuda" and way == "eager: gloo":
        return {"step_dispatch": way}
    return {}


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
        self.k_cfg = int(get(cfg.training, "scan_chunk_steps",
                             SCAN_CHUNK_STEPS))
        if self.k_cfg < 1:
            raise ValueError(f"training.scan_chunk_steps must be >= 1, got "
                             f"{self.k_cfg}")
        self.dispatch = dispatch_way(self.k_cfg, dev, mesh)
        self.graphs = self.dispatch == "cuda_graph"
        # the run's device work: chunks, validation passes (train/chunks.py)
        self.queue = device_queue(dev, self.graphs)
        # rank 0 alone traces: the ranks would write the same files
        self.profiler = StepProfiler(
            get(cfg.logging, "profile_steps", 0) if self.main else 0,
            os.path.join(cfg.paths.outputs_dir, "profile"), dev,
            fence=self.queue.fence)
        # the largest chunk: fed from the host, what one upload holds, as
        # the JAX loop lowers K to host_feed_chunk_limit
        self.k_max = (min(self.k_cfg, self.train_dev.depth)
                      if self.train_dev.host_feed else self.k_cfg)
        self.rotate = bool(get(cfg.training, "epoch_rotation", True))
        n_steps = len(self.train_batches(1))
        self.local_batch = (self.batch_size if self.rows is None
                            else self.rows.stop - self.rows.start)
        self.train_source = self.train_dev.source(self.local_batch)
        self.chunks = TrainChunks(
            self.step, self.model, self.optimizer,
            k=chunk_plan(max(1, n_steps), self.k_max)[0],
            batch=self.batch_size, device=dev, seed=self.seed,
            aug_kwargs=augment_config_kwargs(cfg), graphs=self.graphs,
            rows=self.rows, queue=self.queue)

    def sync(self) -> None:
        """Wait for every step dispatched so far: the queue's fence, then a
        device sync."""
        self.queue.fence()
        _sync(self.dev)

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


class _Epoch:
    """An epoch's train steps: ``batches`` of ``epoch`` after ``done`` steps
    of the run, in the chunks of :func:`.chunks.chunk_plan` (cut at the
    profiler window's end and after step ``cut_at``), each dispatched
    before the previous one is drained, as the JAX loop does.  Made, it has
    reset the running sums; :meth:`dispatch` sends the next chunk (the
    profiler window opens at a chunk's first step where one is due), and
    epoch rotation sends the first from the previous epoch's tail;
    :meth:`run` sends the rest and drains them all, logging each log
    step's train line.  ``on_dispatch(n)`` runs after each chunk's
    dispatch, ``n`` the run's steps dispatched."""

    def __init__(self, run: _Run, epoch: int, batches: list, done: int,
                 on_dispatch=None, cut_at: int | None = None):
        self.run_, self.epoch, self.batches, self.done = (run, epoch, batches,
                                                          done)
        self.on_dispatch, self.cut_at = on_dispatch, cut_at
        self.beta, self.capacity, self.free_bits = run.epoch_schedule(epoch)
        run.chunks.reset_running()
        self.sizes = collections.deque(chunk_plan(len(batches),
                                                  run.k_max)[1])
        self.at, self.pending = 0, None
        self.out = {"totals": [], "last": {}, "running": {}, "steps": 0,
                    "lr": run.lr(epoch, done)}

    def dispatch(self) -> None:
        """Dispatch the next chunk, then drain the one before it."""
        run = self.run_
        size = self.sizes.popleft()
        first = self.done + self.at + 1
        run.profiler.maybe_start(first)
        keep = size
        if run.profiler.active:
            keep = min(keep, run.profiler.remaining)
        if self.cut_at is not None and first <= self.cut_at < first + keep - 1:
            keep = self.cut_at - first + 1
        if keep < size:
            self.sizes.appendleft(size - keep)
        local = self.batches[self.at:self.at + keep]
        if run.rows is not None:
            local = [(idx[run.rows], mask[run.rows]) for idx, mask in local]
        lrs = [run.lr(self.epoch, first - 1 + t) for t in range(keep)]
        steps = [(idx, mask,
                  run.sched(self.beta, self.capacity, self.free_bits, lrs[t]),
                  first + t) for t, (idx, mask) in enumerate(local)]
        new = run.chunks.dispatch(run.train_source, steps, meta=(lrs, first),
                                  stage=run.train_dev.stage)
        self.at += keep
        for t in range(keep):
            run.profiler.after_step(first + t)
        if self.on_dispatch is not None:
            self.on_dispatch(self.done + self.at)
        if self.pending is not None:
            self.drain(self.pending)
        self.pending = new

    def drain(self, pending: Job) -> None:
        run, out = self.run_, self.out
        lrs, first = pending.meta
        with span("trainer.drain"):
            rows = pending.rows()
        # the wait is over: read the device times that have landed
        SPANS.poll()
        for t, row in enumerate(rows):
            step = first + t
            out["last"] = dict(zip(METRIC_KEYS, row))
            out["running"] = dict(zip(RUNNING_KEYS, row[len(METRIC_KEYS):]))
            out["totals"].append(float(row[0]))
            out["steps"] += 1
            out["lr"] = lrs[t]
            if step % run.log_every == 0:
                run.train_line(epoch=self.epoch, beta=self.beta,
                               capacity=self.capacity,
                               running=out["running"], denom=out["steps"],
                               last=out["last"], lr=lrs[t], step=step)

    def run(self) -> dict:
        """Dispatch and drain the epoch's remaining chunks.  Returns
        ``{"totals", "last", "running", "lr", "steps"}``: every step's
        total, the last step's metrics and running sums, and the last
        step's learning rate."""
        while self.sizes:
            self.dispatch()
        if self.pending is not None:
            self.drain(self.pending)
            self.pending = None
        return self.out


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
    "timed_seconds", "batch_size", "traces", "model", "dispatch",
    "chunk_k", "capture_seconds", "launches_per_replay"}``: the per-step
    total losses, the wall time of the steps after the warm-up (none for
    captured steps: the capture is their warm-up, before the window), ended
    by a device sync, the paths of the ``logging.profile_steps`` traces,
    the trained model, how the steps ran (``"cuda_graph"`` or ``"eager:
    <why>"``), the chunk's slots K, the capture's seconds and each
    kernel's launches a replay (None without a graph).  With ``mesh``,
    this rank's part of a data-parallel run (the module docstring).  cuDNN
    runs its deterministic algorithms meanwhile
    (:func:`..device.deterministic_cudnn`), so the run replays in fp32
    too."""
    with deterministic_cudnn():
        return _train_steps(config_path, max_steps, device, mesh)


def _train_steps(config_path: str, max_steps: int, device, mesh) -> dict:
    dev = _rank_device(device, mesh)
    cfg = get_config(config_path)
    main = mesh is None or mesh.is_main
    extras = _lpips_config_extras(cfg, warn=main)
    run = _Run(cfg, dev, with_test=False, mesh=mesh)
    if main:
        log_config({**extras, **dispatch_note(run.dispatch, dev)})
    # a captured step pays its warm-up in the capture
    warmup = 0 if run.graphs else min(WARMUP_STEPS, max_steps // 2)
    capture_seconds = run.chunks.prepare(run.train_source)
    run.sync()

    totals = []
    total_steps = 0
    t_warm = time.perf_counter()

    def on_dispatch(dispatched: int) -> None:
        nonlocal t_warm
        if dispatched == warmup:
            run.sync()
            t_warm = time.perf_counter()

    try:
        for epoch in range(1, run.epochs + 1):
            if total_steps >= max_steps:
                break
            batches = run.train_batches(epoch)[:max_steps - total_steps]
            out = _Epoch(run, epoch, batches, total_steps,
                         on_dispatch=on_dispatch,
                         cut_at=warmup or None).run()
            totals += out["totals"]
            total_steps += out["steps"]
            run.profiler.stop()
        run.sync()
    finally:
        try:
            run.profiler.stop()
        finally:
            run.queue.close()
    timed_seconds = time.perf_counter() - t_warm
    return {
        "steps": total_steps,
        "totals": totals,
        "timed_steps": total_steps - warmup,
        "timed_seconds": timed_seconds,
        "batch_size": run.batch_size,
        "traces": run.profiler.paths,
        "model": run.model,
        "dispatch": run.dispatch,
        "chunk_k": run.chunks.k,
        "capture_seconds": capture_seconds,
        "launches_per_replay": (run.chunks.captured.launches()
                                if run.graphs else None),
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


class _PanelWriter:
    """The JAX loop's deferred panel writer: an epoch's panel is written by
    one daemon thread, which waits for the reconstruction's copy to the
    host and calls :func:`sample_reconstructions`.  The previous panel is
    joined before the next one starts, and a failure is raised at the next
    join."""

    def __init__(self):
        self._thread = None
        self._error = None

    def join(self) -> None:
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def start(self, images: np.ndarray, recon: Pending, out_dir: str,
              epoch: int, names) -> None:
        """Write ``epoch``'s panel of ``images`` and ``recon`` (NCHW, on its
        way to the host) in the background."""
        self.join()

        def work():
            try:
                sample_reconstructions(images,
                                       recon.rows().transpose(0, 2, 3, 1),
                                       out_dir, epoch, filenames=names)
            except Exception as err:  # raised at the next join
                self._error = err

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="betavae-panel-writer")
        self._thread.start()


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------

def _validate(run: _Run, eval_chunks: EvalChunks, local: list, sched: dict,
              epoch: int, group) -> Pending:
    """The device side of ``epoch``'s validation pass, a job of the run's
    queue: for each upload of at most ``eval_chunks.k`` of this rank's
    batches ``local`` (``(idx, mask)``), the test split's staging and the
    launches of the captured batch, then the all-gather of μ (the ranks'
    rows back in row order) and the copy of every batch's metrics and μ
    to the host, whose ``meta`` is μ's ``[batches, rows, latent]``."""
    with span("eval.pass", device=run.dev):
        nm = len(METRIC_KEYS)
        vsource = run.test_dev.source(len(local[0][0]))
        kv = eval_chunks.k
        parts = []
        for at in range(0, len(local), kv):
            part = local[at:at + kv]
            idx = run.test_dev.stage([i for i, _ in part])
            rows = eval_chunks.run(
                vsource, [(i, m) for i, (_, m) in zip(idx, part)], sched,
                [VAL_OFFSET + epoch * 100_000 + j
                 for j in range(at, at + len(part))])
            # the next upload's replays overwrite these rows
            parts.append(rows if kv == len(local) else rows.clone())
        val_rows = torch.cat(parts) if len(parts) > 1 else parts[0]
        mu = val_rows[:, nm:].reshape(len(local), -1, run.model.latent_dim)
        mu = gather_rows(mu.transpose(0, 1), group).transpose(0, 1)
        return Pending(torch.cat([val_rows[:, :nm].reshape(-1),
                                  mu.reshape(-1)]), meta=mu.shape)


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


def _finish(queue: DeviceQueue, ckpt: CheckpointManager,
            panels: _PanelWriter, run_error, old_sigterm) -> None:
    """The trainer's exit, however it ends (a SIGTERM too): the queued
    device work is launched and the dispatcher stopped, then the last
    panel and every queued checkpoint land.  The first failure among them
    is raised unless the loop already raised, the others are printed, and
    none keeps the rest from landing; the SIGTERM handler is put back."""
    try:
        first = None
        for label, what, drain in (("DISPATCH", "dispatcher", queue.close),
                                   ("PANEL", "writer", panels.join),
                                   ("CKPT", "writer", ckpt.drain)):
            try:
                drain()
            except Exception as err:
                if run_error is None and first is None:
                    first = err
                elif err is not run_error:
                    print(f"[{label}] background {what} also failed: "
                          f"{err!r}")
        if first is not None:
            raise first
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

    The ``epoch_end`` line has the JAX keys: ``rotated`` says whether the
    next epoch's first chunk was dispatched from this epoch's tail,
    ``rotate_dispatch_seconds`` is the host time of the snapshot and that
    dispatch, and ``val_dispatch_seconds`` the host time to enqueue the
    validation batches, the panel forward and their copies to the host
    before the one read of the validation results.  Those keys, the val
    line's ``epoch_seconds`` and the stamps ``t_mono`` and ``t_drain_mono``
    are read from the spans of :data:`..utils.profiling.SPANS`.

    After the JAX package's lines the port logs a ``spans`` line an epoch
    (:meth:`..utils.profiling.Spans.account`: the cycle from one
    ``epoch_end`` stamp to the next, its host seconds by span and, on the
    card, its device busy and idle seconds, read from CUDA events with no
    profiler), each at the next epoch's sync, the last at the run's end.

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
    run = _Run(cfg, dev, with_test=True, mesh=mesh)
    if main:
        log_config({**extras, **dispatch_note(run.dispatch, dev)})
    model, optimizer = run.model, run.optimizer
    eval_step = make_eval_step(model, run.spec, use_capacity=run.use_capacity,
                               seed=run.seed, lpips_fn=run.lpips_fn,
                               mesh=mesh)
    eval_chunks = None
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
    panels = _PanelWriter()
    prefetch = None     # the next epoch, its first chunk dispatched
    nm = len(METRIC_KEYS)
    old_sigterm = _install_sigterm(cfg)
    run_error = None
    try:
        # after the resume: the capture's warm-up is put back to this state
        run.chunks.prepare(run.train_source)
        # the validation batch too, before the first epoch's timed spans
        vplan = list(test_plan.batches(start_epoch))[:run.max_val_batches]
        if vplan:
            vrows = len(vplan[0][0] if run.rows is None
                        else vplan[0][0][run.rows])
            # fed from the host, the pass runs in uploads of at most
            # host_feed_chunk_limit batches, as the JAX loop's does
            kv = (min(len(vplan), run.test_dev.depth)
                  if run.test_dev.host_feed else len(vplan))
            eval_chunks = EvalChunks(eval_step, v=kv, local_batch=vrows,
                                     latent=model.latent_dim, device=dev,
                                     graphs=run.graphs, queue=run.queue)
            eval_chunks.prepare(run.test_dev.source(vrows))
        SPANS.start_epochs(dev)
        for epoch in range(start_epoch, run.epochs + 1):
            current, prefetch = prefetch, None
            if current is None:
                current = _Epoch(run, epoch, run.train_batches(epoch),
                                 total_steps)
            beta, capacity, free_bits = (current.beta, current.capacity,
                                         current.free_bits)
            epoch_t0 = SPANS.begin_epoch()
            out = current.run()
            run.profiler.stop()
            totals, denom, lr = out["totals"], out["steps"], out["lr"]
            total_steps += denom
            if totals and run.detect_anomalies:
                finite = np.isfinite(np.asarray(totals))
                if not finite.all():
                    j = int(np.argmin(finite))
                    run.check_finite(float(totals[j]),
                                     total_steps - denom + j + 1, epoch)
            run.sync()
            # the device has drained: the epoch's anchor, and the cycles
            # whose device times have all landed logged
            train_drain_mono = SPANS.anchor(dev)
            epoch_seconds = train_drain_mono - epoch_t0
            for step, line in SPANS.lines():
                run.log(line, step=step, phase="spans")
            final_train_kl_mean = (float(out["running"].get("kl_mean", 0.0))
                                   / max(1, denom))
            final_train_kl_effective = float(out["last"].get("kl_effective",
                                                             0.0))

            # ---- the tail, in stream order: the validation pass (a job of
            # the queue), the panel forward, their copies to the host, the
            # state's snapshot, the next epoch's first chunk; only then a
            # wait, for the validation copy (nothing the chunk overwrites is
            # read after)
            with span("trainer.tail") as tail:
                with span("trainer.val_dispatch") as val_dispatch:
                    sched_v = run.sched(beta, capacity, free_bits, lr)
                    vbatches = list(test_plan.batches(epoch))[
                        :run.max_val_batches]
                    val_pending = None
                    if vbatches:
                        local = [(idx, mask) if run.rows is None
                                 else (idx[run.rows], mask[run.rows])
                                 for idx, mask in vbatches]
                        val_pending = run.queue.submit(functools.partial(
                            _validate, run, eval_chunks, local, sched_v,
                            epoch, group))
                    panel = _panel_images(cfg, run, vbatches) if main else None
                    recon_pending = None
                    if panel is not None:
                        with span("trainer.panel_forward", device=dev):
                            model.eval()
                            with torch.no_grad():
                                x_panel = torch.from_numpy(
                                    np.ascontiguousarray(panel[0].transpose(
                                        0, 3, 1, 2))).to(dev)
                                recon_pending = Pending(model(
                                    x_panel, deterministic=True)[0].float())

                # epoch rotation: the checkpoints and an early stop read the
                # snapshot, taken before the next epoch's chunk is dispatched
                with span("trainer.rotate") as rotate:
                    snapshot = run.chunks.snapshot
                    snapshot.take()
                    next_batches = run.train_batches(epoch + 1)
                    # JAX's condition: its "n_steps >= K" holds for any epoch
                    # that has a step, K being at most n_steps
                    rotated = (run.rotate and epoch < run.epochs
                               and bool(next_batches))
                    if rotated:
                        prefetch = _Epoch(run, epoch + 1, next_batches,
                                          total_steps)
                        prefetch.dispatch()

                with span("trainer.val_read") as val_read:
                    val_batches = len(vbatches)
                    val_sums = {k: 0.0 for k in RUNNING_KEYS}
                    val_kl_per_dim_mean = 0.0
                    val_latents, val_labels = [], []
                    if val_pending is not None:
                        val_rows = val_pending.result()
                        host = val_rows.rows()
                        stacked = host[:val_batches * nm].reshape(val_batches,
                                                                  nm)
                        mu_all = host[val_batches * nm:].reshape(val_rows.meta)
                        mk = {k: stacked[:, i]
                              for i, k in enumerate(METRIC_KEYS)}
                        if run.detect_anomalies:
                            for k in RUNNING_KEYS:
                                finite = np.isfinite(mk[k])
                                if not finite.all():
                                    j = int(np.argmin(finite))
                                    raise FloatingPointError(
                                        f"non-finite validation loss at "
                                        f"epoch {epoch}, val batch {j}: "
                                        f"{k}={float(mk[k][j])} — check "
                                        "LR/grad_clip; resume from the last "
                                        "checkpoint with --resume latest")
                        for k in RUNNING_KEYS:
                            val_sums[k] = float(mk[k].sum())
                        val_kl_per_dim_mean = float(mk["kl_per_dim_mean"][-1])
                        for j, (idx_np, mask_np) in enumerate(vbatches):
                            real = int(mask_np.sum())
                            val_latents.append(mu_all[j][:real])
                            val_labels.extend(
                                run.test_ds.labels[idx_np[:real]].tolist())

                vb = max(1, val_batches)
                val_total = val_sums["total"] / vb
                with span("trainer.probes") as probes:
                    probe_metrics = {name: float("nan")
                                     for name in NAN_METRICS}
                    if main and val_latents and len(val_labels) >= 2:
                        probe_metrics = compute_probe_metrics(
                            np.concatenate(val_latents, axis=0), val_labels)
                run.log({
                    "epoch": epoch,
                    "beta": float(beta),
                    "capacity": (float(capacity) if capacity is not None
                                 else 0.0),
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

                with span("trainer.checkpoint") as checkpoint:
                    extra = {"val_total": val_total}
                    saved_latest = (epoch % ckpt_every == 0
                                    or epoch == run.epochs)
                    # without validation batches val_total is a meaningless
                    # 0.0: it must not become the best checkpoint or feed
                    # early stopping
                    have_val = val_batches > 0
                    if main:
                        if saved_latest:
                            ckpt.save_latest(model, optimizer, epoch,
                                             total_steps, extra,
                                             snapshot=snapshot)
                        if have_val:
                            ckpt.save_best(model, optimizer, epoch,
                                           total_steps, extra,
                                           monitor_value=val_total,
                                           snapshot=snapshot)
                        elif not no_val_warned:
                            no_val_warned = True
                            print("[VAL] no validation batches this run — "
                                  "best-checkpoint tracking and early "
                                  "stopping are disabled")

                # the panel: to the background writer, once the last one
                # landed
                with span("trainer.panel") as panel_span:
                    panels.join()
                    if recon_pending is not None:
                        panels.start(panel[0], recon_pending, figures_dir,
                                     epoch, panel[1])

            def seconds(rec) -> float:
                return round(rec.t1 - rec.t0, 3)

            tail_seconds = tail.t1 - tail.t0
            run.log({
                "epoch": epoch,
                "val_seconds": round(val_read.t1 - tail.t0, 3),
                "val_dispatch_seconds": seconds(val_dispatch),
                "rotate_dispatch_seconds": seconds(rotate),
                "rotated": rotated,
                "probe_seconds": seconds(probes),
                "ckpt_seconds": seconds(checkpoint),
                "panel_seconds": seconds(panel_span),
                "tail_seconds": round(tail_seconds, 3),
                "epoch_wall_seconds": round(epoch_seconds + tail_seconds, 3),
                "t_mono": round(SPANS.end_epoch(epoch, total_steps), 6),
                "t_drain_mono": round(train_drain_mono, 6),
            }, step=total_steps, phase="epoch_end")

            if have_val:
                early.update(val_total)
            if early.should_stop:
                if not saved_latest and main:
                    # the run ends here: without this save '--resume latest'
                    # would replay up to checkpoint_every_epochs − 1 epochs
                    ckpt.save_latest(model, optimizer, epoch, total_steps,
                                     extra, snapshot=snapshot)
                if prefetch is not None:
                    # the next epoch's chunk is discarded, never drained
                    # or logged (its launches ran, and stay counted): the
                    # state goes back to the checkpoints' (the restore
                    # fences the queue, so it lands after that chunk)
                    snapshot.restore()
                    prefetch = None
                break
    except BaseException as err:
        run_error = err
        raise
    finally:
        try:
            run.profiler.stop()
        finally:
            try:
                _finish(run.queue, ckpt, panels, run_error, old_sigterm)
            finally:
                SPANS.end_epochs()
    # the run's end: every span's device times, and the last cycles' lines
    for step, line in SPANS.settle(dev):
        run.log(line, step=step, phase="spans")
    return {"model": model, "optimizer": optimizer, "epoch": epoch,
            "total_steps": total_steps, "traces": run.profiler.paths,
            "checkpoint_writes": ckpt.writes}
