"""Steady training: the program's train step in K-step chunks over a
device-resident split, as ``train()`` dispatches an epoch's chunks, with no
validation, checkpoint, probe or panel.

Set-up builds the step as the trainer does (``model_from_config``,
``build_optimizer``, ``make_train_step``, ``TrainChunks``), puts the
seed's weights into the model, makes the seed's images on the card and
captures the step.  It then drives that same object through the first
steps of the run with the window's own call (one chunk of one step, one of
two), and reads the program's state after step 1 (the gradient, from
Adam's first moment) and after step 3 (each leaf's change): the readings
the plain reference is held against once the window has closed.

``--trace 0``: chunks of K steps are dispatched, two in flight, until
``--seconds`` have passed; every chunk dispatched is drained, and the
window ends in a device synchronise.  ``step_images_per_sec`` is the images
of all its steps over its wall time.

``--trace 1``: the same untraced window (``step.mfu`` reads its steps
and seconds), then one chunk of ``trace_images / batch`` steps (at most K)
as the profiler's warm-up and one such chunk traced inside the window
annotation, which the kernels' rooflines and the idle share read.  While a
profiler session is open the program launches its graphs from the host.

Every step takes the schedule row of epoch 1.  Traffic parameters
(``traffic/<name>.json``): ``images`` (rows of the resident split),
``warmup_seconds`` (chunks run as in the window after the first steps, in
set-up: the card's clocks and the first chunks' own warm-up, which read
~1.6 % slow over a first 10 s window, stay out of the window),
``trace_images``.
"""

from __future__ import annotations

import collections
import gc
import math
import time
import types

import numpy as np
import torch

from .. import check, gen, tracing
from ..reference import betavae as reference

# faults a test or a calibration plants in the timed path
FAULTS = ("unchanged", "half_batch")


def _program():
    """The program's entries, imported when a run starts."""
    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data.augment import augment_config_kwargs
    from betavae_tpu_torch.device import deterministic_cudnn
    from betavae_tpu_torch.models.beta_vae import model_from_config
    from betavae_tpu_torch.models.losses import loss_spec_from_config
    from betavae_tpu_torch.train import optim
    from betavae_tpu_torch.train.chunks import TrainChunks, chunk_plan
    from betavae_tpu_torch.train.loop import dispatch_way
    from betavae_tpu_torch.train.step import make_train_step
    return types.SimpleNamespace(**locals())


class _Unchanged:
    """A fault: the optimizer's step leaves the state as it was."""

    def __init__(self, optim):
        self.optim, self.saved = optim, optim.OptimizerChain.step

    def __enter__(self):
        self.optim.OptimizerChain.step = lambda chain, lr: None

    def __exit__(self, *exc):
        self.optim.OptimizerChain.step = self.saved


def _half_batch(step):
    """A fault: the step on the first half of its rows only, its means
    taken over them."""
    def half(images, idx, mask, sched, step_index, draws):
        h = idx.shape[0] // 2
        return step(images, idx[:h], mask[:h], sched, step_index,
                    draws[:, :h])
    return half


class Steady:
    def __init__(self, cell, seed: int, device: torch.device,
                 fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.seed, self.dev, self.fault = cell, int(seed), device, fault
        self.traffic = cell.traffic
        self.cfg = cell.cfg
        self.batch = int(self.cfg["training"]["batch_size"])
        self.aug = gen.augmentation(self.cfg)
        self.sched = gen.schedule(self.cfg, 1)
        # the reference computes at the precision the configuration states
        self.precision = ("bf16" if self.cfg["training"].get("mixed_precision")
                          else "fp32")
        self.phases = {}
        self.spec = reference.Spec.from_config(self.cfg)
        self.params = reference.parameters(self.spec)
        self.order = gen.Order(self.seed, int(self.traffic["images"]),
                               self.batch)
        self.mask = np.ones(self.batch, np.float32)
        self.next_step = 1
        self.readings = None
        # seconds of each chunk of the set-up's warm-up and of the window,
        # drain to drain
        self.timeline = {}

    # -- set-up --------------------------------------------------------

    def _stamp(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    def setup(self) -> None:
        self._t = time.perf_counter()
        p = _program()
        self._stamp("import")
        self._cudnn = p.deterministic_cudnn()
        self._cudnn.__enter__()
        p.reset_config_cache()
        cfg = p.get_config(str(self.cell.config_path))
        dev = self.dev
        self.make_inputs()
        self._stamp("images")
        self.model = p.model_from_config(cfg, device=dev)
        names = dict(self.model.named_parameters())
        if set(names) != {n for n, _, _ in self.params}:
            raise RuntimeError("the program's parameters are not the "
                               "reference's: " + ", ".join(sorted(
                                   set(names) ^ {n for n, _, _ in self.params})))
        w = gen.weights(self.seed, self.params, dev)
        with torch.no_grad():
            for n, t in names.items():
                t.copy_(w[n])
        del w
        self.optimizer = p.optim.build_optimizer(self.model.parameters(), cfg)
        step = p.make_train_step(
            self.model, self.optimizer, p.loss_spec_from_config(cfg),
            aug_kwargs=p.augment_config_kwargs(cfg), use_capacity=True,
            seed=self.seed)
        if self.fault == "half_batch":
            step = _half_batch(step)
        k_cfg = int(self.cfg["training"].get("scan_chunk_steps", 192))
        self.k = p.chunk_plan(self.order.per_epoch, k_cfg)[0]
        self.way = p.dispatch_way(k_cfg, dev)
        self.chunks = p.TrainChunks(
            step, self.model, self.optimizer, k=self.k, batch=self.batch,
            device=dev, seed=self.seed,
            aug_kwargs=p.augment_config_kwargs(cfg),
            graphs=self.way == "cuda_graph")
        self._unchanged = (_Unchanged(p.optim)
                           if self.fault == "unchanged" else None)
        if self._unchanged:
            self._unchanged.__enter__()
        self._stamp("build")
        self.chunks.prepare(self.images)
        self._stamp("capture")
        self.readings = self._first_steps()
        self._stamp("first_steps")
        warm = self.window(float(self.traffic.get("warmup_seconds", 0.0)))
        self.timeline["warmup"] = warm.get("chunk_seconds", [])
        self._stamp("warmup")

    def make_inputs(self) -> None:
        """The seed's images, on the card."""
        self.images = gen.images(self.seed, int(self.traffic["images"]),
                                 self.spec.image_size, self.spec.in_channels,
                                 self.dev)

    def _steps(self, n: int) -> list:
        out = []
        for s in range(self.next_step, self.next_step + n):
            out.append((self.order.rows(s), self.mask, self.sched, s))
        self.next_step += n
        return out

    def dispatch(self, n: int):
        return self.chunks.dispatch(self.images, self._steps(n))

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _norms(self, tensors: list) -> list:
        if not tensors:
            return []
        return torch.stack([torch.linalg.vector_norm(t.float())
                            for t in tensors]).cpu().tolist()

    def _first_steps(self) -> dict:
        """Steps 1 … ``check.CHECK_STEPS`` through the window's call; the
        program's readings of them."""
        named = list(self.model.named_parameters())
        losses = [float(self.dispatch(1).rows()[0, 0])]
        state = self.optimizer.optimizer.state
        moments = [state.get(p, {}).get("exp_avg") for _, p in named]
        norms = self._norms([m for m in moments if m is not None])
        it = iter(norms)
        grad = {n: (next(it) / (1.0 - reference.B1) if m is not None else 0.0)
                for (n, _), m in zip(named, moments)}
        rows = self.dispatch(check.CHECK_STEPS - 1).rows()
        losses += [float(r) for r in rows[:, 0]]
        p0 = gen.weights(self.seed, self.params, self.dev)
        change = dict(zip([n for n, _ in named],
                          self._norms([p.detach() - p0[n] for n, p in named])))
        del p0
        return {"losses": losses, "grad_norms": grad, "change_norms": change}

    # -- the window ----------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Chunks of K steps, two in flight, until ``seconds`` have passed
        (none for 0), every one drained, ended by a device sync."""
        self.sync()
        if seconds <= 0:
            return {"steps": 0, "failed": 0, "seconds": 0.0}
        t0 = time.perf_counter()
        inflight = collections.deque()
        steps = failed = 0
        drained = []

        def drain():
            nonlocal failed
            rows = inflight.popleft().rows()
            drained.append(time.perf_counter())
            failed += int((~np.isfinite(rows).all(axis=1)).sum())

        while True:
            inflight.append(self.dispatch(self.k))
            steps += self.k
            if len(inflight) > 1:
                drain()
            if time.perf_counter() - t0 >= seconds:
                break
        while inflight:
            drain()
        self.sync()
        wall = time.perf_counter() - t0
        return {"steps": steps, "failed": failed, "seconds": wall,
                "step_images_per_sec": steps * self.batch / wall,
                "chunk_seconds": list(np.diff([t0] + drained))}

    def traced(self, trace_path: str) -> dict:
        n = max(1, min(self.k, math.ceil(
            int(self.traffic.get("trace_images", 1024)) / self.batch)))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        failed = 0
        with torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                 repeat=1),
                on_trace_ready=lambda prof: prof.export_chrome_trace(
                    trace_path)) as prof:
            self.dispatch(n).rows()
            self.sync()
            prof.step()
            with torch.profiler.record_function(tracing.WINDOW):
                self.sync()
                rows = self.dispatch(n).rows()
                self.sync()
            failed += int((~np.isfinite(rows).all(axis=1)).sum())
            prof.step()
        return {"steps": n, "failed": failed}

    # -- after the window ------------------------------------------------

    def memory_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.dev))

    def close(self) -> None:
        """Free the program's state; restore what the run changed."""
        try:
            if hasattr(self, "chunks"):
                self.chunks.queue.close()
        finally:
            if getattr(self, "_unchanged", None):
                self._unchanged.__exit__(None, None, None)
            if hasattr(self, "_cudnn"):
                self._cudnn.__exit__(None, None, None)
            for name in ("chunks", "optimizer", "model"):
                self.__dict__.pop(name, None)
            gc.collect()
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()

    def reference_readings(self, precision: str | None = None) -> dict:
        """The plain reference's readings of the first steps, from the
        seed's weights and images (no state of the program)."""
        batches = []
        for s in range(1, check.CHECK_STEPS + 1):
            idx = torch.from_numpy(self.order.rows(s)).to(self.dev)
            b = reference.prepare_batch(self.images, idx, self.seed, s,
                                        self.aug, self.spec.latent)
            b["mask"] = torch.ones(self.batch, device=self.dev)
            b["sched"] = self.sched
            batches.append(b)
        w = gen.weights(self.seed, self.params, self.dev)
        with _reference_flags():
            return reference.train(w, batches, self.spec,
                                   precision=precision or self.precision)

    def judge(self, ref: dict) -> tuple:
        return check.judge(check.numbers(self.readings, ref),
                           self.cell.limits)


class _reference_flags:
    """Float32 matmuls and convolutions in float32, not TF32, and cuDNN's
    deterministic algorithms, so that a reading repeats."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
                      b.cudnn.deterministic, b.cudnn.benchmark)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
        b.cudnn.deterministic, b.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        b = torch.backends
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = self.saved


def run(cell, args, device: torch.device, *, fault: str | None = None,
        trace_path: str | None = None) -> dict:
    """One run of the cell: set-up, the window (or the traced window), then
    the reference.  Returns what the harness prints."""
    r = Steady(cell, args.seed, device, fault)
    out = {}
    try:
        r.setup()
        out["window_start"] = time.perf_counter()
        out.update(r.window(float(args.seconds)))
        r.timeline["window"] = out.pop("chunk_seconds")
        window = {k: out[k] for k in ("steps", "seconds")}
        out["attempted"] = out["steps"]
        if args.trace:
            traced = r.traced(trace_path)
            out["steps"] = traced["steps"]
            out["attempted"] += traced["steps"]
            out["failed"] += traced["failed"]
        out["memory_peak_bytes"] = r.memory_peak()
    finally:
        r.close()
    out["correct"], out["checks"] = r.judge(r.reference_readings())
    out["counters"] = {"batch": r.batch, "k": r.k, "dispatch": r.way,
                       "setup_phases": r.phases, "window": window,
                       "timeline": r.timeline}
    return out
