"""Whole epochs of the program's ``train()``: the trainer's loop with its
validation pass, probes, checkpoints, panels and epoch rotation, as a user
runs it.

Set-up writes the seed's images as the PNG tree ``train()`` reads (the
reference dataset's scale: the traffic's ``train_per_class`` and
``test_per_class`` images of each of four classes), and a copy of the
configuration whose paths lie in a work directory under ``TMPDIR``, whose
``data.seed`` is the run's seed and whose ``training.epochs`` is E = W +
round(``--seconds`` / the traffic's ``epoch_seconds``), W its
``warmup_epochs``.  Then one ``train()`` call: its own set-up (decode,
build, capture) and epochs 1 … W count as set-up; the window is epochs
W + 1 … E, from the end of epoch W's tail to the end of epoch E's, as the
benchmark's clock reads the moments the trainer logs its ``epoch_end``
lines.  ``epoch_images_per_sec`` is the
window's training images over its wall time.

``--trace 1``: the same run with a profiler prepared before ``train()``
(so every graph launches from the host while it is open), recording epoch
W + 1 inside the window annotation.  The trainer's per-layer readings come
from epochs W + 3 … E, which no graph launched from the host touched (epoch
W + 2's chunk is dispatched in epoch W + 1's tail): the mean of their
``tail_seconds``, and their training images over the benchmark's clock's
epoch cycles less those tails.

What the run holds against independent data: every step the trainer
dispatched, in every epoch, the window's included (the rows, mask,
schedule row and step number of each, as ``TrainChunks.dispatch`` is
handed them), against the epoch's shuffle and schedule row worked out
again from ``data.seed`` (an exact comparison); the first three steps'
losses against the plain reference (the rows of the first chunk the
trainer dispatched), from the weights the trainer starts from (worked out
again from ``data.seed``); the validation loss the trainer logs for epoch
E, against the reference's pass over the test split on the trainer's
final state (the reference can follow that pass only from the program's
own state); and the ``latest`` checkpoint on disk against that final
state, leaf by leaf (an exact comparison).  ``failed`` counts the window's
steps whose metrics row the trainer read back with a value that is not
finite, or never read.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import hashlib
import io
import json
import logging
import math
import os
import random
import shutil
import statistics
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch
import yaml

from .. import check, gen, tracing
from ..reference import betavae as reference
from .steady import _reference_flags

CLASSES = ("glioma", "meningioma", "pituitary", "notumor")
# the trainer's validation noise: batch j of epoch e at (seed, VAL_OFFSET +
# e · 100000 + j)
VAL_OFFSET = 2**31
FAULTS = ("unchanged", "half_batch", "stale_order", "stale_schedule")
# epochs a traced run's per-layer readings leave out after the warm-up: the
# traced epoch and the one whose chunk was dispatched under the profiler
TRACED_EPOCHS = 2
WRITERS = 8


class _Lines(logging.Handler):
    """The trainer's ``METRICS`` lines, each with the benchmark's clock at
    the moment it was logged; ``on_epoch_end(epoch)`` runs at each
    ``epoch_end`` line, on the training thread."""

    def __init__(self, on_epoch_end=None):
        super().__init__()
        self.lines, self.on_epoch_end = [], on_epoch_end

    def emit(self, record):
        msg = record.getMessage()
        if not msg.startswith("METRICS "):
            return
        now = time.perf_counter()
        d = json.loads(msg[len("METRICS "):])
        self.lines.append((now, d))
        if d.get("phase") == "epoch_end" and self.on_epoch_end is not None:
            self.on_epoch_end(int(d["epoch"]))

    def phase(self, name: str) -> list:
        return [(t, d) for t, d in self.lines if d.get("phase") == name]


def _write_split(root: str, split: str, images: torch.Tensor,
                 per_class: int) -> list:
    """PNG files ``<root>/<split>/<class>/<class>_<i>.png``, written by a
    few threads (PIL's encoder runs without the interpreter lock); returns
    their paths in the images' order."""
    from PIL import Image

    host = images[..., 0].cpu().numpy()
    paths = []
    for k, cls in enumerate(CLASSES):
        d = os.path.join(root, split, cls)
        os.makedirs(d, exist_ok=True)
        paths += [os.path.join(d, f"{cls}_{i}.png") for i in range(per_class)]

    def write(i: int) -> None:
        Image.fromarray(host[i], mode="L").save(paths[i], compress_level=1)

    with concurrent.futures.ThreadPoolExecutor(WRITERS) as pool:
        list(pool.map(write, range(len(paths))))
    return paths


def _sample_order(root: str, split: str, seed: int) -> list:
    """The order the trainer gives a split's files: each class folder (in
    sorted order) listed as the file system lists it, then shuffled by
    ``random.Random(seed)``."""
    samples = []
    base = os.path.join(root, split)
    for cls in sorted(os.listdir(base)):
        for fname in os.listdir(os.path.join(base, cls)):
            samples.append((os.path.join(base, cls, fname), cls))
    random.Random(seed).shuffle(samples)
    return [p for p, _ in samples]


def _epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The trainer's shuffle of a train epoch."""
    order = np.arange(n, dtype=np.int32)
    np.random.default_rng(np.uint64(seed * 1_000_003 + epoch)).shuffle(order)
    return order


def _leaf_key(a: np.ndarray) -> tuple:
    """A leaf's size and the digest of its values in sorted order: the same
    for the same values in any layout (the checkpoint keeps the JAX
    package's kernel layout)."""
    v = np.sort(np.asarray(a, np.float32).ravel())
    return (v.size, hashlib.sha1(v.tobytes()).hexdigest())


def _checkpoint_leaves(models_dir: str, run_id: str) -> dict:
    """The leaf keys of the ``model_state`` arrays of the ``latest``
    checkpoint's shards (a zip of ``.npy`` members and ``__meta__.json``
    each), and its ``epoch``."""
    keys, epoch = [], None
    for name in sorted(os.listdir(models_dir)):
        if not name.startswith(f"{run_id}_latest"):
            continue
        with zipfile.ZipFile(os.path.join(models_dir, name)) as zf:
            meta = json.loads(zf.read("__meta__.json"))
            epoch = meta.get("epoch", epoch)
            for member in zf.namelist():
                if member.startswith("model_state/") and member.endswith(".npy"):
                    keys.append(_leaf_key(np.load(io.BytesIO(zf.read(member)),
                                                  allow_pickle=False)))
    return {"keys": sorted(keys), "epoch": epoch}


class Epochs:
    def __init__(self, cell, seed: int, device: torch.device,
                 fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.seed, self.dev, self.fault = cell, int(seed), device, fault
        self.traffic, self.cfg = cell.traffic, cell.cfg
        self.batch = int(self.cfg["training"]["batch_size"])
        self.aug = gen.augmentation(self.cfg)
        self.spec = reference.Spec.from_config(self.cfg)
        self.precision = ("bf16" if self.cfg["training"].get("mixed_precision")
                          else "fp32")
        self.phases = {}

    def prepare(self, seconds: float) -> None:
        """The work directory, the image tree and the run's config."""
        t0 = time.perf_counter()
        self.work = tempfile.mkdtemp(prefix="bench_epochs_")
        size, ch = self.spec.image_size, self.spec.in_channels
        n_tr = 4 * int(self.traffic["train_per_class"])
        n_te = 4 * int(self.traffic["test_per_class"])
        self.train_images = gen.images(self.seed, n_tr, size, ch, self.dev)
        self.test_images = gen.images(self.seed, n_te, size, ch, self.dev,
                                      stream=gen.TEST_IMAGES)
        proc = os.path.join(self.work, "processed")
        self.index = {}
        for split, imgs, per in (
                ("train", self.train_images, self.traffic["train_per_class"]),
                ("test", self.test_images, self.traffic["test_per_class"])):
            for i, p in enumerate(_write_split(proc, split, imgs, int(per))):
                self.index[p] = i
        self.warm = int(self.traffic.get("warmup_epochs", 1))
        self.epochs = self.warm + max(2, round(seconds / float(
            self.traffic["epoch_seconds"])))
        cfg = json.loads(json.dumps(self.cfg))
        out = os.path.join(self.work, "outputs")
        cfg["paths"].update(
            raw_dir=os.path.join(self.work, "raw"), processed_dir=proc,
            outputs_dir=out, models_dir=os.path.join(out, "models"),
            figures_dir=os.path.join(out, "figures"),
            tables_dir=os.path.join(out, "tables"))
        cfg["data"]["seed"] = self.seed
        cfg["training"]["epochs"] = self.epochs
        self.run_cfg = cfg
        self.config_path = os.path.join(self.work, "run.yaml")
        with open(self.config_path, "w") as f:
            yaml.safe_dump(cfg, f)
        self.phases["data"] = time.perf_counter() - t0

    def train(self, trace_path: str | None = None) -> None:
        """One ``train()`` call, with the benchmark's clock on its epoch
        lines and the first chunk's rows kept."""
        from betavae_tpu_torch.config import get_config, reset_config_cache
        from betavae_tpu_torch.logging_utils import init_logger, reset_logger
        from betavae_tpu_torch.train import chunks, loop, optim, step

        prof = window = None
        if trace_path is not None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                 repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
            window = torch.profiler.record_function(tracing.WINDOW)

        def on_epoch_end(epoch: int) -> None:
            if prof is None:
                return
            if epoch == self.warm:
                prof.step()
                window.__enter__()
            elif epoch == self.warm + 1:
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
                window.__exit__(None, None, None)
                prof.step()

        self.fed = []
        dispatch = chunks.TrainChunks.dispatch

        def spy(chunk, images, steps, meta=None, stage=None):
            """Each dispatch's steps, and a copy of its metrics rows when
            the trainer reads them (the job itself is not kept, so its
            pinned rows go back to the allocator as they would)."""
            job = dispatch(chunk, images, steps, meta, stage)
            fed = {"steps": list(steps), "rows": None}
            self.fed.append(fed)
            read = job.rows

            def rows():
                out = read()
                if fed["rows"] is None:
                    fed["rows"] = np.array(out)
                return out
            job.rows = rows
            return job

        saved = {}
        if self.fault == "unchanged":
            saved["step"] = (optim.OptimizerChain, "step",
                             optim.OptimizerChain.step)
            optim.OptimizerChain.step = lambda chain, lr: None
        if self.fault == "half_batch":
            make = step.make_train_step

            def half_step(*args, **kwargs):
                inner = make(*args, **kwargs)

                def half(images, idx, mask, sched, step_index, draws):
                    h = idx.shape[0] // 2
                    return inner(images, idx[:h], mask[:h], sched,
                                 step_index, draws[:, :h])
                return half
            saved["make"] = (loop, "make_train_step", make)
            loop.make_train_step = half_step
        if self.fault == "stale_order":
            from betavae_tpu_torch.data import pipeline
            order = pipeline.BatchPlan.epoch_order
            saved["order"] = (pipeline.BatchPlan, "epoch_order", order)
            pipeline.BatchPlan.epoch_order = (
                lambda plan, epoch: order(plan, max(1, epoch - 1)))
        if self.fault == "stale_schedule":
            lr = loop._Run.lr
            saved["lr"] = (loop._Run, "lr", lr)
            loop._Run.lr = lambda run, epoch, at: lr(run, max(1, epoch - 1),
                                                    at)
        saved["dispatch"] = (chunks.TrainChunks, "dispatch", dispatch)
        chunks.TrainChunks.dispatch = spy
        reset_config_cache()
        reset_logger()
        get_config(self.config_path)
        self.lines = _Lines(on_epoch_end)
        init_logger().addHandler(self.lines)
        try:
            if prof is not None:
                prof.start()
            self.t_train = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                self.result = loop.train(self.config_path, device=self.dev)
        finally:
            if prof is not None:
                prof.stop()
            for owner, name, value in saved.values():
                setattr(owner, name, value)
            reset_logger()
            reset_config_cache()

    # -- readings --------------------------------------------------------

    def window(self) -> dict:
        ends = {int(d["epoch"]): t for t, d in self.lines.phase("epoch_end")}
        if set(ends) != set(range(1, self.epochs + 1)):
            raise RuntimeError(f"epoch_end lines for epochs {sorted(ends)}, "
                               f"expected 1 … {self.epochs}")
        steps = (self.epochs - self.warm) * (len(self.train_images)
                                             // self.batch)
        wall = ends[self.epochs] - ends[self.warm]
        return {"window_start": ends[self.warm], "steps": steps,
                "seconds": wall,
                "epoch_images_per_sec": steps * self.batch / wall}

    def counters(self, first_epoch: int) -> dict:
        """Over epochs ``first_epoch`` … E: the mean of the trainer's
        ``tail_seconds``, and the training images over the time outside
        the tails, each epoch's cycle (the benchmark's clock from the
        previous ``epoch_end`` line to its own) less its tail."""
        lines = {int(d["epoch"]): (t, d)
                 for t, d in self.lines.phase("epoch_end")}
        epochs = [e for e in sorted(lines) if e >= max(2, first_epoch)]
        tails = [lines[e][1]["tail_seconds"] for e in epochs]
        train = sum(lines[e][0] - lines[e - 1][0] - lines[e][1]["tail_seconds"]
                    for e in epochs)
        images = len(epochs) * self.per_epoch * self.batch
        return {"tail_s": statistics.fmean(tails) if tails else None,
                "train_images_per_sec": (images / train if epochs
                                         and train > 0 else None),
                "epochs": len(epochs), "train_seconds": train}

    def timeline(self) -> dict:
        """Each epoch's cycle on the benchmark's clock (from the previous
        ``epoch_end`` line; epoch 1's from ``train()``'s start) and its
        ``tail_seconds``."""
        lines = sorted((int(d["epoch"]), t, d["tail_seconds"])
                       for t, d in self.lines.phase("epoch_end"))
        starts = [self.t_train] + [t for _, t, _ in lines[:-1]]
        return {"cycle": [t - a for (_, t, _), a in zip(lines, starts)],
                "tail": [tail for _, _, tail in lines]}

    @property
    def per_epoch(self) -> int:
        return len(self.train_images) // self.batch

    def feed(self) -> dict:
        """The dispatched steps against the trainer's shuffle and schedule
        row of each epoch, worked out again here: ``feed`` the share of
        the run's steps 1 … E · P (P steps an epoch) not dispatched exactly
        once with the rows, the mask and the schedule row of its place;
        ``failed`` the window's steps whose metrics row is not finite or
        was never read."""
        p, n = self.per_epoch, len(self.train_images)
        total = self.epochs * p
        seen = collections.Counter()
        wrong = 0
        orders, scheds = {}, {}
        window = range(self.warm * p + 1, total + 1)
        finite = set()
        for fed in self.fed:
            for t, (idx, mask, sched, at) in enumerate(fed["steps"]):
                at = int(at)
                seen[at] += 1
                if not 1 <= at <= total:
                    wrong += 1
                    continue
                e, j = divmod(at - 1, p)
                e += 1
                if e not in orders:
                    orders[e] = _epoch_order(n, self.seed, e)
                    scheds[e] = gen.schedule(self.run_cfg, e)
                want = orders[e][j * self.batch:(j + 1) * self.batch]
                if not (np.array_equal(np.asarray(idx), want)
                        and np.all(np.asarray(mask) == 1.0)
                        and set(sched) == set(scheds[e])
                        and all(float(sched[k]) == scheds[e][k]
                                for k in sched)):
                    wrong += 1
                if fed["rows"] is not None and np.isfinite(
                        fed["rows"][t]).all():
                    finite.add(at)
        bad = wrong + sum(c - 1 for c in seen.values() if c > 1) + sum(
            1 for at in range(1, total + 1) if at not in seen)
        return {"feed": bad / total,
                "failed": len(set(window) - finite)}

    def program_readings(self) -> dict:
        model = self.result["model"]
        self.final = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
        vals = [d for _, d in self.lines.phase("val")
                if d["epoch"] == self.epochs]
        latest = _checkpoint_leaves(self.run_cfg["paths"]["models_dir"],
                                    self.run_cfg["paths"]["run_id"])
        first = self.fed[0]["rows"] if self.fed else np.zeros((0, 1))
        return {"losses": [float(r) for r in first[:check.CHECK_STEPS, 0]],
                "val": float(vals[-1]["val_total_loss"]), "latest": latest}

    def memory_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.dev))

    def release(self) -> None:
        self.__dict__.pop("result", None)
        import gc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, prog: dict, precision: str | None = None) -> dict:
        precision = precision or self.precision
        proc = self.run_cfg["paths"]["processed_dir"]
        train_paths = _sample_order(proc, "train", self.seed)
        test_paths = _sample_order(proc, "test", self.seed + 1)
        order = _epoch_order(len(train_paths), self.seed, 1)
        sched1 = gen.schedule(self.run_cfg, 1)
        batches = []
        for s in range(1, check.CHECK_STEPS + 1):
            rows = order[(s - 1) * self.batch:s * self.batch]
            idx = torch.tensor([self.index[train_paths[r]] for r in rows],
                               device=self.dev)
            b = reference.prepare_batch(self.train_images, idx, self.seed, s,
                                        self.aug, self.spec.latent)
            b["mask"] = torch.ones(self.batch, device=self.dev)
            b["sched"] = sched1
            batches.append(b)
        vbatches = []
        e = self.epochs
        for j in range(len(test_paths) // self.batch):
            idx = torch.tensor([self.index[p] for p in
                                test_paths[j * self.batch:(j + 1) * self.batch]],
                               device=self.dev)
            x = (self.test_images.index_select(0, idx).permute(0, 3, 1, 2)
                 .float() / 255.0).contiguous()
            eps = reference.streams.step_noise(
                (self.batch, self.spec.latent), self.seed,
                VAL_OFFSET + e * 100_000 + j, self.dev)
            vbatches.append({"x": x, "eps": eps,
                             "mask": torch.ones(self.batch, device=self.dev)})
        with _reference_flags():
            w0 = reference.initial_weights(self.spec, self.seed, self.dev)
            first = reference.train(w0, batches, self.spec,
                                    precision=precision)
            val = reference.validation(self.final, vbatches, self.spec,
                                       gen.schedule(self.run_cfg, e),
                                       precision)
        keys = sorted(_leaf_key(p.cpu().numpy()) for p in self.final.values())
        return {"losses": first["losses"], "val": val,
                "latest": {"keys": keys, "epoch": e}}

    def close(self) -> None:
        shutil.rmtree(getattr(self, "work", ""), ignore_errors=True)


def numbers(prog: dict, ref: dict) -> dict:
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    # the share of the final state's leaves the checkpoint does not hold
    pl, rl = prog["latest"], ref["latest"]
    missing = collections.Counter(rl["keys"]) - collections.Counter(pl["keys"])
    latest = (math.inf if pl["epoch"] != rl["epoch"]
              or len(pl["keys"]) != len(rl["keys"])
              else sum(missing.values()) / max(1, len(rl["keys"])))
    # the median of the steps' gaps: the later steps' losses move with
    # Adam's near-sign updates of leaves whose gradient is near nought, a
    # tail the median leaves out while a state left unchanged still fails
    if len(gaps) != check.CHECK_STEPS:
        gaps = [math.inf]
    return {"loss1": gaps[0], "loss": max(gaps),
            "loss_median": statistics.median(gaps),
            "val": abs(prog["val"] - ref["val"]) / max(abs(ref["val"]), 1e-30),
            "latest": latest}


def run(cell, args, device: torch.device, *, fault: str | None = None,
        trace_path: str | None = None) -> dict:
    r = Epochs(cell, args.seed, device, fault)
    out = {}
    try:
        r.prepare(float(args.seconds))
        r.train(trace_path if args.trace else None)
        out.update(r.window())
        out["memory_peak_bytes"] = r.memory_peak()
        prog = r.program_readings()
        r.release()
        ref = r.reference_readings(prog)
        fed = r.feed()
    finally:
        r.close()
    values = numbers(prog, ref)
    values["feed"] = fed["feed"]
    out["correct"], out["checks"] = check.judge(values, cell.limits)
    out["attempted"], out["failed"] = out["steps"], fed["failed"]
    c = r.counters(r.warm + 1 + (TRACED_EPOCHS if args.trace else 0))
    out["counters"] = {"batch": r.batch, "epochs": r.epochs,
                       "setup_phases": r.phases, "trainer": c,
                       "timeline": r.timeline()}
    return out
