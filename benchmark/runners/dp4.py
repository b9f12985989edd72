"""Steady training over a data mesh: the steady runner's step
(``runners/steady.py``) over ``ranks`` ranks, one process and one card
each (NCCL; gloo on the CPU), every rank on its rows of each global batch.

The ranks are the program's (``parallel/launch.py::launch``: a rank that
fails stops the others, so a run never hangs).  Each rank builds the step
as the trainer does over its mesh (``make_train_step(mesh=…)``,
``TrainChunks(rows=…)``): the gradient is all-reduced once a step, every
batch reduction is over the mesh, and the captured graphs launch from the
host on the run's dispatcher thread.  Every rank holds the whole resident
split, makes the seed's weights and images on its own card, and runs the
same chunks; rank 0 reads the program's first steps, times the window and,
with ``--trace 1``, traces one chunk (the other ranks run it untraced).
The ranks agree on each run of chunks before it starts: rank 0 sets its
count from the seconds its chunks took, and one all-reduce (a job of the
run's queue, in order with the step's collectives) hands it to every rank.

``step_images_per_sec`` is the global batch's images of every step of the
window over rank 0's wall time; ``peak_mem_gib`` rank 0's card.  After the
ranks have returned, the plain reference runs the global batch's first
steps on the harness's card (``reference/betavae.py``, as for
``scaled.steady``), and the check is the steady runner's.

Traffic parameters: the steady runner's, and ``ranks``.
"""

from __future__ import annotations

import importlib
import math
import time

import numpy as np
import torch

from .. import gen
from . import steady

FAULTS = steady.FAULTS
# set-up's first chunks, which time a chunk before the warm-up's count is set
PROBE_CHUNKS = 2


def _half_batch(step):
    """A fault: each rank's step on the first half of its rows, with the
    global batch's draws."""
    def half(images, idx, mask, sched, step_index, draws):
        h = idx.shape[0] // 2
        return step(images, idx[:h], mask[:h], sched, step_index, draws)
    return half


class Rank(steady.Steady):
    """A rank's run, in its own process, over ``mesh``."""

    def __init__(self, cell, seed: int, mesh, fault: str | None = None):
        super().__init__(cell, seed, mesh.device, fault)
        self.mesh = mesh
        self.rows = mesh.rows(self.batch)
        self.per_chunk = None

    def setup(self, warm: bool = True) -> None:
        self._t = time.perf_counter()
        p = steady._program()
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
        w = gen.weights(self.seed, self.params, dev)
        with torch.no_grad():
            for n, t in names.items():
                t.copy_(w[n])
        del w
        self.optimizer = p.optim.build_optimizer(self.model.parameters(), cfg)
        step = p.make_train_step(
            self.model, self.optimizer, p.loss_spec_from_config(cfg),
            aug_kwargs=p.augment_config_kwargs(cfg), use_capacity=True,
            seed=self.seed, mesh=self.mesh)
        if self.fault == "half_batch":
            step = _half_batch(step)
        k_cfg = int(self.cfg["training"].get("scan_chunk_steps", 192))
        self.k = p.chunk_plan(self.order.per_epoch, k_cfg)[0]
        self.way = p.dispatch_way(k_cfg, dev, self.mesh)
        self.chunks = p.TrainChunks(
            step, self.model, self.optimizer, k=self.k, batch=self.batch,
            device=dev, seed=self.seed,
            aug_kwargs=p.augment_config_kwargs(cfg),
            graphs=self.way == "cuda_graph", rows=self.rows)
        self._unchanged = (steady._Unchanged(p.optim)
                           if self.fault == "unchanged" else None)
        if self._unchanged:
            self._unchanged.__enter__()
        self._stamp("build")
        self.chunks.prepare(self.images)
        self._stamp("capture")
        self.readings = self._first_steps()
        self._stamp("first_steps")
        if not warm:
            return
        probe = self._chunks(PROBE_CHUNKS)
        self.per_chunk = probe["seconds"] / PROBE_CHUNKS
        warm_s = float(self.traffic.get("warmup_seconds", 0.0))
        more = self._agree(max(0, math.ceil(warm_s / self.per_chunk)
                               - PROBE_CHUNKS))
        out = self._chunks(more)
        if more:
            self.per_chunk = out["seconds"] / more
        self.timeline["warmup"] = (probe["chunk_seconds"]
                                   + out["chunk_seconds"])
        self._stamp("warmup")

    def _steps(self, n: int) -> list:
        return [(idx[self.rows], mask[self.rows], sched, s)
                for idx, mask, sched, s in super()._steps(n)]

    def _agree(self, n: int) -> int:
        """Rank 0's ``n``, on every rank: an all-reduce (max) of it against
        0 from the others, as a job of the run's queue."""
        def job():
            t = torch.tensor([int(n) if self.mesh.is_main else 0],
                             dtype=torch.int64, device=self.dev)
            torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MAX,
                                         group=self.mesh.group)
            return int(t.item())
        return self.chunks.queue.submit(job).result()

    def _chunks(self, n: int) -> dict:
        """``n`` chunks of K steps, two in flight, every one drained, ended
        by a device sync."""
        self.chunks.queue.fence()
        self.sync()
        t0 = time.perf_counter()
        inflight, drained, failed = [], [], 0
        for i in range(n):
            inflight.append(self.dispatch(self.k))
            if len(inflight) > 1:
                rows = inflight.pop(0).rows()
                drained.append(time.perf_counter())
                failed += int((~np.isfinite(rows).all(axis=1)).sum())
        for job in inflight:
            rows = job.rows()
            drained.append(time.perf_counter())
            failed += int((~np.isfinite(rows).all(axis=1)).sum())
        self.chunks.queue.fence()
        self.sync()
        wall = time.perf_counter() - t0
        steps = n * self.k
        return {"steps": steps, "failed": failed, "seconds": wall,
                "step_images_per_sec": (steps * self.batch / wall
                                        if n else 0.0),
                "chunk_seconds": list(np.diff([t0] + drained)),
                "t0": t0}

    def window(self, seconds: float) -> dict:
        """The chunks of about ``seconds``, their count set by rank 0 from
        the seconds a chunk of the warm-up took and agreed by every
        rank."""
        if seconds <= 0:
            return {"steps": 0, "failed": 0, "seconds": 0.0}
        return self._chunks(self._agree(max(1, math.ceil(
            seconds / self.per_chunk))))

    def traced(self, trace_path: str) -> dict:
        if self.mesh.is_main:
            return super().traced(trace_path)
        n = max(1, min(self.k, math.ceil(
            int(self.traffic.get("trace_images", 1024)) / self.batch)))
        failed = 0
        for _ in range(2):
            rows = self.dispatch(n).rows()
            failed += int((~np.isfinite(rows).all(axis=1)).sum())
        return {"steps": n, "failed": failed}


def rank_main(mesh, cell, seed: int, fault, mode: str, seconds: float,
              trace: int, trace_path: str | None) -> dict:
    """One rank: ``mode`` ``readings`` (set-up through the first steps) or
    ``run`` (set-up, the window, and with ``trace`` the traced chunk).
    Returns rank 0's numbers (numbers and lists only)."""
    r = Rank(cell, seed, mesh, fault)
    out = {}
    try:
        r.setup(warm=mode == "run")
        if mode == "run":
            win = r.window(float(seconds))
            out.update({k: win[k] for k in ("steps", "failed", "seconds",
                                            "step_images_per_sec")})
            out["window_start"] = win["t0"]
            r.timeline["window"] = win["chunk_seconds"]
            out["window"] = {k: win[k] for k in ("steps", "seconds")}
            out["attempted"] = win["steps"]
            if trace:
                traced = r.traced(trace_path)
                out["steps"] = traced["steps"]
                out["attempted"] += traced["steps"]
                out["failed"] += traced["failed"]
        out["memory_peak_bytes"] = r.memory_peak()
    finally:
        r.close()
    out.update(readings=r.readings, k=r.k, dispatch=r.way,
               setup_phases=r.phases, timeline=r.timeline)
    return out


def _devices(device: torch.device, ranks: int) -> list:
    if device.type == "cuda":
        return [f"cuda:{i}" for i in range(ranks)]
    return [str(device)] * ranks


class Steady(steady.Steady):
    """The harness's side of a run (``calibrate.py`` drives it as it
    drives the steady runner's): the ranks' launch, their readings, and
    the plain reference of the global batch on ``device``."""

    def _launch(self, mode: str, seconds: float = 0.0, trace: int = 0,
                trace_path: str | None = None) -> dict:
        fn = importlib.import_module(__name__).rank_main
        from betavae_tpu_torch.parallel.launch import launch

        outs = launch(fn, _devices(self.dev, int(self.traffic["ranks"])),
                      (self.cell, self.seed, self.fault, mode, seconds,
                       trace, trace_path))
        return outs[0]

    def setup(self) -> None:
        out = self._launch("readings")
        self.readings = out["readings"]
        self.k, self.way, self.phases = (out["k"], out["dispatch"],
                                         out["setup_phases"])
        self.make_inputs()


def run(cell, args, device: torch.device, *, fault: str | None = None,
        trace_path: str | None = None) -> dict:
    """One run of the cell: the ranks' set-up, window (or traced window)
    and first steps, then the reference.  Returns what the harness
    prints."""
    r = Steady(cell, args.seed, device, fault)
    out = r._launch("run", float(args.seconds), int(args.trace), trace_path)
    r.readings = out.pop("readings")
    r.make_inputs()
    out["correct"], out["checks"] = r.judge(r.reference_readings())
    out["counters"] = {"batch": r.batch, "k": out.pop("k"),
                       "dispatch": out.pop("dispatch"),
                       "setup_phases": out.pop("setup_phases"),
                       "window": out.pop("window"),
                       "timeline": out.pop("timeline"),
                       "ranks": int(r.traffic["ranks"])}
    return out
