"""Steady training of Stable Diffusion's autoencoder (kl-f8): the steady
runner (``runners/steady.py``: its set-up, window, traced window and
check) over the program's ``autoencoder_kl``, held against
``reference/autoencoder_kl.py``.

What differs from the steady runner: the schedule row (β constant, no
capacity, the constant learning rate of ``optimization.scheduler: none``),
the loss in β mode as ``train()`` takes it for a configuration without a
capacity schedule, no augmentation, Adam's β1 from ``optimization.betas``
(the first gradient is read from Adam's first moment, m₁ = (1 − β1)·g),
and the reference.  Set-up first imports the program's autoencoder
(``models/autoencoder_kl.py``), so that a program without it fails before
it makes anything.  The counters add the launches a replay of the
captured step counts (``utils/profiling.py``'s ``*_launches`` counters,
``attn.<backend>_launches`` among them) and the replays, which
``attention_roofline`` reads.

Traffic parameters as the steady runner's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, gen
from ..reference import autoencoder_kl as reference
from . import steady

FAULTS = steady.FAULTS


def schedule(cfg: dict) -> dict:
    """The schedule row of every step: β constant, no capacity (its weight
    1.0, unread in β mode, as the trainer writes it), free bits 0 and the
    base learning rate."""
    if cfg["beta_schedule"]["type"] != "constant":
        raise NotImplementedError("only a constant β schedule")
    if (cfg["loss"].get("capacity_schedule") or {}).get("enabled"):
        raise NotImplementedError("only the β objective")
    opt = cfg["optimization"]
    if str(opt["scheduler"]).lower() != "none":
        raise NotImplementedError("only a constant learning rate")
    return {"beta": float(cfg["beta_schedule"]["end_beta"]), "capacity": 0.0,
            "capacity_weight": 1.0, "free_bits": 0.0, "lr": float(opt["lr"])}


def _program():
    """The program's entries; its autoencoder first."""
    import betavae_tpu_torch.models.autoencoder_kl  # noqa: F401
    from betavae_tpu_torch.utils.profiling import SPANS
    p = steady._program()
    p.SPANS = SPANS
    return p


class Steady(steady.Steady):
    def __init__(self, cell, seed: int, device: torch.device,
                 fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.seed, self.dev, self.fault = cell, int(seed), device, fault
        self.traffic = cell.traffic
        self.cfg = cell.cfg
        self.batch = int(self.cfg["training"]["batch_size"])
        self.aug = gen.augmentation(self.cfg)
        if any(self.aug.values()):
            raise NotImplementedError("the autoencoder's reference takes no "
                                      "augmentation")
        self.sched = schedule(self.cfg)
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
        self.timeline = {}

    def setup(self) -> None:
        self._t = time.perf_counter()
        p = _program()
        self.spans = p.SPANS
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
            aug_kwargs=p.augment_config_kwargs(cfg), use_capacity=False,
            seed=self.seed)
        if self.fault == "half_batch":
            step = steady._half_batch(step)
        k_cfg = int(self.cfg["training"].get("scan_chunk_steps", 192))
        self.k = p.chunk_plan(self.order.per_epoch, k_cfg)[0]
        self.way = p.dispatch_way(k_cfg, dev)
        self.chunks = p.TrainChunks(
            step, self.model, self.optimizer, k=self.k, batch=self.batch,
            device=dev, seed=self.seed,
            aug_kwargs=p.augment_config_kwargs(cfg),
            graphs=self.way == "cuda_graph")
        self._unchanged = (steady._Unchanged(p.optim)
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

    def _first_steps(self) -> dict:
        """Steps 1 … ``check.CHECK_STEPS`` through the window's call; the
        program's readings of them."""
        named = list(self.model.named_parameters())
        losses = [float(self.dispatch(1).rows()[0, 0])]
        state = self.optimizer.optimizer.state
        moments = [state.get(p, {}).get("exp_avg") for _, p in named]
        norms = self._norms([m for m in moments if m is not None])
        it = iter(norms)
        b1 = self.spec.betas[0]
        grad = {n: (next(it) / (1.0 - b1) if m is not None else 0.0)
                for (n, _), m in zip(named, moments)}
        rows = self.dispatch(check.CHECK_STEPS - 1).rows()
        losses += [float(r) for r in rows[:, 0]]
        p0 = gen.weights(self.seed, self.params, self.dev)
        change = dict(zip([n for n, _ in named],
                          self._norms([p.detach() - p0[n] for n, p in named])))
        del p0
        return {"losses": losses, "grad_norms": grad, "change_norms": change}

    def launches(self) -> dict:
        """The program's launch counters and the replays of its graphs."""
        c = dict(self.spans.counters)
        return {"launches": {k: v for k, v in c.items()
                             if k.endswith("_launches")
                             and not k.startswith("graphs.")},
                "replays": c.get("graphs.device_launches", 0)
                + c.get("graphs.host_launches", 0)}

    def reference_readings(self, precision: str | None = None) -> dict:
        """The plain reference's readings of the first steps, from the
        seed's weights and images (no state of the program)."""
        batches = []
        for s in range(1, check.CHECK_STEPS + 1):
            idx = torch.from_numpy(self.order.rows(s)).to(self.dev)
            b = reference.prepare_batch(self.images, idx, self.seed, s,
                                        self.spec.latent)
            b["mask"] = torch.ones(self.batch, device=self.dev)
            b["sched"] = self.sched
            batches.append(b)
        w = gen.weights(self.seed, self.params, self.dev)
        with steady._reference_flags():
            return reference.train(w, batches, self.spec,
                                   precision=precision or self.precision)


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
        counts = r.launches()
    finally:
        r.close()
    out["correct"], out["checks"] = r.judge(r.reference_readings())
    out["counters"] = {"batch": r.batch, "k": r.k, "dispatch": r.way,
                       "setup_phases": r.phases, "window": window,
                       "timeline": r.timeline, **counts}
    return out
