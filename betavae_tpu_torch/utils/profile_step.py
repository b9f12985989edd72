"""Capture and summarise a device trace of the train step.

``python -m betavae_tpu_torch.utils.profile_step --config C [--steps N]
[--top 20] [--filter RE] [--parse-only DIR] [--logdir DIR] [--device
cuda|cpu]``, the port's ``scripts/profile_step.py``: builds the config's
model, loss and optimizer (LPIPS off, as the JAX script), runs the train
step over seeded uint8 images on the device (the config's augmentation, a
fixed schedule: β 1, capacity 30, lr 5e-4), warms it up, times it, then
records ``--steps`` steps with ``torch.profiler`` into a Chrome trace under
``--logdir`` (default ``<outputs_dir>/profile``) and prints the per-kernel
table of ``utils/trace.py``.  ``--parse-only`` prints the table of an
existing trace (the newest under a directory) and needs no device.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .trace import find_traces, parse_trace

WARMUP_STEPS = 5
SCHED = {"beta": 1.0, "capacity": 30.0, "capacity_weight": 1.0,
         "free_bits": 0.0, "lr": 5e-4}


def _capture(cfg, steps: int, logdir: str, device: str) -> str:
    """Time the step, trace ``steps`` more, and return the trace's path."""
    from ..data.augment import augment_config_kwargs
    from ..device import resolve_device
    from ..models.beta_vae import model_from_config
    from ..models.losses import loss_spec_from_config
    from ..train.optim import build_optimizer
    from ..train.step import draw_step_augment, make_train_step

    dev = resolve_device(device)
    model = model_from_config(cfg, device=dev)
    optimizer = build_optimizer(model.parameters(), cfg)
    aug, seed = augment_config_kwargs(cfg), int(cfg.data.seed)
    step = make_train_step(model, optimizer, loss_spec_from_config(cfg),
                           aug_kwargs=aug, use_capacity=True, seed=seed)
    generator = torch.Generator(device=dev)
    b, size = int(cfg.training.batch_size), int(cfg.data.image_size)
    n = max(4 * b, 256)
    rng = np.random.default_rng(0)
    channels = 1 if cfg.data.grayscale else 3
    images = torch.from_numpy(
        rng.integers(0, 255, (n, size, size, channels), np.uint8)).to(dev)
    mask = torch.ones(b, device=dev)
    counter = [0]

    def run(k: int) -> None:
        for _ in range(k):
            start = counter[0] * b % (n - b)
            idx = torch.arange(start, start + b, device=dev)
            counter[0] += 1
            step(images, idx, mask, SCHED, counter[0], draw_step_augment(
                generator, seed, counter[0], b, aug))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run(WARMUP_STEPS)
    t0 = time.perf_counter()
    run(steps)
    ms = (time.perf_counter() - t0) / steps * 1e3
    print(f"step time (warm, host-observed): {ms:.3f} ms "
          f"({b / ms * 1e3:.0f} img/s)")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run(steps)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"profile_step_{steps}.trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.utils.profile_step",
        description="Per-kernel device trace of the train step.")
    parser.add_argument("--config", default=None)
    parser.add_argument("--logdir", default=None,
                        help="Where the trace is written (default "
                             "<outputs_dir>/profile).")
    parser.add_argument("--steps", type=int, default=None,
                        help="Steps traced (default 10); with --parse-only "
                             "the steps the trace holds (default 1).")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--filter", default=None,
                        help="Regex over kernel names.")
    parser.add_argument("--parse-only", default=None,
                        help="Summarise an existing trace file, or the "
                             "newest trace under a directory.")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.parse_only:
        path = args.parse_only
        if os.path.isdir(path):
            traces = find_traces(path)
            if not traces:
                raise FileNotFoundError(f"no Chrome trace under {path}")
            path = traces[0]
        summary = parse_trace(path, steps=args.steps or 1,
                              name_filter=args.filter)
    else:
        from ..config import get_config

        cfg = get_config(args.config)
        steps = args.steps or 10
        path = _capture(cfg, steps, args.logdir or os.path.join(
            cfg.paths.outputs_dir, "profile"), args.device)
        summary = parse_trace(path, steps=steps, name_filter=args.filter)
    print(f"trace: {path}")
    print(summary.table(args.top))
    return summary


if __name__ == "__main__":
    main()
