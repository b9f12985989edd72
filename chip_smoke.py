#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``betavae_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero at once):

1. device: fails without CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them,
2. build: compiles every ``betavae_tpu_torch/csrc/*.cu`` (one ``nvcc`` each,
   all at once) into ``build/kernels/``,
3. kernel: each kernel against its plain PyTorch version on the card, at the
   training path's shape and at a large one, with gradients, noise moments
   and seed behaviour, and its time beside its bound,
4. slice: a few fp32 steps of a small config on the card against the same
   steps on the CPU (the kernels' plain versions), then 20 training steps of
   the flagship config (``configs/beta_vae_se.yaml`` at full width, demo data)
   with every kernel's launch count read around that run, then a
   ``torch.profiler`` breakdown of the device time per step by kernel,
5. kernels: one JSON line listing each kernel with its checks and numbers,
6. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth and the fp32 rate
# outside the tensor cores, both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# per element of fused_reparam_kl: 10 Philox rounds of ~10 integer
# operations, plus ~20 fp32 ones (2 conversions, 2 scalings, max, log,
# sqrt, cos, 2 exp and the multiplies and adds of z and kl), all counted at
# the fp32 rate
ELBO_OPS_PER_ELEMENT = 120
ELBO_SHAPES = ((32, 64), (65536, 64))   # the flagship's [batch, latent]; large
FLAGSHIP_STEPS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_elbo(shape, check_moments: bool) -> dict:
    """fused_reparam_kl on the card against its plain version."""
    import torch

    from betavae_tpu_torch.ops.elbo import (fused_reparam_kl, philox_normal,
                                            reparam_kl_forward,
                                            reparam_kl_reference)

    g = torch.Generator(device="cuda").manual_seed(1)
    mu = torch.randn(shape, generator=g, device="cuda")
    logvar = torch.randn(shape, generator=g, device="cuda").clamp(-10.0, 5.0)
    seed, offset = 115, 7

    z, kl, eps = reparam_kl_forward(mu, logvar, seed, offset)
    torch.cuda.synchronize()
    z_ref, kl_ref = reparam_kl_reference(mu, logvar, eps)
    # same eps, same order of fp32 operations, and only exp differing by
    # at most an ulp or so between the kernel and torch: 1e-5 relative
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_ref, rtol=1e-5, atol=1e-6)
    # the kernel's noise against the plain Philox/Box-Muller in torch: log,
    # sqrt and cos may differ by an ulp or two, |eps| < 5.7
    eps_plain = philox_normal(shape, seed, offset, device="cuda")
    torch.testing.assert_close(eps, eps_plain, rtol=1e-5, atol=1e-5)
    max_abs_err = max(float((z - z_ref).abs().max()),
                      float((kl - kl_ref).abs().max()))
    eps_err = float((eps - eps_plain).abs().max())

    # gradients through the autograd Function against autograd through the
    # plain version with the kernel's eps; the closed form and autograd
    # round in another order, so 1e-5 relative of the gradient's scale
    g_z = torch.randn(shape, generator=g, device="cuda")
    g_kl = torch.randn(shape, generator=g, device="cuda")
    mu_k, lv_k = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    zk, klk = fused_reparam_kl(mu_k, lv_k, seed, offset)
    ((zk * g_z).sum() + (klk * g_kl).sum()).backward()
    mu_p, lv_p = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    zp, klp = reparam_kl_reference(mu_p, lv_p, eps)
    ((zp * g_z).sum() + (klp * g_kl).sum()).backward()
    for got, want in ((mu_k.grad, mu_p.grad), (lv_k.grad, lv_p.grad)):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)

    _, _, eps_same = reparam_kl_forward(mu, logvar, seed, offset)
    _, _, eps_seed = reparam_kl_forward(mu, logvar, seed + 1, offset)
    _, _, eps_off = reparam_kl_forward(mu, logvar, seed, offset + 1)
    if not torch.equal(eps, eps_same):
        fail(f"elbo {shape}: the same (seed, offset) gave another eps")
    if torch.equal(eps, eps_seed) or torch.equal(eps, eps_off):
        fail(f"elbo {shape}: another seed or offset gave the same eps")

    out = {"shape": list(shape), "max_abs_err": max_abs_err,
           "eps_max_abs_err_vs_plain": eps_err}
    if check_moments:
        mean = float(eps.mean())
        std = float(eps.std())
        tail = float((eps.abs() > 1.0).float().mean())
        out.update(eps_mean=mean, eps_std=std, eps_p_abs_gt_1=tail)
        if not (abs(mean) < 0.01 and abs(std - 1.0) < 0.01
                and 0.30 < tail < 0.335):
            fail(f"elbo {shape}: eps moments off N(0,1): mean {mean}, "
                 f"std {std}, P(|eps|>1) {tail}")

    n = mu.numel()
    iters = 2000 if n < 100_000 else 200
    out["ms"] = cuda_ms(lambda: reparam_kl_forward(mu, logvar, seed, offset),
                        iters)

    def plain():
        e = philox_normal(shape, seed, offset, device="cuda")
        return reparam_kl_reference(mu, logvar, e)

    out["plain_ms"] = cuda_ms(plain, max(20, iters // 10))
    bytes_ms = 5 * n * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = ELBO_OPS_PER_ELEMENT * n / FP32_OPS_PER_S * 1e3
    out["bound_ms"] = max(bytes_ms, ops_ms)
    out["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return out


def write_config(src: str, root: str, name: str, **overrides) -> str:
    """A copy of ``src`` with every path under ``root``; ``overrides`` are
    ``section.key`` → value."""
    import yaml

    with open(src) as f:
        cfg = yaml.safe_load(f)
    cfg["paths"].update(
        raw_dir=os.path.join(root, "raw"),
        processed_dir=os.path.join(root, "processed"),
        outputs_dir=os.path.join(root, "outputs"),
        models_dir=os.path.join(root, "outputs", "models"),
        figures_dir=os.path.join(root, "outputs", "figures"),
        tables_dir=os.path.join(root, "outputs", "tables"))
    for key, val in overrides.items():
        sec, name_ = key.split(".")
        cfg[sec][name_] = val
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def check_small_slice(tmp: str) -> dict:
    """Three fp32 steps of a small config on the card and on the CPU.  Both
    draw the same Philox noise (kernel on the card, plain torch on the CPU),
    start from the same seeded weights and see the same batches, with
    augmentation off (its generators differ by device) and TF32 off."""
    import torch

    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.ops.elbo import fused_reparam_kl
    from betavae_tpu_torch.train.loop import train_steps

    root = os.path.join(tmp, "small")
    cfg = write_config(
        "configs/beta_vae_se.yaml", root, "small.yaml",
        **{"data.image_size": 32, "model.base_channels": 8,
           "model.latent_dim": 8, "model.num_blocks": 2,
           "training.batch_size": 8, "training.mixed_precision": False,
           "augmentation.use_augmentations": False,
           "logging.log_to_file": False, "logging.log_every_n_steps": 100})
    generate_demo_data(os.path.join(root, "processed"), train_per_class=4,
                       test_per_class=1, size=32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = fused_reparam_kl.launches
        gpu = train_steps(cfg, 3, device="cuda")["totals"]
        gpu_launches = fused_reparam_kl.launches - before
        reset_logger()
        cpu = train_steps(cfg, 3, device="cpu")["totals"]
        reset_logger()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    # fp32 on both sides, summed in other orders; Adam carries the
    # difference into the next step: 1e-3 relative over three steps
    rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(gpu, cpu))
    if not (len(gpu) == len(cpu) == 3 and rel < 1e-3 and gpu_launches == 3):
        fail(f"small slice: card {gpu} ({gpu_launches} kernel launches) vs "
             f"CPU {cpu} (max rel {rel})")
    return {"phase": "slice_vs_cpu", "gpu_totals": gpu, "cpu_totals": cpu,
            "max_rel_diff": rel, "gpu_kernel_launches": gpu_launches}


def run_flagship(tmp: str, kernels: dict) -> dict:
    """FLAGSHIP_STEPS steps of configs/beta_vae_se.yaml at full width."""
    import torch

    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    root = os.path.join(tmp, "flagship")
    cfg = write_config("configs/beta_vae_se.yaml", root, "flagship.yaml")
    # 24 per class x 4 classes = 96 images: three full batches of 32
    generate_demo_data(os.path.join(root, "processed"), train_per_class=24,
                       test_per_class=4, size=128)
    for wrapper in kernels.values():
        wrapper.launches = 0
    out = train_steps(cfg, FLAGSHIP_STEPS)
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    reset_logger()
    totals = out["totals"]
    if len(totals) != FLAGSHIP_STEPS or not all(map(math.isfinite, totals)):
        fail(f"flagship: expected {FLAGSHIP_STEPS} finite losses, got {totals}")
    for name, n in launches.items():
        if n != FLAGSHIP_STEPS:
            fail(f"flagship: kernel {name} launched {n} times in "
                 f"{FLAGSHIP_STEPS} steps")
    step_ms = out["timed_seconds"] / out["timed_steps"] * 1e3
    return {"phase": "flagship", "steps": out["steps"], "launches": launches,
            "first_total": totals[0], "last_total": totals[-1],
            "timed_steps": out["timed_steps"], "step_ms": step_ms,
            "img_per_s": out["batch_size"] * 1e3 / step_ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def profile_flagship(tmp: str, step_ms: float) -> dict:
    """Device time per flagship step by kernel (``torch.profiler``) over a
    second short run of the same config; its busy share is the device time
    per step over the unprofiled run's step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    cfg = os.path.join(tmp, "flagship", "flagship.yaml")
    steps = 8
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_steps(cfg, steps)
    reset_logger()
    # device activity only: kernels, copies and fills, not the ranges that
    # annotations such as Optimizer.step project onto the device track
    work = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]
    per_kernel = {}
    for evt in work:
        per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + \
            evt.device_time_total / 1e3 / steps
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "profile", "steps": steps,
            "device_ms_per_step": device_ms,
            "elbo_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "reparam_kl_kernel" in name),
            "device_busy_share": device_ms / step_ms,
            "kernels_per_step": len(work) / steps,
            "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top]}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    # the port itself: absent when this script stands alone
    from betavae_tpu_torch import _build
    from betavae_tpu_torch.ops.elbo import fused_reparam_kl

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    per_kernel = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": per_kernel,
          "ptxas": {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                           if "registers" in ln or "bytes stack" in ln]
                    for name in per_kernel}})

    elbo = {f"{s[0]}x{s[1]}": check_elbo(s, check_moments=s[0] >= 65536)
            for s in ELBO_SHAPES}
    emit({"phase": "kernel", "name": "fused_reparam_kl", "card": card,
          "checks": elbo})

    kernels = {"fused_reparam_kl": fused_reparam_kl}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        emit(check_small_slice(tmp))
        flagship = run_flagship(tmp, kernels)
        flagship["card"] = card
        emit(flagship)
        profiled = profile_flagship(tmp, flagship["step_ms"])
        emit(profiled)

    main_shape = f"{ELBO_SHAPES[0][0]}x{ELBO_SHAPES[0][1]}"
    row = elbo[main_shape]
    emit({"kernels": [{
        "name": "fused_reparam_kl",
        "route": "cuda",
        "source": "betavae_tpu_torch/csrc/elbo.cu",
        "replaces": "betavae_tpu/ops/pallas_elbo.py:69",
        "launches": flagship["launches"]["fused_reparam_kl"],
        "max_abs_err": max(c["max_abs_err"] for c in elbo.values()),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        # the kernel alone on the device in the flagship steps (profiler),
        # where "ms" above is a launch through the wrapper, host included
        "device_ms": profiled["elbo_kernel_device_ms_per_step"],
        "check": "ok",
        "card": card,
        "shapes": elbo,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
