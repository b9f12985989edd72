#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``betavae_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero at once):

1. device: fails without CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them,
2. build: compiles every ``betavae_tpu_torch/csrc/*.cu`` (one ``nvcc`` each,
   all at once) into ``build/kernels/``,
3. kernel: each kernel against its plain PyTorch version on the card, with
   gradients, and its time beside its bound, its plain version's and (where
   one PyTorch call computes the same function) that call's: reparam+KL at
   the training path's shape and a large one (noise moments, seed
   behaviour), the SE-gate∘head-conv forward and M kernels at the
   flagship's y in bf16 and fp32 and at a ragged shape,
4. slice: 3 fp32 steps of a small config on the card against the same steps
   on the CPU (the kernels' plain versions), with the default head and with
   ``training.fused_head: true``; 20 training steps of the flagship config
   (``configs/beta_vae_se.yaml`` at full width, demo data), with the
   default head and with the fused head; the epoch trainer ``train()`` on
   the flagship with the fused head for 2 epochs and then ``resume
   latest`` for a third; every kernel's launch count is set to 0 just
   before each of these runs and read just after; then a ``torch.profiler``
   breakdown of the device time per step by kernel, default and fused head,
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
# the decoder's last activation y [B, C, H, W] at the flagship (bf16 under
# autocast, fp32 without), and a ragged shape for the tiles' edges
HEAD_CASES = (((32, 64, 128, 128), "bfloat16"), ((32, 64, 128, 128), "float32"),
              ((3, 64, 37, 53), "float32"))
FLAGSHIP_STEPS = 20
EPOCHS_FIRST, EPOCHS_TOTAL = 2, 3


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


def head_inputs(shape, dtype_name: str, seed: int = 0):
    import torch

    b, c, h, w = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(shape, generator=g, device="cuda").to(dtype)
    s = torch.rand(b, c, generator=g, device="cuda").to(dtype)
    k = torch.randn(c, 3, 3, generator=g, device="cuda")
    dy = torch.randn(b, h, w, generator=g, device="cuda")
    return y, s, k, dy


def check_head(shape, dtype_name: str) -> dict:
    """The head's forward and M kernels on the card against their plain
    versions (fp32 from the same values), gradients through the autograd
    Function against autograd through the plain version, and times."""
    import torch
    import torch.nn.functional as F

    from betavae_tpu_torch.ops.head import (fused_se_conv_head,
                                            head_conv_reference, head_forward,
                                            head_m, head_m_reference)

    y, s, k, dy = head_inputs(shape, dtype_name)
    b, c, h, w = shape
    # the plain forward is an fp32 cuDNN conv: no TF32 in the reference
    torch.backends.cudnn.allow_tf32 = False
    out = head_forward(y, s, k)
    m = head_m(y, dy)
    torch.cuda.synchronize()
    checks = {}
    for name, got, want in (("forward", out, head_conv_reference(y, s, k)),
                            ("m", m, head_m_reference(y, dy))):
        # fp32 sums of the same products in another order: 1e-5 relative
        # plus 1e-5 of the largest |value|
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
        checks[name] = {"max_abs_err": float((got - want).abs().max()),
                        "max_abs_ref": scale}

    # gradients: the Function (M kernel + torch ops) against autograd
    # through the plain version; dy_y and ds are rounded once to the
    # inputs' dtype, so in bf16 they are held to its precision, while dk
    # comes back fp32, summed from fp32 M: 1e-5 in both dtypes
    yk, sk_, kk = (t.clone().requires_grad_() for t in (y, s, k))
    (fused_se_conv_head(yk, sk_, kk) * dy).sum().backward()
    yp, sp, kp = (t.float().clone().requires_grad_() for t in (y, s, k))
    (head_conv_reference(yp, sp, kp) * dy).sum().backward()
    rounded = 1e-5 if dtype_name == "float32" else 2**-8
    grad_err = {}
    for name, got, want, tol in (("y", yk.grad, yp.grad, rounded),
                                 ("s", sk_.grad, sp.grad, rounded),
                                 ("k", kk.grad, kp.grad, 1e-5)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * scale)
        grad_err[name] = float((got.float() - want).abs().max())
    checks["grad_max_abs_err"] = grad_err
    del yk, sk_, kk, yp, sp, kp

    big = b * c * h * w >= 1 << 24
    iters = 50 if big else 500
    plain_iters = 10 if big else 100
    fwd = {"ms": cuda_ms(lambda: head_forward(y, s, k), iters),
           "plain_ms": cuda_ms(lambda: head_conv_reference(y, s, k),
                               plain_iters)}
    mk = {"ms": cuda_ms(lambda: head_m(y, dy), iters),
          "plain_ms": cuda_ms(lambda: head_m_reference(y, dy), plain_iters)}
    # M's library call: one grouped cuDNN conv with each sample's dy as its
    # H×W filter, conv2d(y^T [C, B, H, W], dy [B, 1, H, W], padding=1,
    # groups=B)[c, b, dh, dw] = M[b, 3·dh+dw, c]; TF32 off, so exact in
    # fp32; for bf16 y, dy is cast to bf16 and the output comes out bf16
    y_t, dy_w = y.transpose(0, 1), dy[:, None].to(y.dtype)
    m_lib = F.conv2d(y_t, dy_w, padding=1, groups=b)
    m_lib = m_lib.permute(1, 2, 3, 0).reshape(b, 9, c).float()
    want = head_m_reference(y, dy_w[:, 0])
    lib_tol = 1e-5 if dtype_name == "float32" else 2**-8
    scale = float(want.abs().max())
    torch.testing.assert_close(m_lib, want, rtol=lib_tol, atol=lib_tol * scale)
    mk["library_max_abs_err"] = float((m_lib - want).abs().max())
    mk["library_ms"] = cuda_ms(
        lambda: F.conv2d(y_t, dy_w, padding=1, groups=b), plain_iters)
    torch.backends.cudnn.allow_tf32 = True   # PyTorch's default again
    # the unfused head's own call: one cuDNN conv of the pre-gated y in the
    # working dtype, at PyTorch's default TF32 setting
    y_gated = y * s[:, :, None, None]
    w4 = k[None].to(y.dtype)
    fwd["library_ms"] = cuda_ms(lambda: F.conv2d(y_gated, w4, padding=1),
                                iters)
    # whole backward of the head: the unfused gate + conv through autograd
    # against the fused Function (M kernel + dk, ds, dy_y in torch ops)
    g_out = dy[:, None].to(y.dtype)
    yr, sr, wr = (t.clone().requires_grad_() for t in (y, s, w4))
    unfused = F.conv2d(yr * sr[:, :, None, None], wr, padding=1)
    mk["unfused_head_backward_ms"] = cuda_ms(
        lambda: torch.autograd.grad(unfused, (yr, sr, wr), g_out,
                                    retain_graph=True), plain_iters)
    kr = k.clone().requires_grad_()
    fused = fused_se_conv_head(yr, sr, kr)
    mk["fused_head_backward_ms"] = cuda_ms(
        lambda: torch.autograd.grad(fused, (yr, sr, kr), dy,
                                    retain_graph=True), plain_iters)

    y_bytes = y.numel() * y.element_size()
    ops = 18 * b * c * h * w            # 9 taps × (multiply + add) per y·k
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    for row, nbytes in (
            (fwd, y_bytes + s.numel() * s.element_size() + k.numel() * 4
             + b * h * w * 4),
            (mk, y_bytes + b * h * w * 4 + b * 9 * c * 4)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return {"shape": list(shape), "dtype": dtype_name, "checks": checks,
            "forward": fwd, "m": mk}


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


def zero_counts(kernels: dict) -> None:
    for wrapper in kernels.values():
        wrapper.launches = 0


def read_counts(kernels: dict) -> dict:
    return {name: wrapper.launches for name, wrapper in kernels.items()}


def check_small_slice(tmp: str, kernels: dict, fused_head: bool) -> dict:
    """Three fp32 steps of a small config on the card and on the CPU.  Both
    draw the same Philox noise (kernel on the card, plain torch on the CPU),
    start from the same seeded weights and see the same batches, with
    augmentation off (its generators differ by device) and TF32 off.  Every
    kernel of the path launches once per step on the card."""
    import torch

    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    root = os.path.join(tmp, "small")
    name = "small_fused.yaml" if fused_head else "small.yaml"
    cfg = write_config(
        "configs/beta_vae_se.yaml", root, name,
        **{"data.image_size": 32, "model.base_channels": 8,
           "model.latent_dim": 8, "model.num_blocks": 2,
           "training.batch_size": 8, "training.mixed_precision": False,
           "training.fused_head": fused_head,
           "augmentation.use_augmentations": False,
           "logging.log_to_file": False, "logging.log_every_n_steps": 100})
    if not os.path.isdir(os.path.join(root, "processed")):
        generate_demo_data(os.path.join(root, "processed"), train_per_class=4,
                           test_per_class=1, size=32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        zero_counts(kernels)
        gpu = train_steps(cfg, 3, device="cuda")["totals"]
        launches = read_counts(kernels)
        reset_logger()
        cpu = train_steps(cfg, 3, device="cpu")["totals"]
        reset_logger()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want = {name: 3 if fused_head or name == "fused_reparam_kl" else 0
            for name in kernels}
    # fp32 on both sides, summed in other orders; Adam carries the
    # difference into the next step: 1e-3 relative over three steps
    rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(gpu, cpu))
    if not (len(gpu) == len(cpu) == 3 and rel < 1e-3 and launches == want):
        fail(f"small slice (fused_head {fused_head}): card {gpu} (kernel "
             f"launches {launches}, want {want}) vs CPU {cpu} (max rel {rel})")
    return {"phase": "slice_vs_cpu", "fused_head": fused_head,
            "gpu_totals": gpu, "cpu_totals": cpu, "max_rel_diff": rel,
            "gpu_kernel_launches": launches}


def flagship_config(tmp: str, fused_head: bool) -> str:
    """configs/beta_vae_se.yaml at full width over seeded 128 px demo data
    (24 train and 4 test images per class: three full batches of 32)."""
    from betavae_tpu_torch.data.demo import generate_demo_data

    root = os.path.join(tmp, "flagship")
    name = "flagship_fused.yaml" if fused_head else "flagship.yaml"
    cfg = write_config("configs/beta_vae_se.yaml", root, name,
                       **{"training.fused_head": fused_head})
    if not os.path.isdir(os.path.join(root, "processed")):
        generate_demo_data(os.path.join(root, "processed"),
                           train_per_class=24, test_per_class=4, size=128)
    return cfg


def run_flagship(tmp: str, kernels: dict, fused_head: bool) -> dict:
    """FLAGSHIP_STEPS steps of the flagship at full width; every kernel of
    the path launches once per step."""
    import torch

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    cfg = flagship_config(tmp, fused_head)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    out = train_steps(cfg, FLAGSHIP_STEPS)
    launches = read_counts(kernels)
    reset_logger()
    totals = out["totals"]
    if len(totals) != FLAGSHIP_STEPS or not all(map(math.isfinite, totals)):
        fail(f"flagship: expected {FLAGSHIP_STEPS} finite losses, got {totals}")
    want = {name: (FLAGSHIP_STEPS if fused_head or name == "fused_reparam_kl"
                   else 0) for name in kernels}
    if launches != want:
        fail(f"flagship (fused_head {fused_head}): kernel launches "
             f"{launches} in {FLAGSHIP_STEPS} steps, want {want}")
    step_ms = out["timed_seconds"] / out["timed_steps"] * 1e3
    return {"phase": "flagship", "fused_head": fused_head,
            "steps": out["steps"], "launches": launches,
            "first_total": totals[0], "last_total": totals[-1],
            "timed_steps": out["timed_steps"], "step_ms": step_ms,
            "img_per_s": out["batch_size"] * 1e3 / step_ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def profile_flagship(tmp: str, step_ms: float, fused_head: bool) -> dict:
    """Device time per flagship step by kernel (``torch.profiler``) over a
    second short run of the same config; its busy share is the device time
    per step over the unprofiled run's step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    cfg = flagship_config(tmp, fused_head)
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
    return {"phase": "profile", "fused_head": fused_head, "steps": steps,
            "device_ms_per_step": device_ms,
            "elbo_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "reparam_kl_kernel" in name),
            "head_fwd_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "head_fwd_kernel" in name),
            "head_m_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "head_m_kernel" in name),
            "device_busy_share": device_ms / step_ms,
            "kernels_per_step": len(work) / steps,
            "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top]}


def metrics_lines(log_path: str) -> list:
    with open(log_path) as f:
        return [json.loads(line.split("| METRICS ", 1)[1])
                for line in f if "| METRICS " in line]


def run_epochs(tmp: str, kernels: dict) -> dict:
    """The epoch trainer on the flagship at full width with the fused head:
    EPOCHS_FIRST epochs, then ``resume="latest"`` with ``training.epochs``
    raised to EPOCHS_TOTAL.  Every epoch must log finite train, val and
    epoch_end lines; latest and best must stand as 2 shards each; the
    resumed run must start at epoch EPOCHS_FIRST + 1 with the step count
    carried over; and each kernel must launch once per forward that runs
    it: head forward per train step, val batch and panel, M per train
    step, reparam+KL per train step and val batch."""
    import torch

    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.io.checkpoint import discover_shards
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train

    root = os.path.join(tmp, "epochs")
    common = {"training.fused_head": True, "logging.log_every_n_steps": 1}
    first = write_config("configs/beta_vae_se.yaml", root, "first.yaml",
                         **common, **{"training.epochs": EPOCHS_FIRST})
    resumed = write_config("configs/beta_vae_se.yaml", root, "resumed.yaml",
                           **common, **{"training.epochs": EPOCHS_TOTAL})
    generate_demo_data(os.path.join(root, "processed"), train_per_class=24,
                       test_per_class=4, size=128)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    out1 = train(first)
    reset_logger()
    out2 = train(resumed, resume="latest")
    reset_logger()
    seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30

    lines = metrics_lines(os.path.join(root, "outputs", "logs",
                                       "beta_vae_se.log"))
    for phase in ("train", "val", "epoch_end"):
        epochs = sorted({m["epoch"] for m in lines if m["phase"] == phase})
        if epochs != list(range(1, EPOCHS_TOTAL + 1)):
            fail(f"epochs: {phase} lines for epochs {epochs}")
    for m in lines:
        bad = [k for k, v in m.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            fail(f"epochs: non-finite {bad} in {m}")
    train_lines = [m for m in lines if m["phase"] == "train"]
    steps_per_epoch = out1["total_steps"] // EPOCHS_FIRST
    resumed_first = next(m for m in train_lines if m["epoch"] == EPOCHS_FIRST + 1)
    if (out1["epoch"], out2["epoch"]) != (EPOCHS_FIRST, EPOCHS_TOTAL) or \
            resumed_first["step"] != out1["total_steps"] + 1 or \
            out2["total_steps"] != EPOCHS_TOTAL * steps_per_epoch:
        fail(f"epochs: resume did not continue the run: first run "
             f"{out1['epoch']} epochs / {out1['total_steps']} steps, resumed "
             f"{out2['epoch']} / {out2['total_steps']}, first resumed line "
             f"{resumed_first}")
    shards = {tag: len(discover_shards(os.path.join(
        root, "outputs", "models", f"beta_vae_se_{tag}.pt")))
        for tag in ("latest", "best")}
    if shards != {"latest": 2, "best": 2}:
        fail(f"epochs: checkpoint shards {shards}")
    val_lines = [m for m in lines if m["phase"] == "val"]
    val_batches = -(-4 * 4 // 32)       # 16 test images in batches of 32
    train_steps = out2["total_steps"]
    want = {"head_forward": train_steps + EPOCHS_TOTAL * (val_batches + 1),
            "head_m": train_steps,
            "fused_reparam_kl": train_steps + EPOCHS_TOTAL * val_batches}
    if launches != want:
        fail(f"epochs: kernel launches {launches}, want {want}")
    return {"phase": "epochs", "epochs": EPOCHS_TOTAL,
            "resumed_at_epoch": resumed_first["epoch"],
            "train_steps": train_steps, "val_batches_per_epoch": val_batches,
            "launches": launches, "seconds": seconds,
            "train_images_per_sec": [m["train_images_per_sec"]
                                     for m in val_lines],
            "steady_train_images_per_sec": [m["train_images_per_sec"]
                                            for m in val_lines[1:]],
            "val_total_loss": [m["val_total_loss"] for m in val_lines],
            "latent_probe_auc": [m["latent_probe_auc"] for m in val_lines],
            "epoch_wall_seconds": [m["epoch_wall_seconds"] for m in lines
                                   if m["phase"] == "epoch_end"],
            "peak_mem_gib": peak}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    # the port itself: absent when this script stands alone
    from betavae_tpu_torch import _build
    from betavae_tpu_torch.ops.elbo import fused_reparam_kl
    from betavae_tpu_torch.ops.head import head_forward, head_m

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
    heads = [check_head(shape, dtype) for shape, dtype in HEAD_CASES]
    emit({"phase": "kernel", "name": "fused_se_conv_head", "card": card,
          "cases": heads})

    kernels = {"fused_reparam_kl": fused_reparam_kl,
               "head_forward": head_forward, "head_m": head_m}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        emit(check_small_slice(tmp, kernels, fused_head=False))
        emit(check_small_slice(tmp, kernels, fused_head=True))
        flagship = run_flagship(tmp, kernels, fused_head=False)
        flagship["card"] = card
        emit(flagship)
        flagship_fused = run_flagship(tmp, kernels, fused_head=True)
        flagship_fused["card"] = card
        emit(flagship_fused)
        epochs = run_epochs(tmp, kernels)
        epochs["card"] = card
        emit(epochs)
        profiled = profile_flagship(tmp, flagship["step_ms"], fused_head=False)
        emit(profiled)
        profiled_fused = profile_flagship(tmp, flagship_fused["step_ms"],
                                          fused_head=True)
        profiled_fused["card"] = card
        emit(profiled_fused)

    # the kernels' numbers at the main path's shapes: reparam+KL at the
    # flagship's [32, 64], the head at the flagship's bf16 y (autocast)
    main_shape = f"{ELBO_SHAPES[0][0]}x{ELBO_SHAPES[0][1]}"
    row = elbo[main_shape]
    head_main = heads[0]

    def by_path(name):
        return {"epochs": epochs["launches"][name],
                "flagship": flagship["launches"][name],
                "flagship_fused_head": flagship_fused["launches"][name]}

    emit({"kernels": [{
        "name": "fused_reparam_kl",
        "route": "cuda",
        "source": "betavae_tpu_torch/csrc/elbo.cu",
        "replaces": "betavae_tpu/ops/pallas_elbo.py:69",
        "launches": epochs["launches"]["fused_reparam_kl"],
        "launches_by_path": by_path("fused_reparam_kl"),
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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "betavae_tpu_torch/csrc/head.cu",
        "replaces": replaces,
        "launches": epochs["launches"][name],
        "launches_by_path": by_path(name),
        "max_abs_err": max(c["checks"][part]["max_abs_err"] for c in heads),
        "ms": head_main[part]["ms"],
        "plain_ms": head_main[part]["plain_ms"],
        "bound_ms": head_main[part]["bound_ms"],
        "bound_by": head_main[part]["bound_by"],
        "library_ms": head_main[part]["library_ms"],
        "device_ms": profiled_fused[f"{profile_key}_device_ms_per_step"],
        "check": "ok",
        "card": card,
        "shapes": [{"shape": c["shape"], "dtype": c["dtype"], **c[part],
                    **c["checks"][part]} for c in heads],
    } for name, part, replaces, profile_key in (
        ("head_forward", "forward", "betavae_tpu/ops/pallas_head.py:127",
         "head_fwd_kernel"),
        ("head_m", "m", "betavae_tpu/ops/pallas_head.py:152",
         "head_m_kernel"))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
