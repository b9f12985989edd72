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
   one PyTorch call computes the same function) that call's: the reparam+KL
   forward and backward kernels at the training path's shape, the
   evaluation path's smaller ones, the demo notebook's [16, 16] and a
   large one, each with its offset as a 0-d int64 tensor on the card (the
   trainers' slot) and as an int, bitwise alike (ε bitwise the plain
   Philox stream, noise moments, seed behaviour;
   a data-parallel rank's launch at [16, 64] with ``start`` 16·64 bitwise
   rows 16–31 of the [32, 64] launch, both offset kinds;
   the backward also with capacity mode's broadcast g_kl; the forward with
   programmatic dependent launch off and on in turns, alone and chained
   behind the logvar clamp, eager and replayed from a CUDA graph; the
   backward beside the plain closed form's time and kernel count), a race
   check of the forward behind kernels writing its inputs and its offset
   (1000 times), where a reparam+KL call's host time goes, the
   graph-replayed chain for a variant of the forward's source (no
   ``launch_dependents``); the forward captured once in a CUDA graph and
   replayed at 3 offsets written to its slot, ε bitwise the plain Philox
   stream at each, and the clamp → forward chain in a graph with
   programmatic dependent launch off and on in turns
   (``elbo_device_offset``), the SE-gate∘head-conv forward
   and M kernels at the flagship's y in bf16 and fp32, at the evaluation
   path's bf16 decodes of 1, 2, 7 and 8 rows and at a ragged shape
   (each with the path it took, TMA or generic, its device time, and two
   launches held bitwise equal), the GroupNorm(1)+ReLU+pool
   forward and backward kernels at the flagship's eight block
   shapes in bf16, its largest in fp32, a ragged shape, the bench
   canary's and the scaled config's ten blocks at batch 256 in bf16 (each
   with its backward's path, cluster or generic, one call a launch (the
   forward's path always generic), pooled against
   the mean of the y it returns,
   its device time back to back and after clean and dirty L2 flushes, the
   host's microseconds a call, and two launches held bitwise
   equal; every block but dec3, and the canary, must take the cluster
   path backward), each beside ``F.group_norm`` and the unfused sequence the port's
   blocks run; where a GN call's host time goes at the canary; dec3's
   bf16 sample's backward on a non-portable cluster of 16 against the
   generic path;
   and the bilinear ×2 upsample's forward and gather-backward kernels at
   the flagship decoder's four shapes in bf16 and fp32, a ragged shape,
   the scaled config's five shapes (B = 256, bf16) and the demo
   notebook's three (B = 16, fp32), on the path the
   rule gives and on each path forced (vector where the rule allows it,
   generic), each bitwise its plain version, two launches bitwise equal,
   both paths' device times in turns (generic, vector, vector, generic)
   beside the bound, the plain version and ``F.interpolate``'s forward
   and autograd backward; a kernel's device time is CUDA events around a
   CUDA graph of calls (every kernel a call launches: the
   ``timed_calls`` line counts them), a call that launches no kernel of
   its wrapper fails, and ``torch.profiler`` only confirms the kernels (a
   window that misses them is retried, then reported there),
4. slice: 3 fp32 steps of a small config on the card against the same steps
   on the CPU (the kernels' plain versions), with the default head and with
   ``training.fused_head: true``; 20 training steps of the flagship config
   (``configs/beta_vae_se.yaml`` at full width, demo data), with the
   default head and with the fused head; replay: those 20 steps twice from
   one seed with each head, and in fp32 with the default head, every
   total bitwise the first run's; scan_chunks: the flagship's 20 steps of
   one epoch at ``training.scan_chunk_steps`` K = 1 (eager), 8 and 20 (a
   launch of the captured step's CUDA graph from the device a step),
   bf16 with each head (the default head's in turns, K = 1, 8, 20, 20, 8,
   1) and fp32 with the default head: every total bitwise across K, each
   kernel's launches as derived and a replay's one step's, one launch
   from the device a step, step ms, each chunk's dispatch host seconds,
   capture seconds and peak memory, the device time a step and busy share
   at K = 1 and 20; then ``train()`` 2 epochs with validation at K = 3
   against K = 1, every METRICS number bitwise but the wall times; then
   whether 182 launches of the step from the device return at once behind
   a running chunk, against 182 launches of the same graph from the host
   (host seconds of each, of a chunk's draws and of its dispatch; capture
   seconds, peak memory; the rows bitwise both ways), and the same two
   chunks on the path of one of several ranks (``forced_host_path``: the
   step's graph launched from the host, each dispatch a job of the
   dispatcher thread): the dispatch behind the running chunk within 0.05
   s with its job still to run, the rows bitwise the device-launched
   ones (the
   trainers run K-step chunks of replays wherever the main path below runs
   them, under a one-rank NCCL mesh and fed from the host too: every
   phase's default K is 192, and ``train()`` rotates its epochs);
   ``configs/beta_vae_se_tpu_scaled.yaml`` at full width (256 px, 5
   blocks, latent 128, global batch 256) through the training CLI with
   ``--data-parallel -1``, 2 epochs of 2 steps over seeded 256 px demo
   data, at the config's ``scan_chunk_steps: 16`` (replays, NCCL inside
   the graph) and at 1 (finite lines, bitwise between the two but the
   wall times, each kernel's launches, no CONFIG note, step ms, peak
   memory); the
   packed-dataset decoder (g++ and the libpng/libjpeg headers on this
   host, the decoder ``load_split`` took on the bench's e2e data, its
   seconds native and with PIL); the epoch trainer ``train()`` on
   the flagship with the fused head for 2 epochs and then ``resume
   latest`` for a third, its checkpoints written by the background writer
   (``training.async_checkpoint`` of the flagship config); epoch rotation
   and the background panel writer (phase ``rotation``): ``train()`` on
   that config for 3 epochs with ``training.epoch_rotation`` on and off in
   turns (every METRICS line but the host times, ``latest`` and ``best``
   bitwise, ``rotated`` on epochs 1–2 only, launches as derived, every
   panel there when ``train()`` returns), then an early stop at epoch 2
   under rotation (the returned model and optimizer bitwise ``latest``,
   the discarded chunk's launches counted), and a fifth run on the path of
   one of several ranks, every check against the first and its rotated
   dispatch within 0.05 s; the
   evaluation's sampling forward and latents of a small fp32 checkpoint on
   the card against the CPU (1e-3 relative, probe metrics 0.05);
   ``train()`` on ``configs/beta_vae_se_debug.yaml`` as it is (its
   ``debug:`` limits, 2 epochs, LPIPS with random-init features allowed),
   whose LPIPS term must be finite and above 0 in every line; the demo
   notebook (``notebooks/train_and_eval_torch.ipynb``, phase
   ``notebook``): every code cell in order on the card in a copy of it
   and ``configs/demo_notebook.yaml`` (64 px, 3 blocks, latent 16, fp32;
   TF32 off), each kernel's launches cell by cell as the cells derive
   them (0 generic upsample launches), the reconstruction figure a PIL
   image, and the same ``best`` checkpoint evaluated on the CPU (the
   reconstruction metrics and latents within 1e-3 relative, the report's
   other numbers within 0.05, NaN equal to NaN), with each cell's
   seconds, the run's peak memory and the files written; the port's
   bench (``python -m betavae_tpu_torch.bench`` in-process at ``--steps 96
   --warmup 32 --e2e-epochs 3``: steady state, e2e epochs at the reference
   dataset's scale, encode latencies, PRNG check and the kernel canary,
   which is the GN kernels' path), and then the bench's e2e estimator for
   3 epochs with rotation on and off in turns (phase ``rotation_e2e``:
   pooled rate, tail seconds and train images/s an epoch against the
   unrotated runs', each chunk's dispatch seconds, capture seconds, peak
   memory; a rotated epoch's ``rotate_dispatch_seconds`` over 0.05 s
   fails; a fifth run on the path of one of several ranks, its 182 host
   launches a chunk on the dispatcher thread, under the same limit); the
   data-parallel path on the fused
   flagship at full width (global batch 32; ``betavae_tpu_torch/
   parallel/``): one NCCL rank in this process (an epoch of 20 steps of
   ``train_steps`` as one chunk of 20 replays, in turns with the single
   process: every total bitwise, launches a replay's one step and the
   warm-up, the gradient all-reduce among the collectives captured, no
   CONFIG note; one fp32 backward's gradients within 1e-5, step ms, busy
   share and NCCL kernels a step), two ranks sharing the card over gloo in
   their own processes (10 eager steps, 16 rows each, the CONFIG line's
   ``step_dispatch`` ``eager: gloo``: first total 1e-3 relative, one fp32
   backward's gradients 1e-4, both ranks' parameters bitwise equal, each
   kernel once a step a rank), the dry run on those two ranks and the
   bench's ``--data-parallel 1`` line (replayed) beside its steady line,
   with the analytic 8-GPU prediction; the evaluation and inference CLIs in
   process on the epoch trainer's ``best`` checkpoint (``latent_analysis``,
   ``run_evaluation``, ``encode``, ``generate --seed 3``, over the bench's
   e2e data, 4 × 1456 train and 4 × 328 test images at 128 px: every
   artifact, finite tables, SSIM in [0, 1], the traversal dims of the
   ranking, the seconds of each CLI, the encoder's images/s in 5 passes
   and which of matplotlib, pandas, scikit-learn, umap and PIL the install
   has); the port's remaining CLIs (``betavae_tpu_torch/scripts/``, phase
   ``scripts``): ``preprocess_data`` over raw trees of 4 × 1784 images at
   256 px as class folders (the seeded 80/20 split) and as
   ``Training/Testing`` (copied through), then ``global_z`` on a copy,
   ``reshard_checkpoint`` of the epoch trainer's ``best`` from 2 to 4
   shards (bitwise) and the refused shrink, ``preview_val_batch`` twice
   (equal manifests), ``traverse_image`` on one test image (the head
   forward once a decode, all TMA, no reparam+KL launch),
   ``diag_overfit`` (the reparam+KL forward once a batch, no backward),
   ``diag_overfit`` on ``configs/overfit_capacity.yaml`` over a 128 px
   tree read at its 256 px, ``generate_umap_and_grid`` on ``best`` and the
   evaluation's traversal figures (a GIF of 60 frames, the grid),
   the four log tools on the epoch trainer's log and panels, and
   ``parity_check --run-eval`` against the evaluation's tables (exit 0),
   with each CLI's seconds and the preprocessing's images/s a stage; the
   flagship's fused step at ``training.remat`` false, decoder,
   true and false again (20 steps each: first totals within 1e-5
   relative, the launches of a step unchanged, each mode's step ms and
   peak memory, every mode's totals and the rerun's bitwise false's at
   every step), and one fp32
   backward from the same state at each mode (loss bitwise, gradients
   within 1e-5); one fp32 backward three times from one state with
   cuDNN's default algorithms and with ``cudnn.deterministic``, and the
   fp32 and bf16 flagship's step ms with the trainer's cuDNN setting
   patched out and in, in turns (reported); the epoch trainer's
   ``latest`` exported with its Adam
   state by ``python -m betavae_tpu_torch.io.export_torch_checkpoint`` to
   the reference's torch-pickle shards and resumed for one more epoch
   beside a copy of the native checkpoint (first total within 1e-5
   relative, the loaded moments bitwise, ``infer.encode`` latents within
   1e-5 relative; the export's and the load's seconds); ``train()`` with
   both splits fed from the host (chunks of replays, a chunk's batches
   one upload) against the same run with them on the device (every
   logged total bitwise, and a device-fed rerun's, the same launches, the
   capture's warm-up included), every host-fed batch of an e2e epoch
   bitwise the resident gather, then host feed and device feed one after
   the other:
   the e2e rate over the bench's data (2 epochs each), the fused
   flagship step's ms, device ms and busy share; ``train()`` with
   ``logging.profile_steps: 5``,
   whose traces (steps 1-3 and 4-5) ``utils/trace.py`` reads, each fused
   step's kernels once a step, its device total per step beside the
   ``profile`` phase's; every kernel's launch count is set to 0
   just before each of these runs and read just after, every head kernel
   launch there must have taken the TMA path, every upsample launch the
   vector path, and the GN kernels launch once an encoder or decoder
   block each way a step (by path, in the bench: every forward generic,
   the canary's backward on the cluster path, then 7 cluster backward
   launches to each generic one) (in
   the evaluation, the reparam+KL forward once
   per test batch, panel and prior draw, the head forward once per decode,
   nothing else); then a
   ``torch.profiler`` breakdown of the device time per step by kernel,
   default and fused head,
5. kernels: one JSON line listing each kernel with its checks and numbers,
6. the last line: ``{"ok": true, "device": {...}}``.

Every phase line carries ``elapsed_s`` (the script's seconds so far) and
``phase_s`` (the seconds since the phase line before it).

``python3 chip_smoke.py --mesh`` (two or more cards of one host) runs the
build, then phase ``mesh`` alone: the scaled config over every card (NCCL)
at K 16 against K 1, rank 0's rotated dispatch within 0.05 s, the dry run,
the bench's ``--data-parallel`` in turns, and the flagship's rotated
epochs of one 64-step chunk (``mesh_flagship_rotation``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
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
# the flagship's [batch, latent]; the evaluation path's [1, 64] (the
# recon/traversal panel) and [8, 64] (the prior grid); large; a rank's
# [16, 64] in the data_parallel phase (two ranks of the global 32); the
# scaled config's [256, 128]; the demo notebook's [16, 16]
ELBO_SHAPES = ((32, 64), (1, 64), (8, 64), (65536, 64), (16, 64), (256, 128),
               (16, 16))
# the decoder's last activation y [B, C, H, W] at the flagship (bf16 under
# autocast, fp32 without), the evaluation path's smaller decodes (1: the
# panel, 2: its endpoints, 7: a traversal sweep, 8: the prior grid), a
# ragged shape for the tiles' edges, and a rank's bf16 y in the
# data_parallel phase (16 rows of the global 32, its own split of the
# persistent TMA grid's work)
HEAD_CASES = (((32, 64, 128, 128), "bfloat16"), ((32, 64, 128, 128), "float32"),
              ((1, 64, 128, 128), "bfloat16"), ((2, 64, 128, 128), "bfloat16"),
              ((7, 64, 128, 128), "bfloat16"), ((8, 64, 128, 128), "bfloat16"),
              ((3, 64, 37, 53), "float32"), ((16, 64, 128, 128), "bfloat16"))
# the cases whose launches must take the TMA path, as the main path's do
HEAD_TMA_CASES = (((32, 64, 128, 128), "bfloat16"),
                  ((16, 64, 128, 128), "bfloat16"))
# the reference dataset's scale, which the bench's e2e data has and the
# evaluation CLIs run over: 4 classes of train and test images at 128 px
REF_TRAIN_PER_CLASS, REF_TEST_PER_CLASS = 1456, 328
ENCODE_PASSES = 5
# the GN kernels' inputs: the flagship's eight block activations (encoder
# then decoder, bf16 under autocast), the largest in fp32, a ragged shape,
# and the bench canary's fp32 [2, 64, 32, 32], the shape of the GN kernels'
# main path
GN_BLOCKS = (("enc0", (32, 64, 64, 64)), ("enc1", (32, 128, 32, 32)),
             ("enc2", (32, 256, 16, 16)), ("enc3", (32, 512, 8, 8)),
             ("dec0", (32, 256, 16, 16)), ("dec1", (32, 128, 32, 32)),
             ("dec2", (32, 64, 64, 64)), ("dec3", (32, 64, 128, 128)))
# the scaled config's blocks (configs/beta_vae_se_tpu_scaled.yaml: 256 px,
# base 64, 5 blocks) at its batch of 256, bf16
GN_SCALED_BLOCKS = (("enc0", (256, 64, 128, 128)),
                    ("enc1", (256, 128, 64, 64)),
                    ("enc2", (256, 256, 32, 32)), ("enc3", (256, 512, 16, 16)),
                    ("enc4", (256, 1024, 8, 8)), ("dec0", (256, 512, 16, 16)),
                    ("dec1", (256, 256, 32, 32)), ("dec2", (256, 128, 64, 64)),
                    ("dec3", (256, 64, 128, 128)),
                    ("dec4", (256, 64, 256, 256)))
GN_EXTRA_CASES = (((32, 64, 128, 128), "float32"), ((3, 5, 37, 53), "float32"))
GN_CANARY_CASE = ((2, 64, 32, 32), "float32")
# blocks whose sample is over a portable cluster's shared memory (2 MiB in
# bf16): the only ones that may take the generic path
GN_GENERIC_BLOCKS = ("dec3",)
# fp32 operations per value, counted from the kernels' arithmetic: forward
# 3 (x, x² sums) + 6 (x̂, z, ReLU, pool sum); backward 7 + 9
GN_FWD_OPS, GN_BWD_OPS = 9, 16
FLAGSHIP_STEPS = 20
# the ×2 upsample's inputs [B, C, H, W]: the flagship decoder's four (bf16
# under autocast, and fp32), a ragged shape, the scaled config's five
# (configs/beta_vae_se_tpu_scaled.yaml: B = 256, bf16) and the demo
# notebook's three (configs/demo_notebook.yaml: B = 16, fp32)
UPSAMPLE_FLAGSHIP = ((32, 512, 8, 8), (32, 256, 16, 16), (32, 128, 32, 32),
                     (32, 64, 64, 64))
UPSAMPLE_SCALED = ((256, 1024, 8, 8), (256, 512, 16, 16), (256, 256, 32, 32),
                   (256, 128, 64, 64), (256, 64, 128, 128))
UPSAMPLE_DEMO = ((16, 64, 8, 8), (16, 32, 16, 16), (16, 16, 32, 32))
UPSAMPLE_CASES = (tuple((s, "bfloat16") for s in UPSAMPLE_FLAGSHIP)
                  + tuple((s, "float32") for s in UPSAMPLE_FLAGSHIP)
                  + (((3, 5, 37, 53), "float32"), ((3, 5, 37, 53), "bfloat16"))
                  + tuple((s, "bfloat16") for s in UPSAMPLE_SCALED)
                  + tuple((s, "float32") for s in UPSAMPLE_DEMO))
# fp32 operations, counted from the kernels' arithmetic: forward 30 an
# input value (6 row and 4 column two-tap sums of 3), backward 35 a dx value
# (5 four-tap sums of 7)
UPSAMPLE_FWD_OPS, UPSAMPLE_BWD_OPS = 30, 35
# the decoder's upsamples a forward: the flagship's blocks, the small
# configs' (32 px, 2 blocks), the scaled config's and the demo notebook's
FLAGSHIP_BLOCKS, SMALL_BLOCKS, SCALED_BLOCKS, DEMO_BLOCKS = 4, 2, 5, 3
EPOCHS_FIRST, EPOCHS_TOTAL = 2, 3
BENCH_ARGS = ["--steps", "96", "--warmup", "32", "--e2e-epochs", "3"]
# calls a graph of ``device_ms_per_call`` holds
GRAPH_CALLS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()
# the script's seconds at the last phase line
_LAST = [_T0]


def emit(obj: dict) -> None:
    """One JSON line; a phase's line gets the script's seconds so far and
    the seconds since the phase line before it (``phase_s``)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "elapsed_s": now - _T0, "phase_s": now - _LAST[0]}
        _LAST[0] = now
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


def device_events(fn, calls: int) -> list:
    """The device events (kernels, copies, fills) of ``calls`` calls of
    ``fn`` (``torch.profiler``).  The calls run twice, as the profiler's
    warm-up step and then as its active step, and only the active step's
    events count: device tracing is running when they start, where a
    window of a fraction of a millisecond straight after the profiler
    starts can record no device event at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.extend(p.events())) as prof:
        run()
        prof.step()
        run()
        prof.step()
    return [e for e in recorded
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


# the profiler windows that recorded none of a timed call's kernels, or
# not as many as it launches, in every try: reported in the kernel phase's
# lines, not failed on (the kernels' launches are counted by their
# wrappers, and their times come from CUDA events)
PROFILER_MISSES = []
# every device kernel a timed call launches, by case (the profiler's count;
# None where it missed): a call's device time holds all of them
KERNELS_PER_TIMED_CALL = {}


def confirm_kernels(fn, case: str, calls: int = 5, only: str = "",
                    per_call: int | None = None) -> float | None:
    """Device kernels a call of ``fn`` that the profiler records (every
    one), once a window of ``calls`` calls holds kernels whose name holds
    ``only`` (``per_call`` of them a call, where given).  A window can miss
    its events, as a whole (GN enc3 and enc0 once each, in two runs; the
    head forward once) or in part (an upsample case once read a fifth of
    its kernels): it is taken again with four times the calls, up
    to four times, and a case that misses in every window is appended to
    PROFILER_MISSES and gives None."""
    tries = (calls,) + (4 * calls,) * 4
    for n in tries:
        events = device_events(fn, n)
        mine = [e for e in events if only in e.name]
        if mine and (per_call is None or len(mine) == per_call * n):
            return len(events) / n
    PROFILER_MISSES.append({"case": case, "only": only,
                            "per_call": per_call, "windows": list(tries)})
    print(f"chip_smoke: {case}: the profiler recorded no device event"
          f"{f' of a kernel named *{only}*' if only else ''}"
          f"{f' ({per_call} a call)' if per_call else ''} in windows of "
          f"{tries} calls (reported, not failed on)", file=sys.stderr,
          flush=True)
    return None


def check_launches(fn, case: str, kernel: str) -> None:
    """Fail unless a call of ``fn`` launches the kernel of the wrapper
    named ``kernel`` (``ops.kernel_wrappers``): its count must grow."""
    import torch

    from betavae_tpu_torch.ops import kernel_wrappers

    wrapper = kernel_wrappers()[kernel]
    before = wrapper.launches
    fn()
    torch.cuda.synchronize()
    if wrapper.launches <= before:
        fail(f"{case}: a call launched no {kernel} kernel")


def device_ms_per_call(fn, case: str, calls: int = 5, before=None,
                       only: str = "", per_call: int | None = None,
                       kernel: str | None = None) -> float:
    """The device time of a call of ``fn``: CUDA events around a CUDA graph
    of GRAPH_CALLS calls (``graph_ms``), less a graph of ``before`` alone
    where ``before`` runs ahead of each call, so the host's share of a call
    is not in it; every kernel and copy the call launches counts, and the
    gaps between them in a graph.  ``kernel`` names the wrapper whose
    kernel a call must launch (``check_launches``: a call that launches
    none fails the run); the profiler confirms the kernels' names and
    count (``confirm_kernels``: a miss is reported, not failed on).  A
    ``fn`` that runs autograd's backward needs its forward run on
    ``timing_stream()``, where the graph is captured: autograd runs a
    backward op on its forward's stream."""
    if kernel is not None:
        check_launches(fn, case, kernel)
    KERNELS_PER_TIMED_CALL[case] = confirm_kernels(fn, case, calls, only,
                                                   per_call)
    if before is None:
        return graph_ms(fn, GRAPH_CALLS)
    return (graph_ms(lambda: (before(), fn()), GRAPH_CALLS)
            - graph_ms(before, GRAPH_CALLS))


def host_us_per_call(fn, calls: int) -> float:
    """Host microseconds a call of ``fn``: a host clock over ``calls``
    calls with no synchronise between them (what the host spends to issue
    one; the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def ptxas_by_kernel(log: str) -> dict:
    """``ptxas -v``'s register, shared-memory and stack lines of each kernel
    in an ``nvcc`` log, by the kernel's (mangled) name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = []
        elif name is not None and ("registers" in line or "stack" in line):
            out[name].append(line.split("info    :")[-1].strip())
    return out


def profiled_kernels(fn, case: str, only: str, calls: int = 20,
                     kernel: str | None = None) -> dict:
    """Device ms a call of ``fn`` (``device_ms_per_call``: CUDA events
    around a graph of calls) and device kernels a call (the profiler,
    every kernel; None where every window missed them)."""
    if kernel is not None:
        check_launches(fn, case, kernel)
    KERNELS_PER_TIMED_CALL[case] = confirm_kernels(fn, case, calls, only)
    return {"device_ms": graph_ms(fn, GRAPH_CALLS),
            "kernels_per_call": KERNELS_PER_TIMED_CALL[case]}


@functools.cache
def timing_stream():
    """The one stream every ``graph_ms`` warm-up and capture runs on: each
    new stream that runs a cuBLAS call gets a workspace PyTorch never
    frees, which a stream a call would pile up."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, reps: int) -> float:
    """Milliseconds per repetition of ``fn`` captured ``reps`` times into one
    CUDA graph and replayed (CUDA events): the device's time for the chain,
    the gaps between its kernels included and the host's launches not.
    The warm-up calls and the capture run on ``timing_stream()``."""
    import torch

    stream = timing_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def elbo_race_check(iters: int = 1000) -> dict:
    """Programmatic dependent launch must not let the forward read before
    the kernels that write its inputs have finished: ``iters`` times, μ,
    the offset's slot and logσ² are written in place (logσ² by a
    reduction, the forward's immediate predecessor, as the logvar clamp is
    in the model), the forward follows with the attribute on, and copies
    of μ and logσ² taken after it must give the kernel's z and kl through
    the plain version, and its ε the plain Philox stream at the offset
    written."""
    import torch

    from betavae_tpu_torch.ops.elbo import (_launch, philox_normal,
                                            reparam_kl_reference)

    shape = ELBO_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    mu_src = torch.randn((iters, *shape), generator=g, device="cuda")
    lv_src = 0.1 * torch.randn((iters, 16, *shape), generator=g, device="cuda")
    mu = torch.empty(shape, device="cuda")
    logvar = torch.empty(shape, device="cuda")
    offsets = torch.arange(iters, dtype=torch.int64, device="cuda")
    slot = torch.zeros((), dtype=torch.int64, device="cuda")
    outs, seen = [], []
    for i in range(iters):
        torch.neg(mu_src[i], out=mu)
        slot.copy_(offsets[i])
        torch.sum(lv_src[i], dim=0, out=logvar)
        outs.append(_launch(mu, logvar, 5, slot, True))
        seen.append((mu.clone(), logvar.clone()))
    torch.cuda.synchronize()
    z, kl, eps = (torch.stack([o[k] for o in outs]) for k in range(3))
    mus = torch.stack([m for m, _ in seen])
    lvs = torch.stack([lv for _, lv in seen])
    if not torch.equal(mus, -mu_src):
        fail("elbo race check: the copies of mu are not the written values")
    wrong = [i for i in range(iters) if not torch.equal(
        eps[i], philox_normal(shape, 5, i, device="cuda"))]
    if wrong:
        fail(f"elbo race check: eps not the plain stream at the offset "
             f"written, at iterations {wrong[:10]}")
    z_ref, kl_ref = reparam_kl_reference(mus, lvs, eps)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_ref, rtol=1e-5, atol=1e-6)
    return {"iters": iters, "shape": list(shape),
            "max_abs_err": max(float((z - z_ref).abs().max()),
                               float((kl - kl_ref).abs().max()))}


def check_elbo(shape, check_moments: bool) -> dict:
    """fused_reparam_kl's forward and backward kernels on the card against
    their plain versions, the offset given both ways a caller gives it: a
    0-d int64 tensor on the card (the trainers' slot) and an int (written
    to one by the wrapper), z, KL and ε bitwise alike and ε bitwise the
    plain Philox stream; and times: the forward with the tensor offset and
    with the int (its fill included), with programmatic dependent launch on
    and off in turns (off, on, on, off), alone and chained behind the
    logvar clamp it follows in the model; the backward beside the plain
    closed form it replaces."""
    import torch

    from betavae_tpu_torch.ops.elbo import (_launch, _launch_backward,
                                            fused_reparam_kl, philox_normal,
                                            reparam_kl_backward,
                                            reparam_kl_backward_reference,
                                            reparam_kl_forward,
                                            reparam_kl_reference)

    g = torch.Generator(device="cuda").manual_seed(1)
    mu = torch.randn(shape, generator=g, device="cuda")
    logvar = torch.randn(shape, generator=g, device="cuda").clamp(-10.0, 5.0)
    seed, offset = 115, 7
    slot = torch.full((), offset, dtype=torch.int64, device="cuda")
    offsets = {"tensor": slot, "int": offset}

    z, kl, eps = reparam_kl_forward(mu, logvar, seed, slot)
    by_int = reparam_kl_forward(mu, logvar, seed, offset)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((z, kl, eps), by_int)):
        fail(f"elbo {shape}: the int offset's z, kl and eps differ from the "
             f"tensor offset's")
    z_ref, kl_ref = reparam_kl_reference(mu, logvar, eps)
    # same eps, same order of fp32 operations, and only exp differing by
    # at most an ulp or so between the kernel and torch: 1e-5 relative
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_ref, rtol=1e-5, atol=1e-6)
    # the kernel's noise is the plain Philox/Box-Muller stream in torch,
    # bit for bit, as every earlier build of the kernel drew it
    eps_plain = philox_normal(shape, seed, offset, device="cuda")
    if not torch.equal(eps, eps_plain):
        fail(f"elbo {shape}: eps differs from philox_normal's stream by up "
             f"to {float((eps - eps_plain).abs().max())}")
    max_abs_err = max(float((z - z_ref).abs().max()),
                      float((kl - kl_ref).abs().max()))

    # the backward kernel against the closed form: contiguous gradients, and
    # g_kl broadcast along the latent dim (strides (1, 0)) as capacity
    # mode's per-sample sum hands it over; 1e-5 relative plus 1e-5 of the
    # largest |value| (one exp each side, rounded alike)
    g_z = torch.randn(shape, generator=g, device="cuda")
    g_kl = torch.randn(shape, generator=g, device="cuda")
    g_kl_row = torch.randn(shape[0], 1, generator=g, device="cuda").expand(shape)
    backward_err = {}
    for name, gk in (("contiguous", g_kl), ("broadcast_g_kl", g_kl_row)):
        got = reparam_kl_backward(mu, logvar, eps, g_z, gk)
        want = reparam_kl_backward_reference(mu, logvar, eps, g_z, gk)
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)
        backward_err[name] = max(float((a - b).abs().max())
                                 for a, b in zip(got, want))

    # gradients through the autograd Function (both kernels), with each
    # kind of offset, against autograd through the plain version with the
    # kernel's eps; the closed form and autograd round in another order, so
    # 1e-5 relative of the gradient's scale; the two kinds' bitwise alike
    mu_p, lv_p = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    zp, klp = reparam_kl_reference(mu_p, lv_p, eps)
    ((zp * g_z).sum() + (klp * g_kl).sum()).backward()
    grads = {}
    for kind, off in offsets.items():
        mu_k = mu.clone().requires_grad_()
        lv_k = logvar.clone().requires_grad_()
        zk, klk = fused_reparam_kl(mu_k, lv_k, seed, off)
        ((zk * g_z).sum() + (klk * g_kl).sum()).backward()
        for got, want in ((mu_k.grad, mu_p.grad), (lv_k.grad, lv_p.grad)):
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)
        grads[kind] = (zk, klk, mu_k.grad, lv_k.grad)
    if not all(torch.equal(a, b)
               for a, b in zip(grads["tensor"], grads["int"])):
        fail(f"elbo {shape}: the autograd Function's z, kl or gradients "
             f"differ between the tensor and the int offset")

    for kind, off in offsets.items():
        _, _, eps_same = reparam_kl_forward(mu, logvar, seed, off)
        _, _, eps_seed = reparam_kl_forward(mu, logvar, seed + 1, off)
        if not torch.equal(eps, eps_same):
            fail(f"elbo {shape}: the same (seed, offset) gave another eps "
                 f"({kind} offset)")
        if torch.equal(eps, eps_seed):
            fail(f"elbo {shape}: another seed gave the same eps ({kind} "
                 f"offset)")
    _, _, eps_off = reparam_kl_forward(mu, logvar, seed, offset + 1)
    if torch.equal(eps, eps_off):
        fail(f"elbo {shape}: another offset gave the same eps")

    out = {"shape": list(shape), "max_abs_err": max_abs_err,
           "eps_bitwise_vs_plain": True,
           "int_offset_bitwise_tensor_offset": True,
           "backward_max_abs_err": backward_err}
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
    small = n < 100_000
    iters = 2000 if small else 200
    out["ms"] = cuda_ms(lambda: reparam_kl_forward(mu, logvar, seed, slot),
                        iters)
    out["host_us"] = host_us_per_call(
        lambda: reparam_kl_forward(mu, logvar, seed, slot), iters)
    # an int offset: the fill that writes it to the card, then the kernel
    out["int_offset_ms"] = cuda_ms(
        lambda: reparam_kl_forward(mu, logvar, seed, offset), iters)
    out["int_offset_host_us"] = host_us_per_call(
        lambda: reparam_kl_forward(mu, logvar, seed, offset), iters)

    def plain():
        e = philox_normal(shape, seed, offset, device="cuda")
        return reparam_kl_reference(mu, logvar, e)

    out["plain_ms"] = cuda_ms(plain, max(20, iters // 10))
    bytes_ms = 5 * n * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = ELBO_OPS_PER_ELEMENT * n / FP32_OPS_PER_S * 1e3
    out["bound_ms"] = max(bytes_ms, ops_ms)
    out["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"

    # programmatic dependent launch off and on, in turns: the forward alone
    # (a call with many queued; the host's µs a call; the kernel's device
    # time, in a graph), and chained behind the clamp that writes logvar in
    # the model, eager (host included) and replayed from a CUDA graph (the
    # device's time for clamp + forward, gaps included)
    pre = 4.0 * torch.randn(shape, generator=g, device="cuda")

    def alone(pdl):
        return lambda: _launch(mu, logvar, seed, slot, pdl)

    def chained(pdl):
        return lambda: _launch(mu, pre.clamp(-10.0, 5.0), seed, slot, pdl)

    pdl = {f"{k}_{side}": [] for k in ("ms", "host_us", "device_ms",
                                       "chained_ms", "chained_graph_ms")
           for side in ("off", "on")}
    for on in (False, True, True, False):
        side = "on" if on else "off"
        pdl[f"ms_{side}"].append(cuda_ms(alone(on), iters))
        pdl[f"host_us_{side}"].append(host_us_per_call(alone(on), iters))
        pdl[f"device_ms_{side}"].append(device_ms_per_call(
            alone(on), f"elbo {shape} pdl {side}", calls=20,
            only="reparam_kl_kernel", kernel="fused_reparam_kl"))
        pdl[f"chained_ms_{side}"].append(cuda_ms(chained(on), iters))
        pdl[f"chained_graph_ms_{side}"].append(graph_ms(
            chained(on), 2000 if small else 100))
    out["pdl"] = pdl

    # the backward: the kernel a call, its device time and the plain closed
    # form's (time and kernels a call) on the same contiguous inputs; bound
    # 7 arrays of n fp32 values (5 read, 2 written)
    def kernel_bwd():
        return reparam_kl_backward(mu, logvar, eps, g_z, g_kl)

    def plain_bwd():
        return reparam_kl_backward_reference(mu, logvar, eps, g_z, g_kl)

    kern = profiled_kernels(kernel_bwd, f"elbo {shape} backward",
                            "reparam_kl_backward",
                            kernel="reparam_kl_backward")
    plain_prof = profiled_kernels(plain_bwd, f"elbo {shape} plain backward",
                                  "")
    bwd = {"ms": cuda_ms(kernel_bwd, iters),
           "host_us": host_us_per_call(kernel_bwd, iters),
           "device_ms": kern["device_ms"],
           "kernels_per_call": kern["kernels_per_call"],
           "ms_pdl_off": cuda_ms(lambda: _launch_backward(
               mu, logvar, eps, g_z, g_kl, False), iters),
           "plain_ms": cuda_ms(plain_bwd, iters),
           "plain_device_ms": plain_prof["device_ms"],
           "plain_kernels_per_call": plain_prof["kernels_per_call"],
           "bound_ms": 7 * n * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None}
    bwd["bound_fraction"] = bwd["bound_ms"] / bwd["device_ms"]
    out["backward"] = bwd
    return out


def check_elbo_start() -> dict:
    """A data-parallel rank's launch: the reparam+KL forward at [16, 64]
    with ``start = 16·64`` must give rows 16–31 of the [32, 64] launch
    bitwise (ε, z and KL) and match its plain version (ε bitwise the plain
    Philox stream from ``start``, z and KL 1e-5 relative); ``start = 0`` is
    the launch without it, bitwise.  Each with the offset a 0-d int64
    tensor on the card (the trainers' slot) and an int, bitwise alike."""
    import torch

    from betavae_tpu_torch.ops.elbo import (philox_normal,
                                            reparam_kl_forward,
                                            reparam_kl_reference)

    g = torch.Generator(device="cuda").manual_seed(9)
    mu = torch.randn((32, 64), generator=g, device="cuda")
    logvar = torch.randn((32, 64), generator=g, device="cuda").clamp(-10, 5)
    eps_plain = philox_normal((16, 64), 115, 7, device="cuda", start=16 * 64)
    names = ("z", "kl", "eps")
    out, parts = {}, {}
    for kind, off in (("tensor", torch.full((), 7, dtype=torch.int64,
                                            device="cuda")), ("int", 7)):
        full = reparam_kl_forward(mu, logvar, 115, off)
        zero = reparam_kl_forward(mu, logvar, 115, off, 0)
        part = reparam_kl_forward(mu[16:], logvar[16:], 115, off, 16 * 64)
        torch.cuda.synchronize()
        bitwise = {n: bool(torch.equal(a, b[16:]))
                   for n, a, b in zip(names, part, full)}
        start_zero = all(torch.equal(a, b) for a, b in zip(full, zero))
        plain = bool(torch.equal(part[2], eps_plain))
        z_ref, kl_ref = reparam_kl_reference(mu[16:], logvar[16:], part[2])
        torch.testing.assert_close(part[0], z_ref, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(part[1], kl_ref, rtol=1e-5, atol=1e-6)
        if not (all(bitwise.values()) and start_zero and plain):
            fail(f"elbo start ({kind} offset): rows 16-31 bitwise {bitwise}, "
                 f"start 0 unchanged {start_zero}, eps the plain stream "
                 f"{plain}")
        parts[kind] = part
        out[kind] = {"rows_bitwise": bitwise, "start_0_bitwise": start_zero,
                     "eps_bitwise_vs_plain": plain,
                     "max_abs_err": max(float((part[0] - z_ref).abs().max()),
                                        float((part[1] - kl_ref).abs().max()))}
    if not all(torch.equal(a, b) for a, b in zip(parts["tensor"],
                                                  parts["int"])):
        fail("elbo start: the int offset's rows differ from the tensor "
             "offset's")
    return {"shape": [16, 64], "start": 16 * 64, "of": [32, 64],
            "int_offset_bitwise_tensor_offset": True, "by_offset": out,
            "max_abs_err": max(o["max_abs_err"] for o in out.values())}


def check_elbo_device_offset() -> dict:
    """The forward, its offset in device memory, as a captured step replays
    it, at the flagship's [32, 64]: one launch captured in a CUDA graph,
    replayed with 3 offsets written to its slot, ε bitwise the plain
    Philox stream at each and z and KL within 1e-5 relative of the plain
    version, with programmatic dependent launch on and off; then the clamp
    → forward chain replayed from a graph (2000 repetitions) with the
    attribute off and on, in turns (off, on, on, off), beside the chain
    with an int offset (its fill captured too).  ``default_pdl`` is the
    wrapper's choice."""
    import torch

    from betavae_tpu_torch.ops import elbo
    from betavae_tpu_torch.ops.elbo import (_launch, philox_normal,
                                            reparam_kl_reference)

    shape = ELBO_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    mu = torch.randn(shape, generator=g, device="cuda")
    logvar = torch.randn(shape, generator=g, device="cuda").clamp(-10, 5)
    pre = 4.0 * torch.randn(shape, generator=g, device="cuda")
    offsets = (7, 2**31 + 100_000 + 3, 2**40 + 5)
    replays, errs = {}, []
    for pdl in (False, True):
        slot = torch.zeros((), dtype=torch.int64, device="cuda")
        _launch(mu, logvar, 115, slot, pdl)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            z, kl, eps = _launch(mu, logvar, 115, slot, pdl)
        bitwise = []
        for off in offsets:
            slot.fill_(off)
            graph.replay()
            torch.cuda.synchronize()
            bitwise.append(bool(torch.equal(
                eps, philox_normal(shape, 115, off, device="cuda"))))
            z_ref, kl_ref = reparam_kl_reference(mu, logvar, eps)
            torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(kl, kl_ref, rtol=1e-5, atol=1e-6)
            errs.append(max(float((z - z_ref).abs().max()),
                            float((kl - kl_ref).abs().max())))
        if not all(bitwise):
            fail(f"elbo device offset (pdl {pdl}): eps the plain stream at "
                 f"offsets {offsets}: {bitwise}")
        replays["pdl_on" if pdl else "pdl_off"] = bitwise
        del graph
    slot = torch.full((), 7, dtype=torch.int64, device="cuda")
    cases = {"device_pdl_off": lambda: _launch(
                 mu, pre.clamp(-10.0, 5.0), 115, slot, False),
             "device_pdl_on": lambda: _launch(
                 mu, pre.clamp(-10.0, 5.0), 115, slot, True),
             "int_offset_default": lambda: _launch(
                 mu, pre.clamp(-10.0, 5.0), 115, 7)}
    times = {name: [] for name in cases}
    for name in ("device_pdl_off", "device_pdl_on", "int_offset_default",
                 "int_offset_default", "device_pdl_on", "device_pdl_off"):
        times[name].append(graph_ms(cases[name], 2000))
    on, off = (statistics.mean(times[f"device_pdl_{k}"])
               for k in ("on", "off"))
    return {"shape": list(shape), "offsets": list(offsets),
            "eps_bitwise_at_each_replayed_offset": replays,
            "max_abs_err": max(errs), "chained_graph_ms": times,
            "faster": "pdl_on" if on < off else "pdl_off",
            "default_pdl": elbo.FORWARD_PDL}


def elbo_pdl_trial() -> dict:
    """Where the cost of programmatic dependent launch in a CUDA graph comes
    from: the clamp → forward chain at [32, 64] replayed from a graph (2000
    repetitions), in turns, for the forward as built with the attribute off
    and on, a variant of its source built here with the attribute on
    (``no_trigger``: no ``launch_dependents``), and the clamp alone."""
    import ctypes

    import torch

    from betavae_tpu_torch import _build
    from betavae_tpu_torch.device import raw_stream
    from betavae_tpu_torch.ops.elbo import _launch

    src = (_build.SRC_DIR / "elbo.cu").read_text()
    trigger = "    if (first) allow_next_grid();\n"
    if trigger not in src:
        fail("elbo pdl trial: the source no longer has the line it varies")
    texts = {"no_trigger": src.replace(trigger, "", 1)}
    procs = {}
    for name, text in texts.items():
        cu = _build.BUILD_DIR / f"elbo_trial_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"elbo pdl trial: the {name} variant did not build:\n{log}")
        fn = ctypes.CDLL(str(so)).betavae_reparam_kl
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        entries[name] = fn

    shape = ELBO_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(1)
    mu = torch.randn(shape, generator=g, device="cuda")
    pre = 4.0 * torch.randn(shape, generator=g, device="cuda")
    slot = torch.full((), 2, dtype=torch.int64, device="cuda")

    def variant(name):
        def chain():
            lv = pre.clamp(-10.0, 5.0)
            out = mu.new_empty((3, *shape))
            if entries[name](mu.data_ptr(), lv.data_ptr(), out.data_ptr(),
                             mu.numel(), 1, slot.data_ptr(), 0,
                             raw_stream(mu.device), 1):
                fail(f"elbo pdl trial: the {name} variant did not launch")
            return out
        return chain

    cases = {"pdl_off": lambda: _launch(mu, pre.clamp(-10.0, 5.0), 1, slot,
                                        False),
             "pdl_on": lambda: _launch(mu, pre.clamp(-10.0, 5.0), 1, slot,
                                       True),
             "no_trigger_pdl_on": variant("no_trigger"),
             "clamp_alone": lambda: pre.clamp(-10.0, 5.0)}
    times = {name: [] for name in cases}
    for name in list(cases) + list(reversed(cases)):
        times[name].append(graph_ms(cases[name], 2000))
    return {"shape": list(shape), "chained_graph_ms": times}


def elbo_host_split() -> dict:
    """Where a reparam+KL call's host time goes at the flagship's [32, 64]:
    host microseconds a call of each piece of the wrappers, alone, over
    calls with no synchronise, beside the whole calls; the earlier wrapper's
    pieces (three ``empty_like``, ``current_stream().cuda_stream``) for
    comparison."""
    import torch

    from betavae_tpu_torch.device import raw_stream
    from betavae_tpu_torch.ops import elbo

    shape = ELBO_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    mu, logvar, eps, g_z, g_kl = (torch.randn(shape, generator=g,
                                              device="cuda")
                                  for _ in range(5))
    mu_g, lv_g = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    forward, backward = elbo._library()
    out3 = mu.new_empty((3, *shape))
    out2 = mu.new_empty((2, *shape))
    n = mu.numel()
    stream = raw_stream(mu.device)
    slot = torch.full((), 7, dtype=torch.int64, device="cuda")
    pieces = {
        "forward_call": lambda: elbo.reparam_kl_forward(mu, logvar, 115,
                                                        slot),
        "forward_call_int_offset": lambda: elbo.reparam_kl_forward(
            mu, logvar, 115, 7),
        "offset_fill": lambda: torch.full((), 7, dtype=torch.int64,
                                          device="cuda"),
        "function_call_with_grad": lambda: elbo.fused_reparam_kl(
            mu_g, lv_g, 115, slot),
        "backward_call": lambda: elbo.reparam_kl_backward(mu, logvar, eps,
                                                          g_z, g_kl),
        "checks_forward": lambda: (elbo._fp32(mu), elbo._fp32(logvar),
                                   elbo._check_like(mu, logvar)),
        "current_device": torch.cuda.current_device,
        "allocation_forward": lambda: mu.new_empty((3, *shape)),
        "raw_stream": lambda: raw_stream(mu.device),
        "data_ptr_x3": lambda: (mu.data_ptr(), logvar.data_ptr(),
                                out3.data_ptr()),
        "ctypes_forward_launch": lambda: forward(
            mu.data_ptr(), logvar.data_ptr(), out3.data_ptr(), n, 115,
            slot.data_ptr(), 0, stream, 0),
        "ctypes_backward_launch": lambda: backward(
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), g_z.data_ptr(),
            64, 1, g_kl.data_ptr(), 64, 1, out2.data_ptr(), n, 64, stream, 1),
        "unbind_3": lambda: out3.unbind(0),
        "earlier_empty_like_x3": lambda: (torch.empty_like(mu),
                                      torch.empty_like(mu),
                                      torch.empty_like(mu)),
        "earlier_current_stream": lambda: torch.cuda.current_stream(
            mu.device).cuda_stream,
    }
    return {name: host_us_per_call(fn, 2000) for name, fn in pieces.items()}


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
                                            head_conv_reference, head_dx,
                                            head_forward, head_m,
                                            head_m_reference)

    y, s, k, dy = head_inputs(shape, dtype_name)
    b, c, h, w = shape
    # the plain forward is an fp32 cuDNN conv: no TF32 in the reference
    torch.backends.cudnn.allow_tf32 = False
    before = {f: dict(f.launches_by_path) for f in (head_forward, head_m)}
    out = head_forward(y, s, k)
    m = head_m(y, dy)
    torch.cuda.synchronize()
    # the path each kernel took: the one whose count went up
    paths = {name: [p for p, n in f.launches_by_path.items()
                    if n != before[f][p]]
             for name, f in (("forward", head_forward), ("m", head_m))}
    if any(len(p) != 1 for p in paths.values()):
        fail(f"head {shape} {dtype_name}: launches by path {paths}")
    if (tuple(shape), dtype_name) in HEAD_TMA_CASES and any(
            p != ["tma"] for p in paths.values()):
        fail(f"head {shape} {dtype_name}: paths {paths}, want the TMA path")
    # two launches give the same bits (fixed order, no atomics)
    if not (torch.equal(out, head_forward(y, s, k))
            and torch.equal(m, head_m(y, dy))):
        fail(f"head {shape} {dtype_name}: two launches differ")
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
    # each kernel with L2 emptied before every call, by reading 256 MB
    # (clean lines) or by writing them (50 MB of dirty lines that the
    # kernel's loads must first write back, as after the ops of a step)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    l2 = {}
    case = f"head {shape} {dtype_name}"
    for kind, fn, kernel in (
            ("head_fwd_", lambda: head_forward(y, s, k), "head_forward"),
            ("head_m_", lambda: head_m(y, dy), "head_m")):
        l2[kind] = {
            "device_ms_after_l2_read": device_ms_per_call(
                fn, f"{case} {kind} after an L2 read", before=flush.max,
                only=kind, kernel=kernel),
            "device_ms_after_l2_write": device_ms_per_call(
                fn, f"{case} {kind} after an L2 write", before=flush.zero_,
                only=kind, kernel=kernel)}
    del flush
    fwd = {"path": paths["forward"][0],
           "ms": cuda_ms(lambda: head_forward(y, s, k), iters),
           "device_ms": device_ms_per_call(lambda: head_forward(y, s, k),
                                           f"{case} forward",
                                           kernel="head_forward"),
           "plain_ms": cuda_ms(lambda: head_conv_reference(y, s, k),
                               plain_iters)}
    mk = {"path": paths["m"][0],
          "ms": cuda_ms(lambda: head_m(y, dy), iters),
          "device_ms": device_ms_per_call(lambda: head_m(y, dy),
                                          f"{case} M", kernel="head_m"),
          "plain_ms": cuda_ms(lambda: head_m_reference(y, dy), plain_iters)}
    fwd.update(l2["head_fwd_"])
    mk.update(l2["head_m_"])
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
    # against the fused Function (M kernel + dk, ds, dy_y in torch ops);
    # the forwards run on the stream their backwards are captured on, as
    # autograd runs a backward op on its forward's stream
    g_out = dy[:, None].to(y.dtype)
    yr, sr, wr = (t.clone().requires_grad_() for t in (y, s, w4))
    kr = k.clone().requires_grad_()
    backward_stream = timing_stream()
    backward_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(backward_stream):
        unfused = F.conv2d(yr * sr[:, :, None, None], wr, padding=1)
        fused = fused_se_conv_head(yr, sr, kr)
    torch.cuda.current_stream().wait_stream(backward_stream)

    def unfused_backward():
        return torch.autograd.grad(unfused, (yr, sr, wr), g_out,
                                   retain_graph=True)

    mk["unfused_head_backward_ms"] = cuda_ms(unfused_backward, plain_iters)
    mk["unfused_head_backward_device_ms"] = device_ms_per_call(
        unfused_backward, f"{case} unfused backward")

    def fused_backward():
        return torch.autograd.grad(fused, (yr, sr, kr), dy, retain_graph=True)

    mk["fused_head_backward_ms"] = cuda_ms(fused_backward, plain_iters)
    mk["fused_head_backward_device_ms"] = device_ms_per_call(
        fused_backward, f"{case} fused backward", kernel="head_m")
    # of which dy_y: the torch ops of head_dx (pad, 9 shifts, bmm, cast)
    mk["head_dx_ms"] = cuda_ms(lambda: head_dx(dy, s, k, y.dtype),
                               plain_iters)
    mk["head_dx_device_ms"] = device_ms_per_call(
        lambda: head_dx(dy, s, k, y.dtype), f"{case} head_dx")

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
        row["bound_fraction"] = row["bound_ms"] / row["device_ms"]
    return {"shape": list(shape), "dtype": dtype_name, "checks": checks,
            "forward": fwd, "m": mk}


def check_upsample(shape, dtype_name: str) -> dict:
    """The ×2 upsample's forward and gather-backward kernels on the card:
    on the path the rule gives (``upsample_path``; launched once each, on
    that path) and on each path forced (the vector path where the rule
    allows it), bitwise equal to their plain versions (both compute in one
    order); two launches of each bitwise equal; the autograd Function's
    value and gradient the kernels'; and times: each path's kernel a call
    and on the device in turns (generic, vector, vector, generic), its
    bound, its plain version's time, and ``F.interpolate``'s forward and
    autograd backward (the library call, whose backward scatters with
    atomics)."""
    import torch
    import torch.nn.functional as F

    from betavae_tpu_torch.ops import upsample
    from betavae_tpu_torch.ops.upsample import (
        bilinear_upsample_x2, upsample2x_backward,
        upsample2x_backward_reference, upsample2x_forward,
        upsample2x_reference)

    dtype = getattr(torch, dtype_name)
    b, c, h, w = shape
    case = f"upsample {shape} {dtype_name}"
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    dy = torch.randn((b, c, 2 * h, 2 * w), generator=g,
                     device="cuda").to(dtype)
    path = upsample.upsample_path(shape, dtype, upsample._alignment(x, dy))
    paths = ("generic", "vector") if path == "vector" else ("generic",)
    wrappers = (upsample2x_forward, upsample2x_backward)
    before = [dict(wr.launches_by_path) for wr in wrappers]
    y = upsample2x_forward(x)
    dx = upsample2x_backward(dy)
    torch.cuda.synchronize()
    for wr, was in zip(wrappers, before):
        if {p: n - was[p] for p, n in wr.launches_by_path.items()} != {
                p: int(p == path) for p in ("vector", "generic")}:
            fail(f"{case}: one call of each did not launch each kernel once "
                 f"on the {path} path")
    if not (torch.equal(y, upsample2x_forward(x))
            and torch.equal(dx, upsample2x_backward(dy))):
        fail(f"{case}: two launches differ")
    checks = {"path": path}
    for name, got, ref, src in (
            ("forward", y, upsample2x_reference, x),
            ("backward", dx, upsample2x_backward_reference, dy)):
        want = ref(src)
        forced = {p: upsample._launch(src, name == "backward", p)
                  for p in paths}
        bitwise = {p: bool(torch.equal(out, want))
                   for p, out in forced.items()}
        checks[name] = {"max_abs_err": max(float((out.float() - want.float())
                                                 .abs().max())
                                           for out in (got, *forced.values())),
                        "max_abs_ref": float(want.float().abs().max()),
                        "bitwise_vs_plain": bool(torch.equal(got, want)),
                        "bitwise_vs_plain_by_path": bitwise}
        if not (checks[name]["bitwise_vs_plain"] and all(bitwise.values())):
            fail(f"{case} {name}: not bitwise the plain version: "
                 f"{checks[name]}")
        del want, forced
    xr = x.clone().requires_grad_()
    yr = bilinear_upsample_x2(xr)
    yr.backward(dy)
    if not (torch.equal(yr, y) and torch.equal(xr.grad, dx)):
        fail(f"{case}: the autograd Function's value or gradient is not the "
             f"kernels'")
    del xr, yr
    # the library call on the same inputs: its values beside the kernels'
    xl = x.clone().requires_grad_()
    y_lib = F.interpolate(xl, scale_factor=2, mode="bilinear",
                          align_corners=False)
    (dx_lib,) = torch.autograd.grad(y_lib, xl, dy, retain_graph=True)
    checks["library_max_abs_diff"] = {
        "forward": float((y_lib.detach().float() - y.float()).abs().max()),
        "backward": float((dx_lib.float() - dx.float()).abs().max())}
    del dx_lib

    out_bytes = y.numel() * y.element_size()
    iters = max(3, min(200, int(4e9 // out_bytes)))
    plain_iters = max(2, iters // 10)
    rows = {}
    for name, src, plain, library, ops, only in (
            ("forward", x, lambda: upsample2x_reference(x),
             lambda: F.interpolate(x, scale_factor=2, mode="bilinear",
                                   align_corners=False),
             UPSAMPLE_FWD_OPS * x.numel(), "upsample2x_fwd"),
            ("backward", dy, lambda: upsample2x_backward_reference(dy),
             lambda: torch.autograd.grad(y_lib, xl, dy, retain_graph=True),
             UPSAMPLE_BWD_OPS * x.numel(), "upsample2x_bwd")):
        bwd = name == "backward"
        turns = {p: {"ms": [], "device_ms": []} for p in paths}
        for p in (paths + paths[::-1] if len(paths) == 2 else paths * 2):
            def kernel(p=p):
                return upsample._launch(src, bwd, p)
            turns[p]["ms"].append(cuda_ms(kernel, iters))
            turns[p]["device_ms"].append(device_ms_per_call(
                kernel, f"{case} {name} {p}", only=only, per_call=1,
                kernel=f"upsample_{name}"))
        bytes_ms = (x.numel() + y.numel()) * x.element_size() \
            / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        row = {"path": path,
               "ms": statistics.mean(turns[path]["ms"]),
               "device_ms": statistics.mean(turns[path]["device_ms"]),
               "plain_ms": cuda_ms(plain, plain_iters, warmup=2),
               "library_ms": cuda_ms(library, plain_iters, warmup=2),
               "bound_ms": bound,
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        row["bound_fraction"] = bound / row["device_ms"]
        for p in paths:
            row[f"{p}_ms_in_turns"] = turns[p]["ms"]
            row[f"{p}_device_ms_in_turns"] = turns[p]["device_ms"]
            row[f"{p}_bound_fraction"] = bound / statistics.mean(
                turns[p]["device_ms"])
        rows[name] = row
    del x, dy, y, dx, xl, y_lib
    torch.cuda.empty_cache()
    return {"shape": list(shape), "dtype": dtype_name, "checks": checks,
            **rows}


def gn_inputs(shape, dtype_name: str, seed: int = 0):
    import torch

    b, c, _, _ = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2.0 * torch.randn(shape, generator=g, device="cuda") + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g, device="cuda")
    beta = 0.1 * torch.randn(c, generator=g, device="cuda")
    gy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    gp = torch.randn(b, c, generator=g, device="cuda")
    return x, gamma, beta, gy, gp


def check_gn(shape, dtype_name: str) -> dict:
    """The GN forward and backward kernels on the card against their plain
    versions, two launches against each other, the path each took (the
    forward's is always generic; on the backward's cluster path, how many
    clusters the card holds at once), and
    times: a call (host included), the device time back to back and after
    a clean and a dirty L2 flush, the host's microseconds a call, beside
    the bound, the plain version, one ``F.group_norm`` call and the unfused
    sequence of the port's blocks."""
    import torch
    import torch.nn.functional as F

    from betavae_tpu_torch.ops.gn import (_active_clusters, gn_backward,
                                          gn_backward_reference, gn_forward,
                                          gn_forward_reference, gn_path)

    x, gamma, beta, gy, gp = gn_inputs(shape, dtype_name)
    b, c, h, w = shape
    case = f"gn {shape} {dtype_name}"
    kind, n = gn_path(shape, x.dtype)
    before = {f: dict(f.launches_by_path) for f in (gn_forward, gn_backward)}
    y, pooled, m, rstd = gn_forward(x, gamma, beta)
    dx, dgamma, dbeta = gn_backward(x, gamma, beta, m, rstd, gy, gp)
    torch.cuda.synchronize()
    launches_by_path = {
        name: {p: f.launches_by_path[p] - before[f][p] for p in before[f]}
        for name, f in (("forward", gn_forward), ("backward", gn_backward))}
    want = {"forward": {"generic": 1},
            "backward": {p: int(p == kind) for p in before[gn_backward]}}
    if launches_by_path != want:
        fail(f"{case}: launches by path {launches_by_path}, want {want} "
             f"(gn_path {kind, n})")
    # fp32 results: sums of the same values in another order, 1e-5
    # relative plus 1e-5 of the largest |value|; y and dx in bf16 also
    # carry one bf16 rounding: 2^-8.  The backward's plain version is given
    # the kernel's m and rstd, so both see the same ReLU mask.
    io_tol = 1e-5 if dtype_name == "float32" else 2**-8
    y_ref, pooled_ref, m_ref, rstd_ref = gn_forward_reference(x, gamma, beta)
    dx_ref, dgamma_ref, dbeta_ref = gn_backward_reference(
        x, gamma, beta, m, rstd, gy, gp)
    # pooled is the mean of the y the kernel returns (1e-5 against that
    # mean); against the plain version's it carries y's rounding
    checks = {}
    for name, got, want_, tol in (
            ("y", y, y_ref, io_tol),
            ("pooled_vs_y", pooled, y.float().mean(dim=(2, 3)), 1e-5),
            ("pooled", pooled, pooled_ref, io_tol),
            ("m", m, m_ref, 1e-5), ("rstd", rstd, rstd_ref, 1e-5),
            ("dx", dx, dx_ref, io_tol), ("dgamma", dgamma, dgamma_ref, 1e-5),
            ("dbeta", dbeta, dbeta_ref, 1e-5)):
        scale = float(want_.float().abs().max())
        torch.testing.assert_close(got.float(), want_.float(), rtol=tol,
                                   atol=tol * scale)
        checks[name] = {"max_abs_err": float((got.float()
                                              - want_.float()).abs().max()),
                        "max_abs_ref": scale}
    again = gn_forward(x, gamma, beta) + gn_backward(x, gamma, beta, m, rstd,
                                                     gy, gp)
    for first, second in zip((y, pooled, m, rstd, dx, dgamma, dbeta), again):
        if not torch.equal(first, second):
            fail(f"{case}: two launches differ")
    del y_ref, pooled_ref, dx_ref, again

    def call_fwd():
        return gn_forward(x, gamma, beta)

    def call_bwd():
        return gn_backward(x, gamma, beta, m, rstd, gy, gp)

    big = x.numel() >= 1 << 24
    iters, plain_iters = (50, 10) if big else (200, 20)
    fwd = {"ms": cuda_ms(call_fwd, iters),
           "device_ms": device_ms_per_call(call_fwd, f"{case} forward",
                                           only="gn_", kernel="gn_forward"),
           "plain_ms": cuda_ms(lambda: gn_forward_reference(x, gamma, beta),
                               plain_iters)}
    bwd = {"ms": cuda_ms(call_bwd, iters),
           "device_ms": device_ms_per_call(call_bwd, f"{case} backward",
                                           only="gn_", kernel="gn_backward"),
           "plain_ms": cuda_ms(lambda: gn_backward_reference(
               x, gamma, beta, m, rstd, gy, gp), plain_iters)}
    # each direction with L2 emptied before every call, by reading 256 MB
    # (clean lines) or by writing them (dirty lines the kernel's loads must
    # first write back, as after the ops of a step)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for row, fn, part in ((fwd, call_fwd, "forward"),
                          (bwd, call_bwd, "backward")):
        row["device_ms_after_l2_read"] = device_ms_per_call(
            fn, f"{case} {part} after an L2 read", before=flush.max,
            only="gn_", kernel=f"gn_{part}")
        row["device_ms_after_l2_write"] = device_ms_per_call(
            fn, f"{case} {part} after an L2 write", before=flush.zero_,
            only="gn_", kernel=f"gn_{part}")
        # calls queued with no synchronise: the host's share of a call
        row["host_us"] = host_us_per_call(fn, 200 if big else 2000)
    del flush
    # the library yardstick: one F.group_norm call (norm and affine only:
    # no ReLU, no pool), in x's dtype, and its backward through autograd
    # (one native_group_norm_backward)
    gw, bw = gamma.to(x.dtype), beta.to(x.dtype)
    fwd["library_ms"] = cuda_ms(lambda: F.group_norm(x, 1, gw, bw, 1e-6),
                                iters)
    xl, gl, bl = (t.clone().requires_grad_() for t in (x, gw, bw))
    yl = F.group_norm(xl, 1, gl, bl, 1e-6)
    bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        yl, (xl, gl, bl), gy, retain_graph=True), iters)
    # what the port's blocks run today under bf16 autocast: nn.GroupNorm
    # (fp32 inside) → cast back → ReLU → the SE squeeze's mean, and its
    # whole backward through autograd
    xu, gu, bu = (t.clone().requires_grad_() for t in (x, gamma, beta))

    def unfused():
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=x.dtype == torch.bfloat16):
            hu = torch.relu(F.group_norm(xu, 1, gu, bu, 1e-6).to(x.dtype))
            return hu, hu.mean(dim=(2, 3))

    fwd["unfused_ms"] = cuda_ms(unfused, plain_iters)
    hu, pu = unfused()
    bwd["unfused_ms"] = cuda_ms(lambda: torch.autograd.grad(
        (hu, pu), (xu, gu, bu), (gy, gp.to(pu.dtype)), retain_graph=True),
        plain_iters)
    del xl, yl, xu, hu, pu

    x_bytes = x.numel() * x.element_size()
    for row, nbytes, ops in (
            (fwd, 2 * x_bytes + 8 * c + 4 * b * c + 8 * b, GN_FWD_OPS),
            (bwd, 3 * x_bytes + 8 * c + 8 * b + 12 * b * c, GN_BWD_OPS)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops * x.numel() / FP32_OPS_PER_S * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        row["bound_fraction"] = row["bound_ms"] / row["device_ms"]
    fwd["path"], bwd["path"] = "generic", kind
    out = {"shape": list(shape), "dtype": dtype_name, "path": kind, "k": n,
           "launches_by_path": launches_by_path, "checks": checks,
           "forward": fwd, "backward": bwd}
    if kind == "cluster":
        out["active_clusters"] = _active_clusters(shape, x.dtype, n,
                                                  x.device)
    return out


def check_gn_cases() -> dict:
    """``check_gn`` once per distinct (shape, dtype) of the flagship's
    blocks, the extra cases, the canary's and the scaled config's blocks;
    returns them by case and the blocks' maps onto them.  Every flagship
    block but dec3 (2 MiB a sample in bf16) and the canary must take the
    cluster path backward."""
    cases = {}
    wanted = ([(shape, "bfloat16") for _, shape in GN_BLOCKS]
              + list(GN_EXTRA_CASES) + [GN_CANARY_CASE]
              + [(shape, "bfloat16") for _, shape in GN_SCALED_BLOCKS])
    for shape, dtype in wanted:
        key = f"{'x'.join(map(str, shape))}_{dtype}"
        if key not in cases:
            cases[key] = check_gn(shape, dtype)
    blocks = {name: f"{'x'.join(map(str, shape))}_bfloat16"
              for name, shape in GN_BLOCKS}
    scaled = {name: f"{'x'.join(map(str, shape))}_bfloat16"
              for name, shape in GN_SCALED_BLOCKS}
    must = [key for name, key in blocks.items()
            if name not in GN_GENERIC_BLOCKS]
    must.append(f"{'x'.join(map(str, GN_CANARY_CASE[0]))}_{GN_CANARY_CASE[1]}")
    generic = [key for key in must if cases[key]["path"] != "cluster"]
    if generic:
        fail(f"gn: {generic} took the generic path")
    return {"cases": cases, "blocks": blocks, "scaled_blocks": scaled}


def gn_host_split() -> dict:
    """Where a GN call's host time goes, at the canary's fp32 [2, 64, 32,
    32] (cluster path backward): host microseconds a call of each piece of the
    wrapper, alone, over calls with no synchronise, beside the whole call
    and one ``F.group_norm`` call."""
    import torch
    import torch.nn.functional as F

    from betavae_tpu_torch.device import raw_stream
    from betavae_tpu_torch.ops import gn

    shape, dtype_name = GN_CANARY_CASE
    x, gamma, beta, gy, gp = gn_inputs(shape, dtype_name)
    b, c, h, w = shape
    k = gn.gn_path(shape, x.dtype)[1]
    lib = gn._library()
    y, pooled, m, rstd = gn.gn_forward(x, gamma, beta)
    stats = torch.empty(gn._partial_offset(b, c) + 3 * gn._SLOTS * b,
                        dtype=torch.float32, device="cuda")
    dx = torch.empty_like(x)
    dparams = torch.empty((2, b, c), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fwd_args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                y.data_ptr(), stats.data_ptr(), b, c, h, w, 1e-6, 0, stream,
                0)
    bwd_args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                m.data_ptr(), rstd.data_ptr(), gy.data_ptr(), gp.data_ptr(),
                dx.data_ptr(), dparams.data_ptr(), b, c, h, w, 0, k, stream,
                0)
    pieces = {
        "forward_call": lambda: gn.gn_forward(x, gamma, beta),
        "backward_call": lambda: gn.gn_backward(x, gamma, beta, m, rstd, gy,
                                                gp),
        "group_norm_call": lambda: F.group_norm(x, 1, gamma, beta, 1e-6),
        "checks": lambda: (gn._device_of(x, gamma, beta),
                           gn._check(x, gamma, beta),
                           gn._path_of(x.shape, x.dtype)),
        "contiguous_x3": lambda: (x.contiguous(), gamma.contiguous(),
                                  beta.contiguous()),
        "allocations_forward": lambda: (
            torch.empty_like(x),
            torch.empty(stats.numel(), dtype=torch.float32,
                        device=x.device)),
        "current_stream": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "raw_stream": lambda: raw_stream(x.device),
        "data_ptr_x5": lambda: (x.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), y.data_ptr(),
                                stats.data_ptr()),
        "ctypes_forward_launch": lambda: lib.betavae_gn_fwd(*fwd_args),
        "ctypes_backward_launch": lambda: lib.betavae_gn_bwd(*bwd_args),
        "stats_views": lambda: gn._stats_views(stats, b, c),
        "param_views": lambda: gn._param_views(dparams),
    }
    return {name: host_us_per_call(fn, 2000) for name, fn in pieces.items()}


def gn_cluster16_trial() -> dict:
    """dec3's bf16 sample (2 MiB) backward on a non-portable cluster of 16
    CTAs (128 KB each), which the path rule does not take: whether the card
    schedules it (``cudaOccupancyMaxActiveClusters``), whether it matches
    the plain version, and its device time against the generic path's, in
    turns (generic, cluster, cluster, generic) in this call."""
    import torch

    from betavae_tpu_torch.ops import gn

    shape = dict(GN_BLOCKS)["dec3"]
    x, gamma, beta, gy, gp = gn_inputs(shape, "bfloat16")
    active = gn._active_clusters(shape, x.dtype, 16, x.device)
    out = {"shape": list(shape), "dtype": "bfloat16", "k": 16,
           "active_clusters": active}
    if active < 1:
        return out
    code = gn._DTYPE_CODES[x.dtype]
    paths = {"generic": gn.gn_path(shape, x.dtype),
             "cluster16": ("cluster", 16)}
    _, _, m, rstd = gn.gn_forward(x, gamma, beta)

    def bwd(path):
        return gn._backward_launch(x, gamma, beta, m, rstd, gy, gp, code, path)

    dx, dgamma, dbeta = bwd(paths["cluster16"])
    dx_ref, dgamma_ref, dbeta_ref = gn.gn_backward_reference(
        x, gamma, beta, m, rstd, gy, gp)
    err = {}
    for name, got, want, tol in (
            ("dx", dx, dx_ref, 2**-8), ("dgamma", dgamma, dgamma_ref, 1e-5),
            ("dbeta", dbeta, dbeta_ref, 1e-5)):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol * scale)
        err[name] = float((got.float() - want.float()).abs().max())
    del dx_ref, dx
    times = {name: [] for name in paths}
    for name in ("generic", "cluster16", "cluster16", "generic"):
        path = paths[name]
        times[name].append(device_ms_per_call(
            lambda: bwd(path), f"dec3 cluster trial backward {name}",
            only="gn_", kernel="gn_backward"))
    out.update(max_abs_err=err, backward_device_ms=times,
               faster=max(times["cluster16"]) < min(times["generic"]))
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


# the upsample kernels' launches by path over every main-path run since the
# kernel phase, gathered as each run's counts are set to 0
UPSAMPLE_PATH_TOTALS = {"upsample_forward": {"vector": 0, "generic": 0},
                        "upsample_backward": {"vector": 0, "generic": 0}}


def zero_counts(kernels: dict) -> None:
    for name, wrapper in kernels.items():
        for path, n in UPSAMPLE_PATH_TOTALS.get(name, {}).items():
            UPSAMPLE_PATH_TOTALS[name][path] = n + \
                wrapper.launches_by_path[path]
        wrapper.launches = 0
        for path in getattr(wrapper, "launches_by_path", {}):
            wrapper.launches_by_path[path] = 0


def upsample_path_totals(kernels: dict) -> dict:
    """``UPSAMPLE_PATH_TOTALS`` with the launches since the last
    ``zero_counts``."""
    return {name: {p: n + kernels[name].launches_by_path[p]
                   for p, n in paths.items()}
            for name, paths in UPSAMPLE_PATH_TOTALS.items()}


def head_paths(kernels: dict) -> dict:
    """The head kernels' launches by path since ``zero_counts``; every one
    on the main path must take the TMA path (the flagship's y allows it)."""
    paths = {name: dict(kernels[name].launches_by_path)
             for name in ("head_forward", "head_m")}
    if any(p["generic"] for p in paths.values()):
        fail(f"head kernels took the generic path on the main path: {paths}")
    return paths


def read_counts(kernels: dict) -> dict:
    """Each kernel's launches since ``zero_counts``; every upsample launch
    of the main paths must have taken the vector path (all their shapes
    allow it)."""
    generic = {name: kernels[name].launches_by_path["generic"]
               for name in UPSAMPLE_PATH_TOTALS}
    if any(generic.values()):
        fail(f"upsample kernels took the generic path on the main path: "
             f"{generic}")
    return {name: wrapper.launches for name, wrapper in kernels.items()}


def launches_per_step(kernels: dict, fused_head: bool, steps: int,
                      blocks: int = FLAGSHIP_BLOCKS,
                      remat: str = "none") -> dict:
    """Launches of ``steps`` train steps: the reparam+KL forward and
    backward every step, the head kernels with the fused head, the
    upsample forward and backward once a decoder block, the GN forward and
    backward once an encoder or decoder block (``blocks`` of each); where
    ``training.remat`` (``models/beta_vae.py::resolve_remat``'s mode)
    recomputes blocks in the backward, their forwards run twice: the
    decoder's under ``decoder``, every block's under ``all``."""
    recomputed = {"none": 0, "decoder": blocks, "all": 2 * blocks}[remat]
    per_step = {"fused_reparam_kl": 1, "reparam_kl_backward": 1,
                "head_forward": int(fused_head), "head_m": int(fused_head),
                "upsample_forward": blocks * (1 + int(remat != "none")),
                "upsample_backward": blocks,
                "gn_forward": 2 * blocks + recomputed,
                "gn_backward": 2 * blocks}
    return {name: steps * per_step.get(name, 0) for name in kernels}


def capture_warmup(kernels: dict, fused_head: bool, train: int = 1,
                   val: int = 0, blocks: int = FLAGSHIP_BLOCKS,
                   remat: str = "none") -> dict:
    """Launches of the runs before each capture (``train/chunks.py``),
    which ran on the card and count: CAPTURE_WARMUP train steps for each of
    ``train`` captured train steps, CAPTURE_WARMUP validation batches for
    each of ``val`` captured validation batches (a batch: the reparam+KL
    forward, the head forward with the fused head, the upsample forward a
    decoder block, the GN forward an encoder or decoder block)."""
    from betavae_tpu_torch.train.chunks import CAPTURE_WARMUP

    out = launches_per_step(kernels, fused_head, CAPTURE_WARMUP * train,
                            blocks=blocks, remat=remat)
    batches = CAPTURE_WARMUP * val
    out["fused_reparam_kl"] += batches
    out["head_forward"] += batches * int(fused_head)
    out["upsample_forward"] += batches * blocks
    out["gn_forward"] += batches * 2 * blocks
    return out


def plus(a: dict, b: dict) -> dict:
    """``a`` + ``b``, key by key (``a``'s keys)."""
    return {k: v + b.get(k, 0) for k, v in a.items()}


def block_launches(decodes: int, backward_steps: int = 0,
                   blocks: int = FLAGSHIP_BLOCKS,
                   encodes: int | None = None) -> dict:
    """The upsample and GN kernels' launches of ``decodes`` decoder
    forwards and ``encodes`` encoder forwards (as many as the decodes
    where None: a train step, a validation batch and a panel run both), of
    which ``backward_steps`` train steps ran the backward: the upsample
    once a decoder block, the GN kernels once an encoder or decoder block
    (``blocks`` of each)."""
    encodes = decodes if encodes is None else encodes
    return {"upsample_forward": blocks * decodes,
            "upsample_backward": blocks * backward_steps,
            "gn_forward": blocks * (encodes + decodes),
            "gn_backward": 2 * blocks * backward_steps}


@contextlib.contextmanager
def counted_forwards():
    """``{"encode": n, "decode": n}``: the calls of ``BetaVAEModule.encode``
    and ``decode`` while open, for the eager paths (the evaluation and
    inference CLIs, the scripts), where each call runs the GN kernels once
    a block; a launch of a captured graph runs no Python."""
    from betavae_tpu_torch.models.beta_vae import BetaVAEModule

    counts = {"encode": 0, "decode": 0}
    real = {name: getattr(BetaVAEModule, name) for name in counts}

    def counting(name):
        def call(self, *args, **kwargs):
            counts[name] += 1
            return real[name](self, *args, **kwargs)
        return call

    for name in counts:
        setattr(BetaVAEModule, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(BetaVAEModule, name, fn)


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
    # 2 steps an epoch (16 images, batch 8): K = 2, one capture
    want = plus(launches_per_step(kernels, fused_head, 3,
                                  blocks=SMALL_BLOCKS),
                capture_warmup(kernels, fused_head, blocks=SMALL_BLOCKS))
    # fp32 on both sides, summed in other orders; Adam carries the
    # difference into the next step: 1e-3 relative over three steps
    rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(gpu, cpu))
    if not (len(gpu) == len(cpu) == 3 and rel < 1e-3 and launches == want):
        fail(f"small slice (fused_head {fused_head}): card {gpu} (kernel "
             f"launches {launches}, want {want}) vs CPU {cpu} (max rel {rel})")
    return {"phase": "slice_vs_cpu", "fused_head": fused_head,
            "gpu_totals": gpu, "cpu_totals": cpu, "max_rel_diff": rel,
            "gpu_kernel_launches": launches}


def flagship_config(tmp: str, fused_head: bool, **overrides) -> str:
    """configs/beta_vae_se.yaml at full width over seeded 128 px demo data
    (24 train and 4 test images per class: three full batches of 32), with
    ``overrides`` (``section.key`` → value)."""
    from betavae_tpu_torch.data.demo import generate_demo_data

    root = os.path.join(tmp, "flagship")
    name = "flagship_fused" if fused_head else "flagship"
    name += "".join(f"_{k.split('.')[1]}-{v}" for k, v in overrides.items())
    cfg = write_config("configs/beta_vae_se.yaml", root, name + ".yaml",
                       **{"training.fused_head": fused_head, **overrides})
    if not os.path.isdir(os.path.join(root, "processed")):
        generate_demo_data(os.path.join(root, "processed"),
                           train_per_class=24, test_per_class=4, size=128)
    return cfg


def run_flagship(tmp: str, kernels: dict, fused_head: bool,
                 **overrides) -> dict:
    """FLAGSHIP_STEPS steps of the flagship at full width (with the config
    ``overrides``); every kernel of the path launches once per step."""
    import gc

    import torch

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.models.beta_vae import resolve_remat
    from betavae_tpu_torch.train.loop import train_steps

    cfg = flagship_config(tmp, fused_head, **overrides)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    out = train_steps(cfg, FLAGSHIP_STEPS)
    launches = read_counts(kernels)
    paths = head_paths(kernels)
    reset_logger()
    totals = out["totals"]
    if len(totals) != FLAGSHIP_STEPS or not all(map(math.isfinite, totals)):
        fail(f"flagship: expected {FLAGSHIP_STEPS} finite losses, got {totals}")
    remat = resolve_remat(overrides.get("training.remat", False))
    # resident or fed from the host, the trainer captures its step
    want = plus(launches_per_step(kernels, fused_head, FLAGSHIP_STEPS,
                                  remat=remat),
                capture_warmup(kernels, fused_head, remat=remat))
    if out["dispatch"] != "cuda_graph" or launches != want:
        fail(f"flagship (fused_head {fused_head}, {overrides}): dispatch "
             f"{out['dispatch']}, kernel launches {launches} in "
             f"{FLAGSHIP_STEPS} steps, want {want}")
    step_ms = out["timed_seconds"] / out["timed_steps"] * 1e3
    return {"phase": "flagship", "fused_head": fused_head,
            "overrides": overrides, "totals": totals,
            "steps": out["steps"], "launches": launches,
            "head_launches_by_path": paths,
            "first_total": totals[0], "last_total": totals[-1],
            "timed_steps": out["timed_steps"], "step_ms": step_ms,
            "img_per_s": out["batch_size"] * 1e3 / step_ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_replay(tmp: str, kernels: dict) -> dict:
    """The flagship (full width) through ``train_steps`` twice from the
    same seed for FLAGSHIP_STEPS steps (``run_flagship``: finite totals,
    each kernel's launches), in bf16 with the default head and then the
    fused head, and in fp32 (``training.mixed_precision: false``, TF32 at
    PyTorch's defaults) with the default head: every total of the rerun
    must equal the first run's, bitwise, at every step."""
    out = {}
    for tag, fused, overrides in (
            ("default_head", False, {}), ("fused_head", True, {}),
            ("default_head_fp32", False,
             {"training.mixed_precision": False})):
        runs = [run_flagship(tmp, kernels, fused_head=fused, **overrides)
                for _ in range(2)]
        first, rerun = (r["totals"] for r in runs)
        parted = [i + 1 for i, (a, b) in enumerate(zip(first, rerun))
                  if a != b]
        if parted:
            fail(f"replay ({tag}): the rerun parts from the first run at "
                 f"steps {parted}: {first} vs {rerun}")
        out[tag] = {
            "steps": len(first), "totals_bitwise": True, "totals": first,
            "step_ms": [r["step_ms"] for r in runs],
            "launches": runs[0]["launches"]}
    return {"phase": "replay", **out}


# the scan_chunks phase: FLAGSHIP_STEPS steps of one epoch (640 train
# images, 20 batches of 32) at each K; K = 8 is 2 chunks and 4 single steps
SCAN_KS = (1, 8, 20)
SCAN_TRAIN_PER_CLASS, SCAN_TEST_PER_CLASS = 160, 16
# the e2e epoch's one chunk: 4 × 1456 images in batches of 32
LAUNCH_CHECK_STEPS = 4 * REF_TRAIN_PER_CLASS // 32
# a rotated epoch's dispatch of the next epoch's first chunk, at most: host
# calls that queue the snapshot, the chunk's upload, its draws and a launch
# from the device a step, or, in one of several ranks, the job that does
# them on the dispatcher thread (1.438–1.457 s, the host blocked, with a
# host launch a step on the training thread); also a dispatch's behind a
# running chunk on that path
ROTATE_DISPATCH_LIMIT_S = 0.05


@contextlib.contextmanager
def timed_dispatches():
    """``[steps, host seconds]`` of each ``TrainChunks.dispatch`` made in
    the block, in order."""
    from betavae_tpu_torch.train.chunks import TrainChunks

    seen = []
    dispatch = TrainChunks.dispatch

    def timed(self, images, steps, meta=None, stage=None):
        t0 = time.perf_counter()
        job = dispatch(self, images, steps, meta, stage)
        seen.append([len(steps), time.perf_counter() - t0])
        return job

    TrainChunks.dispatch = timed
    try:
        yield seen
    finally:
        TrainChunks.dispatch = dispatch


@contextlib.contextmanager
def timed_prepares():
    """The seconds of each ``TrainChunks.prepare`` that captured in the
    block (its warm-up and both graphs)."""
    from betavae_tpu_torch.train.chunks import TrainChunks

    seen = []
    prepare = TrainChunks.prepare

    def timed(self, images):
        seconds = prepare(self, images)
        if seconds:
            seen.append(seconds)
        return seconds

    TrainChunks.prepare = timed
    try:
        yield seen
    finally:
        TrainChunks.prepare = prepare


@contextlib.contextmanager
def forced_host_path():
    """The path of one of several NCCL ranks, on one card and without NCCL:
    ``train.chunks._several_ranks`` patched true, so that a captured graph
    launches from the host and each dispatch (a chunk, a validation pass)
    is a job of the run's queue, run on its dispatcher thread."""
    from betavae_tpu_torch.train import chunks

    several = chunks._several_ranks
    chunks._several_ranks = lambda: True
    try:
        yield
    finally:
        chunks._several_ranks = several


def one_launch_check() -> dict:
    """Whether a chunk's dispatch returns at once: the fused train step
    (the bench's steady step) in ``TrainChunks`` at K = LAUNCH_CHECK_STEPS
    (the e2e epoch's one chunk) over 1024 seeded images on the card.  Host
    seconds of the first dispatch (upload, draws, K launches) and of a
    dispatch behind the running chunk; behind a running chunk, of K
    launches of the captured step from the device (the trainers' way), of
    K launches of the same graph from the host (PyTorch's ``replay``) and
    of a chunk's K draws; the device seconds of a chunk; the capture's
    seconds and PyTorch's host instantiation of the graph, peak memory.
    Fails unless the chunk's rows are finite and the first K − 1 of them,
    dispatched again from the same state through host launches of the
    same graph, are bitwise the ones launched from the device (so the rows
    read behind a launch from the device are the graph's).  Then the path
    of one of several ranks (``forced_host_path``: a capture launched from
    the host, each dispatch a job of the dispatcher thread) from the same
    state: host seconds of the first dispatch and of one behind it, and
    whether each job was still queued or launching when its dispatch
    returned; fails unless the dispatch behind the running chunk returned
    within ROTATE_DISPATCH_LIMIT_S with its job still to run, and both
    chunks' rows are bitwise the ones launched from the device."""
    import numpy as np
    import torch

    from betavae_tpu_torch.bench import FLAGSHIP_CONFIG, flagship_model
    from betavae_tpu_torch.config import get_config
    from betavae_tpu_torch.device import deterministic_cudnn
    from betavae_tpu_torch.models.losses import LossSpec
    from betavae_tpu_torch.train.chunks import TrainChunks
    from betavae_tpu_torch.train.optim import build_optimizer
    from betavae_tpu_torch.train.step import draw_step_augment, make_train_step

    k, b, n = LAUNCH_CHECK_STEPS, 32, 1024
    dev = torch.device("cuda")
    model = flagship_model()
    optimizer = build_optimizer(model.parameters(),
                                get_config(str(FLAGSHIP_CONFIG)))
    aug = {"use_flip": True, "degrees": 10.0, "brightness_range": 0.1}
    step = make_train_step(
        model, optimizer, LossSpec(recon_loss_type="mse", use_ffl=True,
                                   ffl_weight=0.5, ffl_alpha=1.0),
        aug_kwargs=aug, use_capacity=True, seed=1)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (n, 128, 128, 1), np.uint8)).to(dev)
    sched = dict(beta=1.0, capacity=30.0, capacity_weight=1.0,
                 free_bits=0.0, lr=5e-4)
    mask = np.ones(b, np.float32)
    chunks = TrainChunks(step, model, optimizer, k=k, batch=b, device=dev,
                         seed=1, aug_kwargs=aug, graphs=True)

    def steps(chunk: int) -> list:
        return [(np.arange(s * b % (n - b), s * b % (n - b) + b), mask,
                 sched, s + 1) for s in range(chunk * k, (chunk + 1) * k)]

    def host(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def launches(replay) -> None:
        """A chunk's K launches of the step, j back at slot 0 before."""
        chunks.j.zero_()
        for _ in range(k):
            replay()

    out = {"steps": k}
    with deterministic_cudnn():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["capture_seconds"] = chunks.prepare(images)
        launched = chunks.captured.graph
        # PyTorch's own executable of the same graph, launched from the host
        out["host_instantiate_seconds"] = host(launched.graph.instantiate)
        snapshot = chunks.snapshot
        snapshot.take()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = []
        out["first_dispatch_host_seconds"] = host(
            lambda: pending.append(chunks.dispatch(images, steps(0))))
        out["busy_dispatch_host_seconds"] = host(
            lambda: pending.append(chunks.dispatch(images, steps(1))))
        rows = [p.rows().copy() for p in pending]
        out["two_chunks_seconds"] = time.perf_counter() - t0
        snapshot.restore()
        launched.replay = launched.graph.replay
        try:
            again = chunks.dispatch(images, steps(0)[:k - 1]).rows()
        finally:
            del launched.replay
        if (not np.isfinite(np.stack(rows)).all()
                or not np.array_equal(again, rows[0][:k - 1])):
            fail(f"one_launch_check: the rows launched from the device "
                 f"(finite {np.isfinite(np.stack(rows)).all()}) are not the "
                 f"host-launched graph's from the same state")
        torch.cuda.synchronize()
        out["chunk_device_seconds"] = host(
            lambda: (launches(launched.replay), torch.cuda.synchronize()))
        launches(launched.replay)
        out["draws_host_seconds"] = host(lambda: [
            draw_step_augment(chunks.generator, 1, s, b, aug,
                              out=chunks.draws[i])
            for i, s in enumerate(range(1, k + 1))])
        out["device_launches_host_seconds"] = host(
            lambda: launches(launched.replay))
        torch.cuda.synchronize()
        launches(launched.replay)
        out["host_launches_host_seconds"] = host(
            lambda: launches(launched.graph.replay))
        torch.cuda.synchronize()
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        snapshot.restore()
        out["host_path"] = host_path_dispatch(
            step, model, optimizer, images, aug, steps, rows)
    snapshot.restore()
    del chunks, snapshot, model, optimizer, images, launched
    torch.cuda.empty_cache()
    return out


def host_path_dispatch(step, model, optimizer, images, aug: dict, steps,
                       rows: list) -> dict:
    """``one_launch_check``'s two chunks from the state its device-launched
    ones started from, on the path of one of several ranks: a capture
    launched from the host and each dispatch a job of the dispatcher
    thread (see ``one_launch_check``)."""
    import numpy as np
    import torch

    from betavae_tpu_torch.train.chunks import DeviceLaunched, TrainChunks

    k, b = LAUNCH_CHECK_STEPS, 32
    with forced_host_path():
        chunks = TrainChunks(step, model, optimizer, k=k, batch=b,
                             device=images.device, seed=1, aug_kwargs=aug,
                             graphs=True)
        try:
            capture = chunks.prepare(images)
            torch.cuda.synchronize()
            jobs, seconds, queued = [], [], []
            t0 = time.perf_counter()
            for chunk in (0, 1):
                t = time.perf_counter()
                jobs.append(chunks.dispatch(images, steps(chunk)))
                seconds.append(time.perf_counter() - t)
                queued.append([not j.done for j in jobs])
            got = [j.rows().copy() for j in jobs]
            two_chunks = time.perf_counter() - t0
        finally:
            chunks.queue.close()
    out = {"queue_threaded": chunks.queue.threaded,
           "launched_from_device": isinstance(chunks.captured.graph,
                                              DeviceLaunched),
           "capture_seconds": capture,
           "first_dispatch_host_seconds": seconds[0],
           "busy_dispatch_host_seconds": seconds[1],
           # each job not yet run when a dispatch returned
           "jobs_queued_at_return": queued,
           "two_chunks_seconds": two_chunks,
           "rows_bitwise_device_launched": all(
               np.array_equal(a, b) for a, b in zip(got, rows))}
    if (not out["queue_threaded"] or out["launched_from_device"]
            or seconds[1] > ROTATE_DISPATCH_LIMIT_S or not queued[1][1]
            or not out["rows_bitwise_device_launched"]):
        fail(f"one_launch_check (host path through the queue): {out}")
    del chunks
    return out


def scan_config(tmp: str, fused_head: bool, k: int, **overrides) -> str:
    """The flagship at full width (``flagship_config``'s) with
    ``training.scan_chunk_steps`` ``k`` over seeded 128 px demo data of
    SCAN_TRAIN_PER_CLASS train images a class (an epoch of FLAGSHIP_STEPS
    steps) and SCAN_TEST_PER_CLASS test images (2 validation batches)."""
    from betavae_tpu_torch.data.demo import generate_demo_data

    root = os.path.join(tmp, "scan_chunks")
    name = f"k{k}_fused" if fused_head else f"k{k}"
    name += "".join(f"_{key.split('.')[1]}-{v}"
                    for key, v in overrides.items())
    cfg = write_config("configs/beta_vae_se.yaml", root, name + ".yaml",
                       **{"training.fused_head": fused_head,
                          "training.scan_chunk_steps": k,
                          "logging.log_every_n_steps": 1, **overrides})
    if not os.path.isdir(os.path.join(root, "processed")):
        generate_demo_data(os.path.join(root, "processed"),
                           train_per_class=SCAN_TRAIN_PER_CLASS,
                           test_per_class=SCAN_TEST_PER_CLASS, size=128)
    return cfg


def scan_run(tmp: str, kernels: dict, fused_head: bool, k: int,
             **overrides) -> dict:
    """FLAGSHIP_STEPS steps of ``train_steps`` at K = ``k``: finite totals,
    the dispatch the trainer named (eager at K = 1, else CUDA graphs with
    chunks of ``k``), each kernel's launches the derived count, a replay's
    one step's, and one launch from the device a step; step ms, each
    chunk's dispatch seconds, capture seconds, peak memory."""
    import gc

    import torch

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps
    from betavae_tpu_torch.utils.profiling import SPANS

    cfg = scan_config(tmp, fused_head, k, **overrides)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    device_launched = SPANS.counter("graphs.device_launches")
    with timed_dispatches() as dispatches:
        out = train_steps(cfg, FLAGSHIP_STEPS)
    launches = read_counts(kernels)
    device_launched = (SPANS.counter("graphs.device_launches")
                       - device_launched)
    paths = head_paths(kernels)
    reset_logger()
    totals = out["totals"]
    want_dispatch = "eager: scan_chunk_steps 1" if k == 1 else "cuda_graph"
    want = launches_per_step(kernels, fused_head, FLAGSHIP_STEPS)
    if k > 1:
        want = plus(want, capture_warmup(kernels, fused_head))
    per_replay = out["launches_per_replay"]
    # a launch from the device a step (the eager run launches none)
    want_device = 0 if k == 1 else sum(n for n, _ in dispatches)
    if (len(totals) != FLAGSHIP_STEPS or not all(map(math.isfinite, totals))
            or out["dispatch"] != want_dispatch or out["chunk_k"] != k
            or launches != want or device_launched != want_device
            or (k > 1 and per_replay != launches_per_step(
                kernels, fused_head, 1))):
        fail(f"scan_chunks (K {k}, fused_head {fused_head}, {overrides}): "
             f"totals {totals}, dispatch {out['dispatch']} chunk K "
             f"{out['chunk_k']}, launches {launches} (want {want}), a "
             f"replay's {per_replay}, "
             f"{device_launched} graph launches from the device (want "
             f"{want_device})")
    step_ms = out["timed_seconds"] / out["timed_steps"] * 1e3
    return {"k": k, "totals": totals, "step_ms": step_ms,
            "timed_steps": out["timed_steps"],
            "capture_seconds": out["capture_seconds"],
            "dispatch_host_seconds": dispatches,
            "device_launched_graphs": device_launched,
            "launches": launches, "launches_per_replay": per_replay,
            "head_launches_by_path": paths,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_scan_chunks(tmp: str, kernels: dict) -> dict:
    """The JAX trainer's K-step dispatch on the card: FLAGSHIP_STEPS
    flagship steps (one epoch) at K = 1 (eager), 8 and 20 (a launch of
    the captured step from the device a step), in bf16 with the default
    head
    (K = 1, 8, 20, 20, 8, 1: the step ms in turns) and the fused head, and
    in fp32 with the default head (``scan_run``): every total bitwise across
    K; the device time a step (profiled, the capture not in the window) and
    busy share at K = 1 and 20; then ``train()`` for 2 epochs with
    validation at K = 3 (6 chunks and 2 single steps an epoch) against
    K = 1: every METRICS number bitwise but the wall times, the same
    lines; then ``one_launch_check``."""
    out = {}
    for tag, fused, overrides, order in (
            ("default_head", False, {}, SCAN_KS + SCAN_KS[::-1]),
            ("fused_head", True, {}, SCAN_KS),
            ("default_head_fp32", False,
             {"training.mixed_precision": False}, SCAN_KS)):
        runs = [scan_run(tmp, kernels, fused, k, **overrides) for k in order]
        first = runs[0]["totals"]
        parted = {r["k"]: [i + 1 for i, (a, b) in
                           enumerate(zip(first, r["totals"])) if a != b]
                  for r in runs[1:]}
        if any(parted.values()):
            fail(f"scan_chunks ({tag}): totals part from K = 1's at steps "
                 f"{parted}: {[r['totals'] for r in runs]}")
        by_k = {k: [r for r in runs if r["k"] == k] for k in SCAN_KS}
        out[tag] = {
            "totals_bitwise_across_k": True, "totals": first,
            "step_ms_in_turns": [[r["k"], r["step_ms"]] for r in runs],
            "step_ms": {k: [r["step_ms"] for r in rs]
                        for k, rs in by_k.items()},
            "capture_seconds": {k: [r["capture_seconds"] for r in rs]
                                for k, rs in by_k.items() if k > 1},
            # [steps, host seconds] of each chunk's dispatch, in order
            "dispatch_host_seconds": {k: rs[-1]["dispatch_host_seconds"]
                                      for k, rs in by_k.items()},
            "peak_mem_gib": {k: max(r["peak_mem_gib"] for r in rs)
                             for k, rs in by_k.items()},
            "launches": {k: rs[0]["launches"] for k, rs in by_k.items()},
            "launches_per_replay": {k: rs[0]["launches_per_replay"]
                                    for k, rs in by_k.items() if k > 1}}
    busy = {}
    for k in (1, SCAN_KS[-1]):
        step_ms = statistics.mean(out["default_head"]["step_ms"][k])
        prof = profile_config(scan_config(tmp, False, k), step_ms,
                              steps=FLAGSHIP_STEPS)
        busy[k] = {key: prof[key] for key in (
            "device_ms_per_step", "device_busy_share", "kernels_per_step",
            "elbo_kernel_device_ms_per_step",
            "elbo_backward_kernel_device_ms_per_step")}
        busy[k]["top_kernels_ms_per_step"] = \
            prof["top_kernels_ms_per_step"][:6]
        # the launches counted a replay (K > 1) or a step (K = 1) against
        # the kernels the profiler saw a step
        counted = (out["default_head"]["launches_per_replay"][k] if k > 1
                   else launches_per_step(kernels, False, 1))
        seen = prof["launches_per_step_by_kernel"]
        if any(seen[name] != counted[name] for name in seen):
            fail(f"scan_chunks: K {k}: kernels a step in the profile {seen}, "
                 f"counted {counted}")
        busy[k]["launches_per_step_by_kernel"] = seen
    out["profile_default_head"] = busy

    lines = {}
    for k in (1, 3):
        cfg = scan_config(tmp, True, k, **{"training.epochs": 2,
                                           "paths.run_id": f"train_k{k}"})
        zero_counts(kernels)
        trained, metrics = _train_lines(cfg)
        lines[k] = {"launches": read_counts(kernels),
                    "lines": [{key: v for key, v in m.items()
                               if key not in SCAN_WALL_KEYS}
                              for m in metrics if m["phase"] != "epoch_end"],
                    "phases": [m["phase"] for m in metrics],
                    "epochs": trained["epoch"],
                    "total_steps": trained["total_steps"]}
    # K = 3 captures its train step and its validation batch once each
    if not (lines[1]["lines"] == lines[3]["lines"]
            and lines[1]["phases"] == lines[3]["phases"]
            and lines[1]["phases"].count("train") == 2 * FLAGSHIP_STEPS
            and lines[3]["launches"] == plus(
                lines[1]["launches"],
                capture_warmup(kernels, True, train=1, val=1))):
        fail(f"scan_chunks: train() at K = 3 against K = 1: {lines}")
    out["train_k3_vs_k1"] = {
        "lines_bitwise": True, "lines": len(lines[1]["lines"]),
        "phases": lines[1]["phases"], "launches": lines[3]["launches"],
        "total_steps": lines[3]["total_steps"]}
    out["one_launch"] = one_launch_check()
    return {"phase": "scan_chunks", **out}


# the METRICS keys that are wall times
SCAN_WALL_KEYS = ("epoch_seconds", "train_steps_per_sec",
                  "train_images_per_sec")


# the scaled config's run: 2 train steps an epoch (2 × 256 images), one
# validation batch (128 images), two epochs
SCALED_TRAIN_PER_CLASS, SCALED_TEST_PER_CLASS, SCALED_EPOCHS = 128, 32, 2


def scaled_run(tmp: str, kernels: dict, k: int) -> dict:
    """One run of the scaled config through the training CLI with
    ``--data-parallel -1`` at ``training.scan_chunk_steps`` ``k``: its
    lines (every number finite), launches, seconds and peak memory."""
    import gc

    import torch

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.__main__ import main as train_cli

    root = os.path.join(tmp, "scaled", f"k{k}")
    cfg = write_config("configs/beta_vae_se_tpu_scaled.yaml", root,
                       "scaled.yaml", **{
                           "training.epochs": SCALED_EPOCHS,
                           "training.scan_chunk_steps": k,
                           "logging.log_every_n_steps": 1,
                           "paths.processed_dir": os.path.join(
                               tmp, "scaled", "processed")})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    train_cli(["--config", cfg, "--data-parallel", "-1"])
    seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_logger()
    lines = metrics_lines(os.path.join(root, "outputs", "logs",
                                       "beta_vae_se_tpu_scaled.log"))
    for m in lines:
        bad = [key for key, v in m.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            fail(f"scaled (K {k}): non-finite {bad} in {m}")
    return {"cfg": cfg, "lines": lines, "launches": launches,
            "seconds": seconds, "peak_mem_gib": peak,
            "notes": config_notes(cfg)}


def run_scaled(tmp: str, kernels: dict) -> dict:
    """``configs/beta_vae_se_tpu_scaled.yaml`` at full width (256 px, 5
    blocks, base 64, latent 128, global batch 256, bf16, the background
    writer, epoch rotation) through the training CLI with
    ``--data-parallel -1`` (every visible card: one NCCL rank here), over
    seeded 256 px demo data, for SCALED_EPOCHS epochs of 2 steps, at the
    config's ``scan_chunk_steps: 16`` (K = 2: CUDA-graph replays, NCCL
    inside) and at 1 (eager): every logged number finite and, but the wall
    times, bitwise between the two; the reparam+KL forward once a train
    step and validation batch and its backward once a train step, the
    upsample forward 5 times a decode (train steps, validation batches, an
    epoch's panel) and its backward 5 times a train step, nothing else,
    and at K 16 the capture's warm-up besides; no CONFIG note; the step ms
    of 4 steps of ``train_steps``, epoch wall and peak memory at each K;
    then the device time a step by kernel over 4 profiled steps at K 16."""
    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    generate_demo_data(os.path.join(tmp, "scaled", "processed"),
                       train_per_class=SCALED_TRAIN_PER_CLASS,
                       test_per_class=SCALED_TEST_PER_CLASS, size=256)
    runs = {k: scaled_run(tmp, kernels, k) for k in (16, 1)}
    numbers = {k: [{key: v for key, v in m.items()
                    if key not in SCAN_WALL_KEYS}
                   for m in r["lines"] if m["phase"] != "epoch_end"]
               for k, r in runs.items()}
    if numbers[16] != numbers[1]:
        fail(f"scaled: K 16 against K 1, the lines part: {numbers}")
    lines = runs[16]["lines"]
    train_lines = [m for m in lines if m["phase"] == "train"]
    val_lines = [m for m in lines if m["phase"] == "val"]
    steps = max(m["step"] for m in train_lines)
    batch = 256
    val_batches = -(-4 * SCALED_TEST_PER_CLASS // batch)
    if steps != SCALED_EPOCHS * 4 * SCALED_TRAIN_PER_CLASS // batch or \
            len(val_lines) != SCALED_EPOCHS:
        fail(f"scaled: {steps} steps and {len(val_lines)} val lines")
    decodes = steps + SCALED_EPOCHS * (val_batches + 1)
    want = {name: 0 for name in kernels}
    want.update(fused_reparam_kl=steps + SCALED_EPOCHS * val_batches,
                reparam_kl_backward=steps,
                **block_launches(decodes, steps, blocks=SCALED_BLOCKS))
    want16 = plus(want, capture_warmup(kernels, False, train=1, val=1,
                                       blocks=SCALED_BLOCKS))
    if (runs[1]["launches"], runs[16]["launches"]) != (want, want16) or \
            any(r["notes"] != [None] for r in runs.values()):
        fail(f"scaled: kernel launches K 1 {runs[1]['launches']} (want "
             f"{want}), K 16 {runs[16]['launches']} (want {want16}), CONFIG "
             f"notes {[r['notes'] for r in runs.values()]}")
    by_k = {}
    for k, r in runs.items():
        # the step's time from 4 steps of train_steps: under rotation an
        # epoch of 2 steps runs in the last epoch's tail, and its own
        # train_images_per_sec times what is left of it
        steps_out = train_steps(r["cfg"], 4)
        reset_logger()
        by_k[k] = {"seconds": r["seconds"], "peak_mem_gib": r["peak_mem_gib"],
                   "train_images_per_sec": [m["train_images_per_sec"]
                                            for m in r["lines"]
                                            if m["phase"] == "val"],
                   "step_ms": steps_out["timed_seconds"]
                   / steps_out["timed_steps"] * 1e3,
                   "step_dispatch": steps_out["dispatch"],
                   "epoch_wall_seconds": [m["epoch_wall_seconds"]
                                          for m in r["lines"]
                                          if m["phase"] == "epoch_end"],
                   "rotated": [m["rotated"] for m in r["lines"]
                               if m["phase"] == "epoch_end"]}
    # the device's share of a step: 4 steps of the same config profiled
    prof = profile_config(runs[16]["cfg"], by_k[16]["step_ms"], steps=4)
    return {"phase": "scaled", "config": "configs/beta_vae_se_tpu_scaled.yaml",
            "data_parallel": -1, "train_steps": steps,
            "val_batches_per_epoch": val_batches,
            "lines_bitwise_k16_vs_k1": True,
            "totals": [m["train_total_loss"] for m in train_lines],
            "val_total_loss": [m["val_total_loss"] for m in val_lines],
            "launches": runs[16]["launches"], "launches_k1": want,
            "by_k": by_k, "step_ms": by_k[16]["step_ms"],
            "peak_mem_gib": by_k[16]["peak_mem_gib"],
            "profiled": {key: prof[key] for key in (
                "steps", "device_ms_per_step", "forward_upsample_ms",
                "backward_upsample_ms", "device_busy_share",
                "kernels_per_step", "top_kernels_ms_per_step")}}


# --mesh: the scaled config over every visible card, 8 steps an epoch
MESH_TRAIN_PER_CLASS, MESH_TEST_PER_CLASS, MESH_EPOCHS = 512, 32, 3


def mesh_scaled_run(tmp: str, kernels: dict, devices: list, k: int,
                    src: str = "configs/beta_vae_se_tpu_scaled.yaml",
                    blocks: int = SCALED_BLOCKS, **overrides) -> dict:
    """``train()`` of ``src`` over ``devices`` (one spawned rank each, as
    the training CLI's ``--data-parallel`` runs it) at
    ``training.scan_chunk_steps`` ``k`` over the demo data under
    ``<tmp>/mesh/processed``: rank 0's lines (every number finite), every
    rank's checksum and launches, the latest and best checkpoints, the
    CONFIG notes and the wall seconds; every rank must have launched each
    kernel as derived (the capture's warm-up besides at ``k`` > 1; the
    panel's decode on rank 0 alone)."""
    import yaml

    from betavae_tpu_torch.parallel.launch import launch, train_rank

    root = os.path.join(tmp, "mesh", f"k{k}")
    cfg = write_config(src, root, "mesh.yaml", **{
        "training.epochs": MESH_EPOCHS, "training.scan_chunk_steps": k,
        "logging.log_every_n_steps": 1, "logging.log_to_file": True,
        "paths.processed_dir": os.path.join(tmp, "mesh", "processed"),
        **overrides})
    with open(cfg) as f:
        raw = yaml.safe_load(f)
    device = "cpu" if devices[0] == "cpu" else "cuda"
    t0 = time.perf_counter()
    ranks = launch(train_rank, devices, (cfg, "none", device, None))
    seconds = time.perf_counter() - t0
    lines = metrics_lines(os.path.join(root, "outputs", "logs",
                                       f"{raw['paths']['run_id']}.log"))
    for m in lines:
        bad = [key for key, v in m.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            fail(f"mesh (K {k}): non-finite {bad} in {m}")
    steps = max(m["step"] for m in lines if m["phase"] == "train")
    batch = int(raw["training"]["batch_size"])
    val_batches = -(-4 * MESH_TEST_PER_CLASS // batch)
    want = []
    for rank in range(len(devices) if kernels else 0):  # none counted on CPU
        # rank 0 alone decodes the epoch's panel
        decodes = steps + MESH_EPOCHS * (val_batches + (rank == 0))
        w = {name: 0 for name in kernels}
        w.update(fused_reparam_kl=steps + MESH_EPOCHS * val_batches,
                 reparam_kl_backward=steps,
                 **block_launches(decodes, steps, blocks=blocks))
        if k > 1:
            w = plus(w, capture_warmup(kernels, False, train=1, val=1,
                                       blocks=blocks))
        want.append(w)
    launches = [{name: r["launches"][name] for name in kernels}
                for r in ranks]
    if kernels and launches != want:
        fail(f"mesh (K {k}): launches {launches}, want {want}")
    return {"cfg": cfg, "lines": lines, "seconds": seconds, "steps": steps,
            "val_batches": val_batches, "launches": launches,
            "checksums": [r["checksum"] for r in ranks],
            "notes": config_notes(cfg),
            "latest": checkpoint_arrays(cfg, "latest"),
            "best": checkpoint_arrays(cfg, "best")}


def mesh_scaled(tmp: str, kernels: dict, devices: list, **kw) -> dict:
    """The scaled config's ``train()`` over the mesh at its
    ``scan_chunk_steps: 16`` (CUDA-graph replays, the collectives inside
    the graph) and at 1 (eager): rank 0's lines, but the wall times and
    the epoch_end lines, bitwise between the two; the latest and best
    checkpoints bitwise; every rank's parameters bitwise alike and alike
    across K; no CONFIG note; each kernel's launches as derived on every
    rank; at K 16 (graphs launched from the host, each dispatch on the
    rank's dispatcher thread) rank 0's ``rotate_dispatch_seconds`` on a
    rotated epoch at most ROTATE_DISPATCH_LIMIT_S."""
    runs = {k: mesh_scaled_run(tmp, kernels, devices, k, **kw)
            for k in (16, 1)}
    numbers = {k: [{key: v for key, v in m.items()
                    if key not in SCAN_WALL_KEYS}
                   for m in r["lines"] if m["phase"] != "epoch_end"]
               for k, r in runs.items()}
    if numbers[16] != numbers[1]:
        fail(f"mesh: K 16 against K 1, the lines part: {numbers}")
    for tag in ("latest", "best"):
        if not same_checkpoint(runs[16][tag], runs[1][tag]):
            fail(f"mesh: the {tag} checkpoints of K 16 and K 1 differ")
    sums = {s for r in runs.values() for s in r["checksums"]}
    notes = [r["notes"] for r in runs.values()]
    if len(sums) != 1 or notes != [[None], [None]]:
        fail(f"mesh: checksums {[r['checksums'] for r in runs.values()]}, "
             f"CONFIG notes {notes}")
    tails = {k: [m for m in r["lines"] if m["phase"] == "epoch_end"]
             for k, r in runs.items()}
    rotated = [m["rotate_dispatch_seconds"] for m in tails[16] if m["rotated"]]
    if not rotated or max(rotated) > ROTATE_DISPATCH_LIMIT_S:
        fail(f"mesh: rank 0's rotated dispatch at K 16 over "
             f"{ROTATE_DISPATCH_LIMIT_S} s (or none): {tails[16]}")
    lines = runs[16]["lines"]
    return {"ranks": len(devices), "steps": runs[16]["steps"],
            "val_batches_per_epoch": runs[16]["val_batches"],
            "lines_bitwise_k16_vs_k1": True,
            "checkpoints_bitwise_k16_vs_k1": True,
            "replicas_bitwise_equal": True,
            "totals": [m["train_total_loss"] for m in lines
                       if m["phase"] == "train"],
            "val_total_loss": [m["val_total_loss"] for m in lines
                               if m["phase"] == "val"],
            "launches_by_rank": {k: r["launches"] for k, r in runs.items()},
            "by_k": {k: {"seconds": r["seconds"],
                         "train_images_per_sec": [
                             m["train_images_per_sec"] for m in r["lines"]
                             if m["phase"] == "val"],
                         "epoch_wall_seconds": [
                             m["epoch_wall_seconds"] for m in r["lines"]
                             if m["phase"] == "epoch_end"],
                         "rotated": [m["rotated"] for m in tails[k]],
                         "rotate_dispatch_seconds": [
                             m["rotate_dispatch_seconds"] for m in tails[k]],
                         "val_dispatch_seconds": [
                             m["val_dispatch_seconds"] for m in tails[k]]}
                     for k, r in runs.items()}}


# --mesh: the flagship over every card, epochs of one chunk of
# MESH_CHUNK_STEPS steps (4 × 512 train images in global batches of 32)
MESH_FLAGSHIP_TRAIN_PER_CLASS, MESH_CHUNK_STEPS = 512, 64


def mesh_flagship_rotation(tmp: str, kernels: dict, devices: list,
                           limit: float | None = ROTATE_DISPATCH_LIMIT_S
                           ) -> dict:
    """``train()`` of the flagship config (128 px, global batch 32, the
    default head) over ``devices`` (``mesh_scaled_run``'s checks) for
    MESH_EPOCHS epochs of one chunk of MESH_CHUNK_STEPS launches of the
    step (rotated: the next epoch's chunk dispatched from the tail) and 4
    validation batches, over seeded 128 px demo data: rank 0's
    ``rotate_dispatch_seconds``, ``val_dispatch_seconds`` and tail seconds
    an epoch; fails when a rotated epoch's dispatch is over ``limit``
    (None: reported only)."""
    from betavae_tpu_torch.data.demo import generate_demo_data

    data = os.path.join(tmp, "mesh_flagship", "processed")
    generate_demo_data(data, train_per_class=MESH_FLAGSHIP_TRAIN_PER_CLASS,
                       test_per_class=MESH_TEST_PER_CLASS, size=128)
    run = mesh_scaled_run(tmp, kernels, devices, MESH_CHUNK_STEPS,
                          src="configs/beta_vae_se.yaml",
                          blocks=FLAGSHIP_BLOCKS,
                          **{"paths.processed_dir": data})
    tails = [m for m in run["lines"] if m["phase"] == "epoch_end"]
    rotated = [m["rotate_dispatch_seconds"] for m in tails if m["rotated"]]
    if limit is not None and (not rotated or max(rotated) > limit):
        fail(f"mesh (flagship, K {MESH_CHUNK_STEPS}): rank 0's rotated "
             f"dispatch over {limit} s (or none): {tails}")
    return {"steps": run["steps"], "chunk_steps": MESH_CHUNK_STEPS,
            "seconds": run["seconds"], "launches": run["launches"],
            "replicas_bitwise_equal": len(set(run["checksums"])) == 1,
            **{key: [m[key] for m in tails] for key in (
                "rotated", "rotate_dispatch_seconds", "val_dispatch_seconds",
                "tail_seconds", "epoch_wall_seconds")},
            "train_images_per_sec": [m["train_images_per_sec"]
                                     for m in run["lines"]
                                     if m["phase"] == "val"]}


def run_mesh(tmp: str, kernels: dict) -> dict:
    """``--mesh``: every visible card (at least 2) as one NCCL mesh, the
    path the scaled config's ``--data-parallel -1`` deployment runs: (a)
    :func:`mesh_scaled` over seeded 256 px demo data (MESH_EPOCHS epochs
    of 8 steps at the global batch 256, 64 rows a rank); (b) the dry run
    (one eager step, replicas bitwise, the loss within 2e-3 of one
    process's); (c) the bench's ``--data-parallel`` over every card and
    over one, in turns (N, 1, 1, N), each replayed over NCCL; (d)
    :func:`mesh_flagship_rotation`, rotated epochs of one chunk of
    MESH_CHUNK_STEPS host launches, each rank's on its dispatcher
    thread."""
    from betavae_tpu_torch import bench
    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.parallel.dryrun import dryrun
    from betavae_tpu_torch.parallel.mesh import mesh_devices

    devices = mesh_devices(-1, "cuda")
    if len(devices) < 2:
        fail(f"--mesh needs at least 2 cards, sees {devices}")
    t0 = time.perf_counter()
    generate_demo_data(os.path.join(tmp, "mesh", "processed"),
                       train_per_class=MESH_TRAIN_PER_CLASS,
                       test_per_class=MESH_TEST_PER_CLASS, size=256)
    scaled = mesh_scaled(tmp, kernels, devices)
    dry = dryrun(devices)
    turns = []
    for n in (len(devices), 1, 1, len(devices)):
        line = bench.main(["--data-parallel", str(n), "--skip-e2e",
                           "--scan-chunk", "32", "--steps", "96",
                           "--warmup", "32"])
        if not (line["backend"] == "nccl" and line["dispatch"] == "cuda_graph"
                and line["mesh_devices"] == n
                and math.isfinite(line["value"])):
            fail(f"mesh (c): bench line {line}")
        turns.append([n, line["value"], line["step_ms"]])
    rotation = mesh_flagship_rotation(tmp, kernels, devices)
    return {"phase": "mesh", "devices": devices,
            "seconds": time.perf_counter() - t0, "scaled": scaled,
            "flagship_rotation": rotation, "dryrun": dry,
            "bench_in_turns": {"ranks_images_per_sec_step_ms": turns,
                               "scan_chunk": 32, "global_batch": 32}}


def profile_flagship(tmp: str, step_ms: float, fused_head: bool,
                     mesh=None, **overrides) -> dict:
    """Device time per flagship step by kernel over a second short run of
    the same config (:func:`profile_config`)."""
    return {"phase": "profile", "fused_head": fused_head,
            "overrides": overrides,
            **profile_config(flagship_config(tmp, fused_head, **overrides),
                             step_ms, mesh=mesh)}


def profile_config(cfg: str, step_ms: float, steps: int = 8,
                   mesh=None) -> dict:
    """Device time per step by kernel (``torch.profiler``) over ``steps``
    steps of ``train_steps`` on the config at ``cfg`` (on ``mesh`` when
    given); its busy share is the device time per step over ``step_ms``,
    an unprofiled run's step time.  ``collective_kernels_per_step`` counts
    NCCL's kernels, ``launches_per_step_by_kernel`` the hand-written
    kernels' (``PROFILED_KERNELS``' names).  The profiler starts once the
    trainer has captured its step (``TrainChunks.prepare``), so the
    capture's warm-up steps are not counted: the window holds the ``steps``
    steps alone, replayed or eager."""
    import re
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train import chunks
    from betavae_tpu_torch.train.loop import train_steps

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prepare = chunks.TrainChunks.prepare

    def prepare_then_profile(self, images):
        seconds = prepare(self, images)
        torch.cuda.synchronize()
        prof.start()
        return seconds

    try:
        with mock.patch.object(chunks.TrainChunks, "prepare",
                               prepare_then_profile):
            train_steps(cfg, steps, mesh=mesh)
    finally:
        prof.stop()
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
    return {"steps": steps,
            "device_ms_per_step": device_ms,
            "elbo_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "reparam_kl_kernel" in name),
            "elbo_backward_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "reparam_kl_backward_kernel" in name),
            "head_fwd_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "head_fwd_" in name),     # either path's kernel
            "head_m_kernel_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "head_m_" in name),
            **{f"{part}_upsample_ms": sum(
                ms for name, ms in per_kernel.items() if key in name)
               for part, key in (("forward", "upsample2x_fwd"),
                                 ("backward", "upsample2x_bwd"))},
            "device_busy_share": device_ms / step_ms,
            "kernels_per_step": len(work) / steps,
            "collective_kernels_per_step": sum(
                "nccl" in e.name.lower() for e in work) / steps,
            "launches_per_step_by_kernel": {
                name: sum(re.search(pattern, e.name) is not None
                          for e in work) / steps
                for name, (pattern, _) in PROFILED_KERNELS.items()},
            "collective_device_ms_per_step": sum(
                ms for name, ms in per_kernel.items()
                if "nccl" in name.lower()),
            "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top]}


def upsample_in_turns(tmp: str) -> dict:
    """The flagship's default-head step with the upsample kernels and with
    ``F.interpolate`` in their place (the library call, whose backward
    scatters with atomics), in turns (kernel, library, library, kernel):
    each turn's step ms over FLAGSHIP_STEPS steps, and its device ms a
    step, busy share and largest kernels over 8 profiled steps; and
    before them, over 4 steps, how many of the dy that the backward
    wrapper receives are not contiguous (each would be copied)."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.ops import upsample
    from betavae_tpu_torch.train.loop import train_steps

    def library(x):
        with torch.autocast(x.device.type, enabled=False):
            return F.interpolate(x, scale_factor=2, mode="bilinear",
                                 align_corners=False)

    cfg = flagship_config(tmp, False)
    # whether the backward's dy.contiguous() copies on this path: the
    # layout of each dy the decoder's blocks hand it, over a few steps
    seen = []
    backward = upsample.upsample2x_backward

    def recording(dy):
        seen.append(dy.is_contiguous())
        return backward(dy)

    with mock.patch.object(upsample, "upsample2x_backward", recording):
        train_steps(cfg, 4)
        reset_logger()
    dy_layout = {"backward_calls": len(seen),
                 "dy_not_contiguous": seen.count(False)}
    turns = {"kernel": [], "library": []}
    for tag in ("kernel", "library", "library", "kernel"):
        with (mock.patch.object(upsample, "bilinear_upsample_x2", library)
              if tag == "library" else contextlib.nullcontext()):
            run = train_steps(cfg, FLAGSHIP_STEPS)
            reset_logger()
            step_ms = run["timed_seconds"] / run["timed_steps"] * 1e3
            prof = profile_flagship(tmp, step_ms, fused_head=False)
        if not all(map(math.isfinite, run["totals"])):
            fail(f"upsample_in_turns ({tag}): totals {run['totals']}")
        turns[tag].append({"step_ms": step_ms,
                           "device_ms_per_step": prof["device_ms_per_step"],
                           "device_busy_share": prof["device_busy_share"],
                           "kernels_per_step": prof["kernels_per_step"],
                           "top_kernels_ms_per_step":
                               prof["top_kernels_ms_per_step"][:6]})
    return {"phase": "upsample_in_turns", "dy_layout": dy_layout, **turns}


def metrics_lines(log_path: str) -> list:
    """The log's METRICS lines but the ``spans`` lines, which hold the
    host's and the device's times and which the JAX package does not
    log."""
    with open(log_path) as f:
        lines = [json.loads(line.split("| METRICS ", 1)[1])
                 for line in f if "| METRICS " in line]
    return [m for m in lines if m["phase"] != "spans"]


def run_epochs(tmp: str, kernels: dict) -> dict:
    """The epoch trainer on the flagship at full width with the fused head
    and the background checkpoint writer (the config's
    ``training.async_checkpoint: true``): EPOCHS_FIRST epochs, then
    ``resume="latest"`` with ``training.epochs`` raised to EPOCHS_TOTAL.
    Every epoch must log finite train, val and epoch_end lines; latest and
    best must stand as 2 shards each; the resumed run must start at epoch
    EPOCHS_FIRST + 1 with the step count carried over; and each kernel
    must launch once per forward that runs it: head forward per train
    step, val batch and panel, M per train step, the reparam+KL forward per
    train step and val batch and its backward per train step only, the GN
    kernels never."""
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
    paths = head_paths(kernels)
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
    decodes = train_steps + EPOCHS_TOTAL * (val_batches + 1)
    want = {"head_forward": decodes, "head_m": train_steps,
            "fused_reparam_kl": train_steps + EPOCHS_TOTAL * val_batches,
            "reparam_kl_backward": train_steps,
            **block_launches(decodes, train_steps)}
    # the two train() calls each capture a train step and a validation
    # batch
    want = plus(want, capture_warmup(kernels, True, train=2, val=2))
    if launches != want:
        fail(f"epochs: kernel launches {launches}, want {want}")
    return {"phase": "epochs", "epochs": EPOCHS_TOTAL,
            "resumed_at_epoch": resumed_first["epoch"],
            "train_steps": train_steps, "val_batches_per_epoch": val_batches,
            "launches": launches, "head_launches_by_path": paths,
            "seconds": seconds,
            "train_images_per_sec": [m["train_images_per_sec"]
                                     for m in val_lines],
            "steady_train_images_per_sec": [m["train_images_per_sec"]
                                            for m in val_lines[1:]],
            "val_total_loss": [m["val_total_loss"] for m in val_lines],
            "latent_probe_auc": [m["latent_probe_auc"] for m in val_lines],
            "epoch_wall_seconds": [m["epoch_wall_seconds"] for m in lines
                                   if m["phase"] == "epoch_end"],
            # the training thread's share of each epoch's checkpoint saves:
            # the device snapshot and the queueing, the background writer's
            # pull and file writes excluded
            "ckpt_seconds": [m["ckpt_seconds"] for m in lines
                             if m["phase"] == "epoch_end"],
            "peak_mem_gib": peak}


# the rotation phase: train() on the epochs config for ROTATION_EPOCHS
# epochs (3 steps and 1 validation batch an epoch), rotation on and off in
# turns; then an early stop at epoch 2 of ROTATION_STOP_EPOCHS
ROTATION_EPOCHS, ROTATION_STOP_EPOCHS = 3, 6
# the epoch_end keys that are host times and stamps (``rotated`` is not)
TAIL_TIME_KEYS = ("val_seconds", "val_dispatch_seconds",
                  "rotate_dispatch_seconds", "probe_seconds", "ckpt_seconds",
                  "panel_seconds", "tail_seconds", "epoch_wall_seconds",
                  "t_mono", "t_drain_mono")


def pooled_rate(tails: list, images: int) -> float:
    """Images a second over the run's ``t_drain_mono`` stamps (the bench's
    pooled e2e rate, every span)."""
    stamps = [t["t_drain_mono"] for t in tails]
    return images * (len(stamps) - 1) / (stamps[-1] - stamps[0])


def checkpoint_arrays(cfg: str, tag: str) -> dict:
    """``<run_id>_<tag>.pt`` of ``cfg``'s run, loaded."""
    import yaml

    from betavae_tpu_torch.io.checkpoint import load_sharded_checkpoint

    with open(cfg) as f:
        raw = yaml.safe_load(f)
    return load_sharded_checkpoint(os.path.join(
        raw["paths"]["models_dir"], f"{raw['paths']['run_id']}_{tag}.pt"))


def same_checkpoint(a: dict, b: dict) -> bool:
    """Two loaded checkpoints with the same scalars and, bit for bit, the
    same tensors under the same keys."""
    import numpy as np

    return (all(a[k] == b[k] for k in ("epoch", "total_steps", "val_total"))
            and all(sorted(a[sec]) == sorted(b[sec])
                    and all(np.array_equal(np.asarray(a[sec][k]),
                                           np.asarray(b[sec][k]))
                            for k in a[sec])
                    for sec in ("model_state", "optim_state")))


def epochs_launches(kernels: dict, train_steps: int, epochs: int) -> dict:
    """The fused flagship's launches in a ``train()`` of ``epochs`` epochs
    of the ``epochs`` config (one validation batch and a panel an epoch)
    with ``train_steps`` train steps run, and its one capture's warm-up."""
    decodes = train_steps + epochs * 2
    return plus({"head_forward": decodes, "head_m": train_steps,
                 "fused_reparam_kl": train_steps + epochs,
                 "reparam_kl_backward": train_steps,
                 **block_launches(decodes, train_steps)},
                capture_warmup(kernels, True, train=1, val=1))


def run_rotation(tmp: str, kernels: dict) -> dict:
    """Epoch rotation and the background panel writer in ``train()`` on the
    ``epochs`` config (the fused flagship at full width, the background
    checkpoint writer), ROTATION_EPOCHS epochs with
    ``training.epoch_rotation`` true and false in turns (on, off, off, on):
    every METRICS line bitwise but the wall times (the epoch_end lines: but
    the host times and stamps), ``latest`` and ``best`` bitwise, ``rotated``
    true on epochs 1 … E − 1 and false on E (false throughout with it off),
    the launches as derived and equal, every panel's files there when
    ``train()`` returns (after the ``epochs`` phase, whose data it reads).
    Then an early stop at epoch 2 of ROTATION_STOP_EPOCHS with rotation
    on: ``latest`` says epoch 2, the returned model and optimizer state
    are bitwise its tensors, and the discarded epoch-3 chunk's launches are
    counted.  A fifth run, rotation on, takes the path of one of several
    ranks (``forced_host_path``): every check above against the first
    run, and a rotated epoch's ``rotate_dispatch_seconds`` over
    ROTATE_DISPATCH_LIMIT_S fails.  Reports each run's pooled rate over its
    drain stamps, its tail seconds and its dispatch seconds."""
    from unittest import mock

    import torch

    from betavae_tpu_torch.io.weights import optim_state_tensors
    from betavae_tpu_torch.train import loop

    runs = []
    for n, (rotate, host_path) in enumerate((
            (True, False), (False, False), (False, False), (True, False),
            (True, True))):
        cfg = epochs_config(tmp, os.path.join(tmp, "rotation", f"run{n}"),
                            "config.yaml", **{
                                "training.epochs": ROTATION_EPOCHS,
                                "training.epoch_rotation": rotate})
        zero_counts(kernels)
        with (forced_host_path() if host_path
              else contextlib.nullcontext()):
            out, lines = _train_lines(cfg)
        launches = read_counts(kernels)
        figures = os.path.join(tmp, "rotation", f"run{n}", "outputs",
                               "figures")
        panels = sorted(f for f in os.listdir(figures)
                        if f.startswith("recon_epoch"))
        tails = [m for m in lines if m["phase"] == "epoch_end"]
        runs.append({
            "rotate": rotate, "host_path": host_path, "out": out,
            "launches": launches,
            "panels": panels, "tails": tails,
            "numbers": [{k: v for k, v in m.items()
                         if k not in SCAN_WALL_KEYS + TAIL_TIME_KEYS
                         + ("rotated",)} for m in lines],
            "checkpoints": {tag: checkpoint_arrays(cfg, tag)
                            for tag in ("latest", "best")}})
    steps = runs[0]["out"]["total_steps"]
    want = epochs_launches(kernels, steps, ROTATION_EPOCHS)
    want_panels = sorted(f"recon_epoch{e}{suffix}"
                         for e in range(1, ROTATION_EPOCHS + 1)
                         for suffix in (".png", "_diff.png", "_stats.json"))
    for r in runs:
        want_rotated = ([True] * (ROTATION_EPOCHS - 1) + [False]
                        if r["rotate"] else [False] * ROTATION_EPOCHS)
        same_lines = r["numbers"] == runs[0]["numbers"]
        slow = [t["rotate_dispatch_seconds"] for t in r["tails"]
                if t["rotated"] and r["host_path"]
                and t["rotate_dispatch_seconds"] > ROTATE_DISPATCH_LIMIT_S]
        if (not same_lines or slow
                or [t["rotated"] for t in r["tails"]] != want_rotated
                or r["launches"] != want or r["panels"] != want_panels
                or not all(same_checkpoint(r["checkpoints"][tag],
                                           runs[0]["checkpoints"][tag])
                           for tag in ("latest", "best"))):
            fail(f"rotation (epoch_rotation {r['rotate']}, host path "
                 f"{r['host_path']}): rotated dispatch seconds over "
                 f"{ROTATE_DISPATCH_LIMIT_S}: {slow}, rotated "
                 f"{[t['rotated'] for t in r['tails']]} (want "
                 f"{want_rotated}), launches {r['launches']} (want {want}), "
                 f"panels {r['panels']}, lines equal {same_lines}, "
                 f"checkpoints equal "
                 f"{[same_checkpoint(r['checkpoints'][t], runs[0]['checkpoints'][t]) for t in ('latest', 'best')]}")

    class StopAtTwo:
        def __init__(self, *args, **kwargs):
            self.calls = 0
            self.should_stop = False

        def update(self, value):
            self.calls += 1
            self.should_stop = self.calls >= 2

    cfg = epochs_config(tmp, os.path.join(tmp, "rotation", "early"),
                        "config.yaml", **{
                            "training.epochs": ROTATION_STOP_EPOCHS,
                            "training.epoch_rotation": True})
    zero_counts(kernels)
    with mock.patch.object(loop, "EarlyStopping", StopAtTwo):
        out, lines = _train_lines(cfg)
    launches = read_counts(kernels)
    latest = checkpoint_arrays(cfg, "latest")
    per_epoch = steps // ROTATION_EPOCHS
    live = {"model_state": out["model"].state_dict(),
            "optim_state": optim_state_tensors(out["optimizer"].optimizer)}
    mismatched = [f"{sec}/{k}" for sec, part in live.items()
                  for k, v in part.items()
                  if not torch.equal(v.detach().cpu(),
                                     torch.as_tensor(latest[sec][k]))]
    # epochs 1 and 2 ran and were drained; epoch 3's one chunk ran and was
    # discarded; the validation passes and panels of epochs 1 and 2
    want_early = epochs_launches(kernels, 3 * per_epoch, 2)
    rotated = [m["rotated"] for m in lines if m["phase"] == "epoch_end"]
    if (latest["epoch"], out["epoch"], out["total_steps"]) != (
            2, 2, 2 * per_epoch) or mismatched or set(latest["model_state"]) \
            != set(live["model_state"]) or launches != want_early \
            or rotated != [True, True]:
        fail(f"rotation (early stop): latest epoch {latest['epoch']}, "
             f"returned epoch {out['epoch']} / {out['total_steps']} steps, "
             f"mismatched {mismatched}, launches {launches} (want "
             f"{want_early}), rotated {rotated}")
    images = steps // ROTATION_EPOCHS * 32
    return {"phase": "rotation", "epochs": ROTATION_EPOCHS,
            "lines_bitwise": True, "checkpoints_bitwise": True,
            "launches": runs[0]["launches"],
            "runs": [{"epoch_rotation": r["rotate"],
                      "host_path": r["host_path"],
                      "rotated": [t["rotated"] for t in r["tails"]],
                      "pooled_images_per_sec": pooled_rate(r["tails"], images),
                      "tail_seconds": [t["tail_seconds"] for t in r["tails"]],
                      "rotate_dispatch_seconds": [
                          t["rotate_dispatch_seconds"] for t in r["tails"]],
                      "val_dispatch_seconds": [
                          t["val_dispatch_seconds"] for t in r["tails"]],
                      "panel_seconds": [t["panel_seconds"]
                                        for t in r["tails"]]}
                     for r in runs],
            "early_stop": {"latest_epoch": latest["epoch"],
                           "returned_bitwise_latest": True,
                           "launches": launches,
                           "discarded_chunk_steps": per_epoch}}


def rotation_e2e_in_turns(tmp: str) -> dict:
    """The bench's e2e estimator (``train()`` over the bench's e2e data,
    182 steps an epoch: one chunk) for 3 epochs with
    ``training.epoch_rotation`` true and false in turns (on, off, off,
    on): the pooled rate (one span, epoch 2's tail and epoch 3), the
    steady epochs' tail by part, each epoch's rotated dispatch seconds
    (fails above ROTATE_DISPATCH_LIMIT_S on a rotated epoch), tail seconds
    and train images/s, each chunk's dispatch seconds, the capture's
    seconds and the peak memory; and each rotated run's tails (epochs 1-2)
    and train images/s (epochs 2-3) over the unrotated runs' mean.  A
    fifth run, rotation on, takes the path of one of several ranks
    (``forced_host_path``: each chunk's 182 launches from the host, on the
    dispatcher thread), under the same limit, with each epoch's
    ``val_dispatch_seconds``."""
    import gc

    import torch

    from betavae_tpu_torch import bench

    turns = []
    for rotate, host_path in ((True, False), (False, False), (False, False),
                              (True, False), (True, True)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with timed_dispatches() as dispatches, timed_prepares() as prepares, \
                (forced_host_path() if host_path
                 else contextlib.nullcontext()):
            with contextlib.redirect_stdout(sys.stderr):
                rate, breakdown = bench._e2e_images_per_sec(
                    epochs=3, work_dir=os.path.join(tmp, "bench_e2e"),
                    training={"epoch_rotation": rotate})
        rotated = [s for s, on in zip(breakdown["rotate_dispatch_seconds"],
                                      breakdown["rotated_by_epoch"]) if on]
        if (not math.isfinite(rate) or breakdown["rotated_epochs"] != (
                2 if rotate else 0)
                or any(s > ROTATE_DISPATCH_LIMIT_S for s in rotated)):
            fail(f"rotation e2e (epoch_rotation {rotate}, host path "
                 f"{host_path}): rate {rate}, "
                 f"a rotated dispatch over {ROTATE_DISPATCH_LIMIT_S} s, or "
                 f"breakdown {breakdown}")
        turns.append({"epoch_rotation": rotate, "host_path": host_path,
                      "e2e_images_per_sec": rate,
                      **{key: breakdown[key] for key in (
                          "val_seconds", "probe_seconds", "ckpt_seconds",
                          "tail_seconds", "epoch_wall_seconds",
                          "rotate_dispatch_seconds", "val_dispatch_seconds",
                          "tail_seconds_by_epoch",
                          "train_images_per_sec_by_epoch", "dispatch")},
                      "dispatch_host_seconds": dispatches,
                      "capture_seconds": prepares,
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2**30})
    off = [t for t in turns if not t["epoch_rotation"]]

    def over_unrotated(key: str, epochs) -> list:
        return [[t[key][e] / statistics.mean(o[key][e] for o in off)
                 for e in epochs] for t in turns
                if t["epoch_rotation"] and not t["host_path"]]

    return {"phase": "rotation_e2e", "turns": turns,
            "rotated_tail_over_unrotated": over_unrotated(
                "tail_seconds_by_epoch", (0, 1)),
            "next_epoch_images_per_sec_over_unrotated": over_unrotated(
                "train_images_per_sec_by_epoch", (1, 2))}


def _train_lines(cfg_path: str, resume: str = "none") -> tuple:
    """``train()`` of ``cfg_path`` (its log written to a file) → (its
    output, its METRICS lines)."""
    import yaml

    from betavae_tpu_torch.config import reset_config_cache
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    reset_config_cache()
    reset_logger()
    out = train(cfg_path, resume=resume)
    reset_logger()
    reset_config_cache()
    log = os.path.join(cfg["paths"]["outputs_dir"], "logs",
                       f"{cfg['paths']['run_id']}.log")
    return out, metrics_lines(log)


def epochs_config(tmp: str, root: str, name: str, **overrides) -> str:
    """The ``epochs`` phase's config (the flagship at full width, fused
    head, its data) under ``root``, with ``overrides``."""
    return write_config(
        "configs/beta_vae_se.yaml", root, name,
        **{"training.fused_head": True, "logging.log_every_n_steps": 1,
           "logging.log_to_file": True,
           "paths.processed_dir": os.path.join(tmp, "epochs", "processed"),
           **overrides})


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def run_reference_ckpt(tmp: str, kernels: dict) -> dict:
    """The ``epochs`` run's ``latest`` exported by the port's exporter with
    its Adam state, as ``<run_id>_latest_shard{0,1}.pt`` in a fresh models
    dir (the reference's torch-pickle layout): ``train(resume="latest")``
    from it for one more epoch must log a first total within 1e-5 relative
    of the same resume from a copy of the native checkpoint, the Adam
    moments it loads must equal the native ones bitwise, each kernel must
    launch as the epoch's steps, validation batches and panel say, and
    ``infer.encode`` on the shards must give the native checkpoint's
    latents within 1e-5 relative.  Prints the export's and the load's
    seconds."""
    import shutil

    import numpy as np
    import torch

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.infer import encode
    from betavae_tpu_torch.io import export_torch_checkpoint
    from betavae_tpu_torch.io.checkpoint import (discover_shards,
                                                 load_sharded_checkpoint)
    from betavae_tpu_torch.models.beta_vae import model_from_config
    from betavae_tpu_torch.train.callbacks import restore_training_state
    from betavae_tpu_torch.train.optim import build_optimizer

    root = os.path.join(tmp, "reference")
    native_src = os.path.join(tmp, "epochs", "outputs", "models")
    dirs = {"native": os.path.join(root, "native_models"),
            "reference": os.path.join(root, "reference_models")}
    shutil.copytree(native_src, dirs["native"])
    configs = {tag: epochs_config(
        tmp, os.path.join(root, tag), f"{tag}.yaml",
        **{"paths.models_dir": d, "training.epochs": EPOCHS_TOTAL + 1})
        for tag, d in dirs.items()}

    reset_config_cache()
    t0 = time.perf_counter()
    paths = export_torch_checkpoint.main(
        ["--config", configs["native"], "--checkpoint", "latest",
         "--output", os.path.join(dirs["reference"], "beta_vae_se_latest.pt"),
         "--include-optimizer"])
    export_seconds = time.perf_counter() - t0
    if [os.path.basename(p) for p in paths] != [
            "beta_vae_se_latest_shard0.pt", "beta_vae_se_latest_shard1.pt"]:
        fail(f"reference_ckpt: exported {paths}")

    # the moments as loaded, each side into a fresh model and optimizer
    loaded, load_seconds = {}, None
    for tag, d in dirs.items():
        reset_config_cache()
        cfg = get_config(configs[tag])
        model = model_from_config(cfg)
        opt = build_optimizer(model.parameters(), cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_training_state(load_sharded_checkpoint(
            os.path.join(d, "beta_vae_se_latest.pt")), model, opt)
        torch.cuda.synchronize()
        if tag == "reference":
            load_seconds = time.perf_counter() - t0
        loaded[tag] = (model.state_dict(), opt.optimizer.state_dict()["state"])
    reset_config_cache()
    (w_nat, m_nat), (w_ref, m_ref) = loaded["native"], loaded["reference"]
    moments_equal = set(m_nat) == set(m_ref) and all(
        torch.equal(m_nat[i][f], m_ref[i][f])
        for i in m_nat for f in ("step", "exp_avg", "exp_avg_sq"))
    weights_equal = all(torch.equal(w_nat[k], w_ref[k]) for k in w_nat)
    if not (moments_equal and weights_equal and
            float(m_ref[0]["step"]) > 0):
        fail(f"reference_ckpt: loaded moments equal {moments_equal}, "
             f"weights equal {weights_equal}")

    # infer.encode on each checkpoint, before the resumed runs overwrite
    # them (each in its own models and tables dirs)
    latents = {}
    for tag, d in dirs.items():
        cfg_path = epochs_config(
            tmp, os.path.join(root, f"encode_{tag}"), "encode.yaml",
            **{"paths.models_dir": os.path.join(root, f"encode_{tag}",
                                                "models")})
        os.makedirs(os.path.join(root, f"encode_{tag}", "models"))
        for shard in discover_shards(os.path.join(d, "beta_vae_se_latest.pt")):
            shutil.copy(shard, os.path.join(root, f"encode_{tag}", "models"))
        _cli(encode.main, ["--config", cfg_path])
        latents[tag] = np.load(os.path.join(
            root, f"encode_{tag}", "outputs", "tables",
            "test_latents_mu.npy"))
    latent_rel = float(np.abs(latents["reference"] - latents["native"]).max()
                       / np.abs(latents["native"]).max())
    if latents["reference"].shape != latents["native"].shape or \
            not latent_rel <= 1e-5:
        fail(f"reference_ckpt: encode latents max rel {latent_rel}")
    runs = {}
    for tag in ("native", "reference"):
        zero_counts(kernels)
        out, lines = _train_lines(configs[tag], resume="latest")
        runs[tag] = {"out": out, "lines": lines,
                     "launches": read_counts(kernels)}
    first = {tag: next(m for m in r["lines"] if m["phase"] == "train")
             for tag, r in runs.items()}
    steps = runs["reference"]["out"]["total_steps"] - first["reference"][
        "step"] + 1
    want = plus({"head_forward": steps + 1 + 1, "head_m": steps,
                 "fused_reparam_kl": steps + 1, "reparam_kl_backward": steps,
                 **block_launches(steps + 1 + 1, steps)},
                capture_warmup(kernels, True, train=1, val=1))
    total_rel = _rel(first["reference"]["train_total_loss"],
                     first["native"]["train_total_loss"])
    if not (first["reference"]["epoch"] == EPOCHS_TOTAL + 1
            and first["reference"]["step"] == first["native"]["step"]
            and total_rel <= 1e-5
            and runs["reference"]["launches"] == want):
        fail(f"reference_ckpt: first resumed lines {first} (rel "
             f"{total_rel}), launches {runs['reference']['launches']}, "
             f"want {want}")

    return {"phase": "reference_ckpt", "exported": paths,
            "export_seconds": export_seconds,
            "load_seconds": load_seconds,
            "resumed_epoch": first["reference"]["epoch"],
            "first_total": {t: f["train_total_loss"] for t, f in first.items()},
            "first_total_rel": total_rel, "moments_bitwise": moments_equal,
            "step_count": float(m_ref[0]["step"]),
            "launches": runs["reference"]["launches"],
            "encode_latents_max_rel": latent_rel,
            "latents_shape": list(latents["reference"].shape)}


def remat_gradients(tmp: str) -> dict:
    """One backward of the fused flagship at full width from the same
    weights and batch at each ``training.remat`` mode, and without remat a
    second time, in fp32 with TF32 off (where two backwards from one state
    still part by ~1e-7 on the card, unlike the bf16 steps): the
    loss must be bitwise the no-remat one and the gradients within 1e-5 of
    it (‖g − g₀‖ / ‖g₀‖ over every parameter)."""
    import torch

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.models.beta_vae import (model_from_config,
                                                   resolve_remat)
    from betavae_tpu_torch.models.losses import loss_spec_from_config
    from betavae_tpu_torch.train.step import _forward_losses

    reset_config_cache()
    cfg = get_config(flagship_config(tmp, True,
                                     **{"training.mixed_precision": False}))
    model = model_from_config(cfg).train()
    spec = loss_spec_from_config(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((int(cfg.training.batch_size), 1, 128, 128), generator=g,
                   device="cuda")
    mask = torch.ones(x.shape[0], device="cuda")
    sched = {"beta": 1.0, "capacity": 30.0, "capacity_weight": 1.0,
             "free_bits": 0.0, "lr": 5e-4}
    runs = {}
    # put back as found: a later phase's numbers depend on them
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for tag, mode in (("false", False), ("false_rerun", False),
                          ("decoder", "decoder"), ("true", True)):
            model.remat = resolve_remat(mode)
            model.zero_grad(set_to_none=True)
            losses = _forward_losses(model, x, mask, sched, spec=spec,
                                     use_capacity=True, seed=1, offset=1)
            losses["total"].backward()
            runs[tag] = (losses["total"].detach().clone(), torch.cat(
                [p.grad.flatten() for p in model.parameters()]))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        reset_config_cache()
    loss0, grad0 = runs["false"]
    out = {tag: {"loss_bitwise": bool(torch.equal(loss, loss0)),
                 "grad_rel": float((grad - grad0).norm() / grad0.norm())}
           for tag, (loss, grad) in runs.items()}
    if not all(r["loss_bitwise"] and r["grad_rel"] <= 1e-5
               for r in out.values()):
        fail(f"remat: one fp32 backward from the same state: {out}")
    return out


def cudnn_determinism(tmp: str, kernels: dict) -> dict:
    """Why the trainer runs cuDNN's deterministic algorithms, and what it
    costs.  One fp32 backward of the fused flagship (TF32 off) from the
    same weights and batch three times, with cuDNN's default algorithm
    choice and with ``torch.backends.cudnn.deterministic``: the largest
    gradient difference between the three and the parameters whose
    gradients differ (the record of the cause).  Then the default-head
    flagship's step ms through ``train_steps`` (``run_flagship``,
    FLAGSHIP_STEPS steps) in fp32 (``training.mixed_precision: false``) and
    in bf16, with the trainer's setting patched out (off: PyTorch's default
    algorithm choice) and as the trainer runs it (on), in turns (off, on,
    on, off).  Reported, not bounded; the ``replay`` phase holds the fp32
    and bf16 runs bitwise."""
    from unittest import mock

    import torch

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.models.beta_vae import model_from_config
    from betavae_tpu_torch.models.losses import loss_spec_from_config
    from betavae_tpu_torch.train import loop
    from betavae_tpu_torch.train.step import _forward_losses

    reset_config_cache()
    cfg = get_config(flagship_config(tmp, True,
                                     **{"training.mixed_precision": False}))
    torch.manual_seed(0)
    model = model_from_config(cfg).train()
    spec = loss_spec_from_config(cfg)
    reset_config_cache()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((int(cfg.training.batch_size), 1, 128, 128), generator=g,
                   device="cuda")
    mask = torch.ones(x.shape[0], device="cuda")
    sched = {"beta": 1.0, "capacity": 30.0, "capacity_weight": 1.0,
             "free_bits": 0.0, "lr": 5e-4}

    def grads():
        model.zero_grad(set_to_none=True)
        _forward_losses(model, x, mask, sched, spec=spec, use_capacity=True,
                        seed=1, offset=1)["total"].backward()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    fp32 = {}
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for tag, on in (("default", False), ("deterministic", True)):
            torch.backends.cudnn.deterministic = on
            runs = [grads() for _ in range(3)]
            diff = {n: max(float((r[n] - runs[0][n]).abs().max())
                           for r in runs[1:]) for n in runs[0]}
            fp32[tag] = {"max_abs_diff": max(diff.values()),
                         "params_differing": sorted(n for n, d in diff.items()
                                                    if d)}
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    step_ms = {}
    for tag, overrides in (("fp32", {"training.mixed_precision": False}),
                           ("bf16", {})):
        turns = {"off": [], "on": []}
        for on in (False, True, True, False):
            with (contextlib.nullcontext() if on else mock.patch.object(
                    loop, "deterministic_cudnn", contextlib.nullcontext)):
                if not on and torch.backends.cudnn.deterministic:
                    fail("cudnn_determinism: the flag is on outside the "
                         "trainer")
                turns["on" if on else "off"].append(run_flagship(
                    tmp, kernels, fused_head=False, **overrides)["step_ms"])
        step_ms[tag] = turns
    return {"phase": "cudnn_determinism", "fp32_backward_three_times": fp32,
            "flagship_step_ms_in_turns": step_ms}


def run_remat(tmp: str, kernels: dict) -> dict:
    """FLAGSHIP_STEPS steps of the fused flagship (bf16) at
    ``training.remat`` false, decoder and true, and false again
    (``run_flagship``: finite totals, the launches of a step unchanged):
    each mode's step ms and peak memory; the first-step totals within 1e-5
    relative of false's; every mode's totals, and the no-remat rerun's,
    bitwise false's at every step (the step replays: the upsample's
    backward gathers, with no atomics, and a recomputed block runs the
    same kernels on the same values).  The gradients of one fp32 step
    from the same state are held too (:func:`remat_gradients`)."""
    modes = {}
    for tag, mode in (("false", False), ("decoder", "decoder"),
                      ("true", True), ("false_rerun", False)):
        modes[tag] = run_flagship(tmp, kernels, fused_head=True,
                                  **{"training.remat": mode})
    base = modes["false"]["totals"]
    first = {m: _rel(r["totals"][0], base[0]) for m, r in modes.items()}
    if not all(v <= 1e-5 for v in first.values()):
        fail(f"remat: first-step totals rel {first}")
    parted = {m: [i + 1 for i, (a, b) in enumerate(zip(r["totals"], base))
                  if a != b] for m, r in modes.items()}
    if any(parted.values()):
        fail(f"remat: runs part from the no-remat run at steps {parted}")
    return {"phase": "remat", "steps": FLAGSHIP_STEPS,
            "first_total_rel": first, "steps_parted_vs_false": parted,
            "max_rel_vs_false": {m: max(_rel(a, b) for a, b in
                                        zip(r["totals"], base))
                                 for m, r in modes.items()},
            "step_rel_vs_false": {m: [_rel(a, b) for a, b in
                                      zip(r["totals"], base)]
                                  for m, r in modes.items()},
            "fp32_one_step": remat_gradients(tmp),
            "step_ms": {m: r["step_ms"] for m, r in modes.items()},
            "peak_mem_gib": {m: r["peak_mem_gib"] for m, r in modes.items()},
            "launches": {m: r["launches"] for m, r in modes.items()
                         if m != "false_rerun"},
            "first_total": {m: r["first_total"] for m, r in modes.items()}}


def e2e_train_split(tmp: str):
    """The bench's e2e train split (4 × 1456 images at 128 px)."""
    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data.dataset import load_split

    reset_config_cache()
    get_config(write_config(
        "configs/beta_vae_se.yaml", os.path.join(tmp, "host_feed", "batches"),
        "batches.yaml",
        **{"paths.processed_dir": os.path.join(tmp, "bench_e2e",
                                               "processed")}))
    try:
        return load_split("train")
    finally:
        reset_config_cache()


def host_fed_batches(ds, depth: int) -> dict:
    """Every batch of one epoch of ``ds`` through a host-fed split (``depth``
    batches an upload: gathered into a pinned buffer, one of two in turn,
    and copied to the static device buffer in one copy) must be bitwise
    the batch the resident split gathers."""
    import numpy as np
    import torch

    from betavae_tpu_torch.data.pipeline import (BatchPlan, DeviceData,
                                                 gather_batch)

    dev = torch.device("cuda")
    host = DeviceData.from_dataset(ds, dev, max_device_bytes=0, depth=depth)
    resident = DeviceData.from_dataset(ds, dev)
    plan = [idx for idx, _ in BatchPlan(len(ds), 32, shuffle=True,
                                        seed=0).batches(1)]
    source = host.source(32)

    def on_card(idx):
        return torch.from_numpy(np.asarray(idx, np.int64)).to(dev)

    t0 = time.perf_counter()
    # counted on the device, read once: each upload is queued behind the
    # gathers of the last one, and the host refills a pinned buffer once its
    # last copy has left it
    equal = torch.zeros((), dtype=torch.int64, device=dev)
    for at in range(0, len(plan), depth):
        part = plan[at:at + depth]
        for i, j in zip(host.stage(part), part):
            equal += (gather_batch(source, on_card(i))
                      == gather_batch(resident.images, on_card(j))).all()
    same = int(equal)
    seconds = time.perf_counter() - t0
    if same != len(plan) or not host.host_feed:
        fail(f"host_feed: {same} of {len(plan)} host-fed batches equal the "
             f"resident ones (depth {depth})")
    return {"batches": len(plan), "equal": same, "depth": depth,
            "seconds": seconds}


def run_host_feed(tmp: str, kernels: dict) -> dict:
    """``train()`` on the ``epochs`` config fed from the host
    (``training.max_device_dataset_mb: 0``: chunks of replays, the chunk's
    batches uploaded in one copy) against the same with the splits on the
    device, and the device-fed run again: every logged total of both
    bitwise the device-fed run's, and the same kernel launches, the
    capture's warm-up included (both capture a train step and a
    validation batch).
    Every batch of an epoch of the bench's e2e data through the host feed
    (16 and 1 batches an upload) is held bitwise to the resident gather
    (:func:`host_fed_batches`).  Then host feed, then device feed, one
    after the other (host speed drifts within a call): the bench's e2e
    img/s estimator over the bench's e2e data (4 × 1456 train images at
    128 px, 2 epochs, one span; host-fed chunks of 16 steps), and the fused
    flagship step (20 steps, then 8 profiled: step ms, device ms and busy
    share)."""
    import contextlib

    from betavae_tpu_torch import bench

    runs = {}
    for tag, mb in (("device", 4096), ("host", 0), ("device_rerun", 4096)):
        cfg = epochs_config(tmp, os.path.join(tmp, "host_feed", tag),
                            f"{tag}.yaml",
                            **{"training.epochs": EPOCHS_FIRST,
                               "training.max_device_dataset_mb": mb})
        zero_counts(kernels)
        out, lines = _train_lines(cfg)
        runs[tag] = {"totals": [m["train_total_loss"] if m["phase"] == "train"
                                else m["val_total_loss"] for m in lines
                                if m["phase"] in ("train", "val")],
                     "launches": read_counts(kernels)}
    dev = runs["device"]["totals"]
    rel = {tag: [_rel(a, b) for a, b in zip(r["totals"], dev)]
           for tag, r in runs.items() if tag != "device"}
    host = runs["host"]
    if not (len(host["totals"]) == len(dev) > 1
            and host["totals"] == dev == runs["device_rerun"]["totals"]
            and runs["device"]["launches"] == host["launches"]):
        fail(f"host_feed: totals {host['totals']} vs device {dev}, launches "
             f"{host['launches']} vs {runs['device']['launches']}")
    ds = e2e_train_split(tmp)
    batches = [host_fed_batches(ds, depth) for depth in (16, 1)]

    timing = {}
    for tag, host_feed in (("host", True), ("device", False)):
        zero_counts(kernels)
        with contextlib.redirect_stdout(sys.stderr):
            rate, breakdown = bench._e2e_images_per_sec(
                epochs=2, work_dir=os.path.join(tmp, "bench_e2e"),
                training={"max_device_dataset_mb": 0} if host_feed else None)
        e2e_launches = read_counts(kernels)
        if not (math.isfinite(rate) and e2e_launches["fused_reparam_kl"] > 0):
            fail(f"host_feed: {tag}-fed e2e rate {rate}, launches "
                 f"{e2e_launches}")
        overrides = ({"training.max_device_dataset_mb": 0} if host_feed
                     else {})
        step = run_flagship(tmp, kernels, fused_head=True, **overrides)
        prof = profile_flagship(tmp, step["step_ms"], fused_head=True,
                                **overrides)
        timing[tag] = {"e2e_images_per_sec": rate, "e2e_breakdown": breakdown,
                       "e2e_launches": e2e_launches,
                       "flagship_step_ms": step["step_ms"],
                       "flagship_launches": step["launches"],
                       "device_ms_per_step": prof["device_ms_per_step"],
                       "device_busy_share": prof["device_busy_share"],
                       "top_kernels": prof["top_kernels_ms_per_step"][:6]}
    return {"phase": "host_feed", "first_total": host["totals"][0],
            "line_rel_vs_device": rel, "launches": host["launches"],
            "fed_batches": batches, "timing": timing}


# the kernels of a fused train step in a profile_steps trace: name pattern,
# launches a step
PROFILED_KERNELS = {"fused_reparam_kl": (r"reparam_kl_kernel", 1),
                    "reparam_kl_backward": (r"reparam_kl_backward_kernel", 1),
                    "head_forward": (r"head_fwd_", 1),
                    "head_m": (r"head_m_", 1),
                    "upsample_forward": (r"upsample2x_fwd", FLAGSHIP_BLOCKS),
                    "upsample_backward": (r"upsample2x_bwd",
                                          FLAGSHIP_BLOCKS),
                    # a call's statistics pass, on either path
                    "gn_forward": (r"gn_stats_kernel", 2 * FLAGSHIP_BLOCKS),
                    "gn_backward": (r"gn_bwd_cluster_kernel|gn_bwd_sums_kernel",
                                    2 * FLAGSHIP_BLOCKS)}


def run_profile_steps(tmp: str, kernels: dict, profiled_fused: dict) -> dict:
    """``train()`` on the ``epochs`` config (2 epochs of 3 steps) with
    ``logging.profile_steps: 5``: one trace a window (steps 1-3 and 4-5,
    the window closing at an epoch's end), each read with the port's
    ``utils/trace.py``, whose rows must hold the reparam+KL forward and
    backward and the head forward and M kernels at 1 a step, the
    upsample kernels at one a decoder block a step, and the GN kernels at
    one an encoder or decoder block a step each way; its device kernels'
    total per step beside the ``profile`` phase's fused step; and the
    captured graphs instantiated anew for launch from the device after a
    window (``chunks.DeviceLaunched``: at least once), with their
    seconds."""
    import re

    from betavae_tpu_torch.utils.profiling import SPANS
    from betavae_tpu_torch.utils.trace import parse_trace

    cfg = epochs_config(tmp, os.path.join(tmp, "profile_steps"),
                        "profile.yaml", **{"training.epochs": EPOCHS_FIRST,
                                           "logging.profile_steps": 5})
    zero_counts(kernels)
    redone = (SPANS.counter("graphs.reinstantiations"),
              SPANS.host_total("graphs.reinstantiate"))
    out, _ = _train_lines(cfg)
    launches = read_counts(kernels)
    redone = (SPANS.counter("graphs.reinstantiations") - redone[0],
              SPANS.host_total("graphs.reinstantiate") - redone[1])
    if redone[0] < 1:
        fail("profile_steps: no graph was instantiated anew after a "
             "profiler window")
    names = [os.path.basename(p) for p in out["traces"]]
    if names != ["steps_1-3.trace.json", "steps_4-5.trace.json"] or \
            not all(os.path.exists(p) for p in out["traces"]):
        fail(f"profile_steps: traces {out['traces']}")
    windows = []
    for path, steps in zip(out["traces"], (3, 2)):
        summary = parse_trace(path, steps=steps)
        per_step = {}
        for name, (pattern, _) in PROFILED_KERNELS.items():
            rows = [r for r in summary.rows if re.search(pattern, r.name)]
            per_step[name] = sum(r.count for r in rows) / steps
        if any(per_step[name] != n
               for name, (_, n) in PROFILED_KERNELS.items()):
            fail(f"profile_steps: {os.path.basename(path)} launches per "
                 f"step {per_step}")
        windows.append({
            "trace": os.path.basename(path), "steps": steps,
            "kernels_per_step": per_step,
            "device_kernel_ms_per_step": summary.device_total_us / steps / 1e3,
            "kernel_rows": len(summary.rows),
            "top": [[n[:80], us / 1e3] for n, us, _ in
                    summary.per_step()[:6]],
            "bytes": os.path.getsize(path)})
    return {"phase": "profile_steps", "windows": windows,
            "launches": launches, "reinstantiations": redone[0],
            "reinstantiate_seconds": redone[1],
            "profile_phase_device_ms_per_step":
                profiled_fused["device_ms_per_step"]}


def _cli_run(main, argv: list) -> tuple:
    """``(seconds, what main returned)`` of one in-process CLI run, from a
    fresh config cache and logger (each CLI loads its own config)."""
    import torch

    from betavae_tpu_torch.config import reset_config_cache
    from betavae_tpu_torch.logging_utils import reset_logger

    reset_config_cache()
    reset_logger()
    t0 = time.perf_counter()
    result = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    reset_logger()
    return seconds, result


def _cli(main, argv: list) -> float:
    """Seconds of one in-process CLI run (:func:`_cli_run`)."""
    return _cli_run(main, argv)[0]


def _table(path: str) -> tuple:
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def run_eval_toolchain(tmp: str, kernels: dict) -> dict:
    """The evaluation and inference CLIs on the ``epochs`` run's ``best``
    checkpoint (the flagship at full width, fused head), over the bench's
    e2e demo data at the reference dataset's scale (4 × 1456 train and
    4 × 328 test images at 128 px), in process and in the order a
    researcher runs them: ``latent_analysis``, ``run_evaluation``,
    ``encode``, ``generate --seed 3`` (with ``inference.tumor_latent_index:
    0``, so the factor edit runs too).  Every artifact must be written,
    every table number finite, SSIM in [0, 1], the traversal dims those of
    the ranking; the reparam+KL forward must launch once per test batch,
    once for the recon/traversal panel and once for the prior draw, the
    head forward once per decode, all on the TMA path, the upsample
    forward once a decoder block a decode, and no other kernel.  Then the
    encoder's rate over the test split, the model loaded and warm, in
    ENCODE_PASSES timed passes, and the seconds of the t-SNE of
    ``evaluation.num_umap_samples`` (200) latents, which
    ``latent_scatter_tsne.png`` draws."""
    import importlib.util

    import numpy as np
    import torch

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data.dataset import build_datasets
    from betavae_tpu_torch.eval import run_evaluation
    from betavae_tpu_torch.eval.latent_viz import reduce_latents
    from betavae_tpu_torch.eval.recon_metrics import extract_latents
    from betavae_tpu_torch.eval.run_evaluation import load_model
    from betavae_tpu_torch.infer import encode, generate, latent_analysis
    from betavae_tpu_torch.logging_utils import reset_logger

    root = os.path.join(tmp, "eval")
    cfg_path = write_config(
        "configs/beta_vae_se.yaml", root, "eval.yaml",
        **{"training.fused_head": True, "inference.tumor_latent_index": 0,
           "paths.models_dir": os.path.join(tmp, "epochs", "outputs",
                                            "models"),
           "paths.processed_dir": os.path.join(tmp, "bench_e2e",
                                               "processed")})
    installed = {m: importlib.util.find_spec(m) is not None
                 for m in ("matplotlib", "pandas", "sklearn", "umap", "PIL")}
    argv = ["--config", cfg_path]
    zero_counts(kernels)
    with counted_forwards() as forwards:
        seconds = {"latent_analysis": _cli(latent_analysis.main, argv),
                   "run_evaluation": _cli(run_evaluation.main, argv),
                   "encode": _cli(encode.main, argv),
                   "generate": _cli(generate.main, argv + ["--seed", "3"])}
    launches = read_counts(kernels)
    paths = head_paths(kernels)

    out = os.path.join(root, "outputs")
    with open(os.path.join(out, "latent_ranking_summary.json")) as f:
        ranking = json.load(f)["traversal_order_auc"]
    dims = ranking[:7]                  # min(latent 64, traversal_steps 7)
    tumor = ("glioma", "meningioma", "pituitary")
    want_files = {
        "tables": {f"{t}.csv" for t in (
            "per_dimension_auc", "latent_usage", "latent_corr_pairs",
            "metrics_summary", "confusion_matrix",
            "traversal_probe_validation")}
        | {f"{s}_latents_{k}" for s in ("train", "test")
           for k in ("mu.npy", "logvar.npy", "embeddings.csv")},
        "figures": {"latent_logreg_weights.png", "recon_vs_traversal.png",
                    "latent_scatter.png", "latent_scatter_tsne.png",
                    "latent_per_dim_violin.png",
                    "samples.png", "edit_dim0.png", "interpolation.png"}
        | {f"traversal_dim{d}.png" for d in dims}
        | {f"traversal_tumor_{c}.png" for c in tumor}}
    for sub, names in want_files.items():
        have = set(os.listdir(os.path.join(out, sub)))
        if have != names:
            fail(f"eval_toolchain: {sub} holds {sorted(have)}, want "
                 f"{sorted(names)}")
    summary = {}
    for name, value in _table(os.path.join(out, "tables",
                                           "metrics_summary.csv"))[1]:
        try:
            summary[name] = float(value)
        except ValueError:
            summary[name] = value       # the lists: confusion matrix, ...
    for table in ("per_dimension_auc", "latent_usage", "latent_corr_pairs"):
        _, rows = _table(os.path.join(out, "tables", f"{table}.csv"))
        if not all(math.isfinite(float(v)) for row in rows for v in row):
            fail(f"eval_toolchain: {table}.csv holds a value that is not "
                 f"finite")
    numbers = {k: v for k, v in summary.items() if isinstance(v, float)}
    if not all_finite(numbers) or not 0.0 <= summary["ssim_mean"] <= 1.0:
        fail(f"eval_toolchain: metrics_summary {summary}")
    test_batches = -(-4 * REF_TEST_PER_CLASS // 32)
    decodes = (test_batches + 2        # recon metrics, panel, its endpoints
               + len(dims) + len(tumor)            # traversals
               + 3)                    # prior samples, edit, interpolation
    want = {name: 0 for name in kernels}
    # the GN kernels once a block of each encoder forward the CLIs ran
    want.update(fused_reparam_kl=test_batches + 1 + 1, head_forward=decodes,
                **block_launches(decodes, encodes=forwards["encode"]))
    if launches != want:
        fail(f"eval_toolchain: kernel launches {launches}, want {want}")

    # the encoder's rate over the test split, the model loaded and warm
    reset_config_cache()
    get_config(cfg_path)
    model = load_model("best", device="cuda")
    train_ds, test_ds = build_datasets()
    if (len(train_ds), len(test_ds)) != (4 * REF_TRAIN_PER_CLASS,
                                         4 * REF_TEST_PER_CLASS):
        fail(f"eval_toolchain: {len(train_ds)} train and {len(test_ds)} "
             f"test images, want the reference's scale")
    encode.encode_dataset(model, test_ds)
    rates = []
    for _ in range(ENCODE_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode.encode_dataset(model, test_ds)
        torch.cuda.synchronize()
        rates.append(len(test_ds) / (time.perf_counter() - t0))
    samples = int(get_config().evaluation.num_umap_samples)
    latents, _, _ = extract_latents(model, test_ds, limit=samples)
    t0 = time.perf_counter()
    emb = reduce_latents(latents, method="tsne", n_components=2)
    tsne_seconds = time.perf_counter() - t0
    if emb.shape != (samples, 2) or not np.isfinite(emb).all():
        fail(f"eval_toolchain: t-SNE of {latents.shape} gave {emb.shape}")
    reset_config_cache()
    reset_logger()
    return {"phase": "eval_toolchain", "seconds": seconds,
            "tsne": {"samples": samples, "seconds": tsne_seconds},
            "train_images": len(train_ds), "test_images": len(test_ds),
            "test_batches": test_batches,
            "traversal_dims": dims, "launches": launches,
            "head_launches_by_path": paths,
            "encode_images_per_sec": rates,
            "encode_images_per_sec_median": statistics.median(rates),
            "metrics": {k: numbers[k] for k in (
                "mse_mean", "psnr_mean", "ssim_mean", "probe_macro_f1",
                "probe_macro_auc", "silhouette")},
            "installed": installed}


DECODER_HEADERS = "#include <cstdio>\n#include <png.h>\nextern \"C\" {\n" \
    "#include <jpeglib.h>\n}\n"


def run_decoder(tmp: str) -> dict:
    """The packed-dataset decoder (``csrc/packer.cpp``) on the card's host:
    whether ``g++`` and the libpng and libjpeg headers are there (a
    preprocessor pass over both includes), which decoder ``load_split``
    took on the bench's e2e data (4 × 1456 train, 4 × 328 test PNGs at 128
    px), and the seconds to decode both splits natively and with PIL, the
    two byte-equal.  Fails if the toolchain is there and ``load_split``
    did not take the native decoder."""
    import shutil

    import numpy as np

    from betavae_tpu_torch import _build
    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data import native
    from betavae_tpu_torch.data.dataset import decode_pil, load_split
    from betavae_tpu_torch.logging_utils import reset_logger

    gxx = shutil.which("g++")
    headers = gxx is not None and subprocess.run(
        [gxx, "-fsyntax-only", "-x", "c++", "-"], input=DECODER_HEADERS,
        capture_output=True, text=True, timeout=60).returncode == 0
    toolchain = {"g++": gxx, "png_and_jpeg_headers": headers}
    t0 = time.perf_counter()
    built = native.available()
    build_seconds = time.perf_counter() - t0
    if gxx and headers and not built:
        fail(f"decoder: g++ and the headers are there, but csrc/packer.cpp "
             f"did not build: {_build.host_library_path('packer')}")
    cfg_path = write_config(
        "configs/beta_vae_se.yaml", os.path.join(tmp, "decoder"),
        "decoder.yaml", **{"paths.processed_dir": os.path.join(
            tmp, "bench_e2e", "processed"), "logging.log_to_file": False})
    reset_config_cache()
    get_config(cfg_path)
    seconds = {"load_split": 0.0, "native": 0.0, "pil": 0.0}
    decoders, n = set(), 0
    for split in ("train", "test"):
        t0 = time.perf_counter()
        ds = load_split(split)
        seconds["load_split"] += time.perf_counter() - t0
        decoders.add(ds.decoder)
        n += len(ds)
        if built:
            t0 = time.perf_counter()
            packed = native.pack_images(ds.paths, 128, 1)
            seconds["native"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        pil = decode_pil(ds.paths, 128, True)
        seconds["pil"] += time.perf_counter() - t0
        if built and not np.array_equal(packed, pil):
            fail(f"decoder: the native and PIL decodes of the {split} split "
                 f"differ on same-size gray PNGs")
    reset_logger()
    reset_config_cache()
    if n != 4 * (REF_TRAIN_PER_CLASS + REF_TEST_PER_CLASS):
        fail(f"decoder: {n} images, want the reference's scale")
    if built and decoders != {"native"}:
        fail(f"decoder: load_split took {decoders} with the native decoder "
             f"built")
    return {"phase": "decoder", "toolchain": toolchain, "built": built,
            "build_seconds": build_seconds,
            "load_split_decoder": sorted(decoders), "images": n,
            "seconds": seconds,
            "images_per_sec": {k: n / v for k, v in seconds.items() if v}}


# the raw trees of the scripts phase: 256 px, so that the resize to 128 px
# does real work (real MRI slices are larger), and SCRIPTS_UNIQUE images
# drawn a class, every other file a hard link to one of them
SCRIPTS_RAW_PX, SCRIPTS_UNIQUE = 256, 64


def raw_trees(root: str) -> dict:
    """Two raw trees of 4 × (1456 + 328) demo images at SCRIPTS_RAW_PX:
    ``classes`` (class folders) and ``presplit`` (``Training/`` with each
    class's first 1456 files and ``Testing/`` with the rest, the layout of
    the reference's dataset).  Every file is read, resized and written by
    the preprocessing, hard link or not."""
    import numpy as np
    from PIL import Image

    from betavae_tpu_torch.data.demo import CLASSES, pattern_for_class

    rng = np.random.default_rng(0)
    trees = {layout: os.path.join(root, f"raw_{layout}")
             for layout in ("classes", "presplit")}
    for cls in CLASSES:
        src = os.path.join(trees["classes"], cls)
        os.makedirs(src)
        for split in ("Training", "Testing"):
            os.makedirs(os.path.join(trees["presplit"], split, cls))
        for i in range(REF_TRAIN_PER_CLASS + REF_TEST_PER_CLASS):
            path = os.path.join(src, f"{cls}_{i}.png")
            if i < SCRIPTS_UNIQUE:
                arr = pattern_for_class(cls, rng, SCRIPTS_RAW_PX) * 255
                Image.fromarray(arr.astype(np.uint8)).save(path)
            else:
                os.link(os.path.join(src, f"{cls}_{i % SCRIPTS_UNIQUE}.png"),
                        path)
            split = "Training" if i < REF_TRAIN_PER_CLASS else "Testing"
            os.link(path, os.path.join(trees["presplit"], split, cls,
                                       f"{cls}_{i}.png"))
    return trees


def processed_counts(processed: str) -> dict:
    """``{split: {class: images}}`` of a processed tree; fails unless every
    image is 128 × 128 L."""
    from PIL import Image

    counts = {}
    for split in ("train", "test"):
        for cls in sorted(os.listdir(os.path.join(processed, split))):
            names = os.listdir(os.path.join(processed, split, cls))
            for name in names:
                with Image.open(os.path.join(processed, split, cls,
                                             name)) as im:
                    if im.size != (128, 128) or im.mode != "L":
                        fail(f"scripts: {split}/{cls}/{name} is {im.size} "
                             f"{im.mode}, want (128, 128) L")
            counts.setdefault(split, {})[cls] = len(names)
    return counts


def same_payload(a, b) -> bool:
    """Two checkpoint payloads hold the same keys, scalars and arrays
    (dtype, shape and bytes)."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_payload(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def run_scripts(tmp: str, kernels: dict) -> dict:
    """The CLIs of ``betavae_tpu_torch/scripts/`` in process, each timed,
    with the counts set to 0 before each and read after:

    - ``preprocess_data`` over the two raw trees of :func:`raw_trees`: the
      class folders split 80/20 by the seed (floor(0.8·1784) / the rest a
      class), the pre-split tree copied through (1456 / 328), every output
      128 × 128 L; then ``global_z`` on a copy of the first output
      (``norm_stats.json`` finite, std > 0); seconds and images/s a stage;
    - ``reshard_checkpoint``: the ``epochs`` run's ``best`` from 2 to 4
      shards, every array read back bitwise; asking the result for 2 must
      raise ``would not grow``;
    - ``preview_val_batch`` twice over the bench's e2e data (4 × 1456
      train, 4 × 328 test): the manifests byte-equal;
    - ``traverse_image`` on one test PNG with ``best`` (the flagship at full
      width, fused head) and the ``eval_toolchain`` phase's
      ``latent_usage.csv``: every figure of the JAX script for the same
      flags, the head forward once a decode, all TMA, no reparam+KL launch
      (the encoder gives μ);
    - ``diag_overfit`` on ``latest`` (the config's ``debug.train_samples`` /
      ``test_samples``): a finite JSON, the reparam+KL forward once a
      train batch, a val batch and the statistics batch, no backward;
    - ``plot_logs``, ``plot_phase_losses``, ``fix_steps`` (its count = the
      val lines) and ``make_recon_gif`` (one frame a panel) on the
      ``epochs`` run's log and panels;
    - ``parity_check --run-eval`` against a copy of the ``eval_toolchain``
      phase's tables taken before the rerun: exit 0 at the default
      tolerances, the evaluation's launches;
    - ``diag_overfit`` on ``configs/overfit_capacity.yaml`` over a 128 px
      tree (resized to its 256 px): a finite JSON, the upsample forward
      once a decoder block a batch, nothing else (z = μ, default head);
    - ``generate_umap_and_grid`` on ``best`` and the evaluation's
      traversal figures: a GIF of 60 frames and a grid row a figure.

    The host CLIs must launch no kernel."""
    import io
    import shutil

    import torch
    import yaml
    from PIL import Image

    from betavae_tpu_torch.io.checkpoint import (discover_shards,
                                                 load_sharded_checkpoint)
    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data import native
    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.io.checkpoint import save_sharded_checkpoint
    from betavae_tpu_torch.models.beta_vae import model_from_config
    from betavae_tpu_torch.scripts import (diag_overfit, fix_steps,
                                           generate_umap_and_grid,
                                           make_recon_gif, parity_check,
                                           plot_logs, plot_phase_losses,
                                           preprocess_data,
                                           preview_val_batch,
                                           reshard_checkpoint, traverse_image)

    root = os.path.join(tmp, "scripts")
    models = os.path.join(tmp, "epochs", "outputs", "models")
    e2e = os.path.join(tmp, "bench_e2e", "processed")
    seconds, launches = {}, {}
    total = {name: 0 for name in kernels}
    none = {name: 0 for name in kernels}

    encodes = {}

    def run(name, main, argv):
        zero_counts(kernels)
        with counted_forwards() as forwards:
            seconds[name], result = _cli_run(main, argv)
        launches[name] = read_counts(kernels)
        encodes[name] = forwards["encode"]
        for k, v in launches[name].items():
            total[k] += v
        return result

    def config(name, **overrides):
        return write_config("configs/beta_vae_se.yaml", root, name,
                            **overrides)

    def host_only(*names):
        bad = {n: launches[n] for n in names if launches[n] != none}
        if bad:
            fail(f"scripts: host CLIs launched kernels: {bad}")

    # preprocess_data: class folders, pre-split, then global_z on a copy
    t0 = time.perf_counter()
    trees = raw_trees(root)
    raw_seconds = time.perf_counter() - t0
    per_class = REF_TRAIN_PER_CLASS + REF_TEST_PER_CLASS
    images = 4 * per_class
    stages, counts = {}, {}
    processed = {layout: os.path.join(root, f"processed_{layout}")
                 for layout in ("classes", "presplit", "global_z")}
    for layout, raw in trees.items():
        cfg = config(f"pre_{layout}.yaml", **{
            "paths.raw_dir": raw, "paths.processed_dir": processed[layout]})
        stages[layout] = run(f"preprocess_data_{layout}",
                             preprocess_data.main, ["--config", cfg])
        counts[layout] = processed_counts(processed[layout])
    shutil.copytree(processed["classes"], processed["global_z"])
    cfg = config("pre_global_z.yaml", **{
        "paths.raw_dir": trees["classes"],
        "paths.processed_dir": processed["global_z"]})
    with contextlib.chdir(root):        # norm_stats.json is cwd-relative
        stages["global_z"] = run("preprocess_data_global_z",
                                 preprocess_data.main,
                                 ["--config", cfg, "--normalization",
                                  "global_z"])
    counts["global_z"] = processed_counts(processed["global_z"])
    with open(os.path.join(root, "data", "intermediate",
                           "norm_stats.json")) as f:
        norm_stats = json.load(f)
    split = {"train": math.floor(0.8 * per_class)}
    split["test"] = per_class - split["train"]
    classes = ("glioma", "meningioma", "notumor", "pituitary")
    want = {layout: {s: {c: n for c in classes} for s, n in split_.items()}
            for layout, split_ in (
                ("classes", split), ("global_z", split),
                ("presplit", {"train": REF_TRAIN_PER_CLASS,
                              "test": REF_TEST_PER_CLASS}))}
    if counts != want or not (all_finite(norm_stats)
                              and norm_stats["std"] > 0):
        fail(f"scripts: processed counts {counts}, want {want}; "
             f"norm_stats {norm_stats}")

    # reshard_checkpoint: best 2 → 4 shards, then 4 → 2 refused
    cfg = config("reshard.yaml", **{"paths.models_dir": models})
    out = os.path.join(root, "resharded", "beta_vae_se_best.pt")
    written = run("reshard_checkpoint", reshard_checkpoint.main,
                  ["--config", cfg, "--checkpoint", "best",
                   "--num-shards", "4", "--output", out])
    src = os.path.join(models, "beta_vae_se_best.pt")
    bitwise = same_payload(load_sharded_checkpoint(src),
                           load_sharded_checkpoint(out))
    try:
        _cli_run(reshard_checkpoint.main,
                 ["--config", cfg, "--checkpoint", out, "--num-shards", "2"])
        refused = None
    except ValueError as err:
        refused = str(err)
    if not (bitwise and len(discover_shards(src)) == 2
            and written == discover_shards(out) and len(written) == 4
            and refused and "would not grow" in refused):
        fail(f"scripts: reshard wrote {written}, bitwise {bitwise}, "
             f"shrink refused with {refused!r}")

    # preview_val_batch, twice
    manifests = []
    for i in (1, 2):
        cfg = config(f"preview{i}.yaml", **{
            "paths.processed_dir": e2e,
            "paths.figures_dir": os.path.join(root, f"preview{i}")})
        _, manifest = run(f"preview_val_batch_{i}", preview_val_batch.main,
                          ["--config", cfg])
        with open(manifest, "rb") as f:
            manifests.append(f.read())
    if manifests[0] != manifests[1] or manifests[0].count(b"\n") != 32:
        fail("scripts: preview_val_batch manifests differ between two runs")

    # traverse_image on one test image
    figures = os.path.join(root, "traverse")
    cfg = config("traverse.yaml", **{
        "training.fused_head": True, "paths.models_dir": models,
        "paths.processed_dir": e2e, "paths.figures_dir": figures,
        "paths.tables_dir": os.path.join(tmp, "eval", "outputs", "tables")})
    glioma = os.path.join(e2e, "test", "glioma")
    image = os.path.join(glioma, sorted(os.listdir(glioma))[0])
    run("traverse_image", traverse_image.main,
        ["--config", cfg, "--image", image])
    head_by_path = head_paths(kernels)
    want_figures = ({f"traversal_dim{d}.png" for d in range(4)}
                    | {f"traversal_tumor_{c}.png" for c in classes
                       if c != "notumor"})
    want = dict(none, head_forward=len(want_figures),
                **block_launches(len(want_figures),
                                 encodes=encodes["traverse_image"]))
    if set(os.listdir(figures)) != want_figures or \
            launches["traverse_image"] != want:
        fail(f"scripts: traverse_image wrote {sorted(os.listdir(figures))}, "
             f"launched {launches['traverse_image']}, want {want}")

    # diag_overfit on latest
    cfg = config("diag.yaml", **{"training.fused_head": True,
                                 "paths.models_dir": models,
                                 "paths.processed_dir": e2e})
    stats = run("diag_overfit", diag_overfit.main, ["--config", cfg])
    with open("configs/beta_vae_se.yaml") as f:
        flagship = yaml.safe_load(f)
    bs = flagship["training"]["batch_size"]
    batches = (-(-flagship["debug"]["train_samples"] // bs)
               + -(-flagship["debug"]["test_samples"] // bs) + 1)
    want = dict(none, fused_reparam_kl=batches, head_forward=batches,
                **block_launches(batches, encodes=encodes["diag_overfit"]))
    if not all_finite(stats) or launches["diag_overfit"] != want:
        fail(f"scripts: diag_overfit {stats}, launched "
             f"{launches['diag_overfit']}, want {want}")

    # diag_overfit on configs/overfit_capacity.yaml (binary, base 32, SE
    # 16, deterministic_overfit, batch 8, debug limits 8 and 8) over a tree
    # of 128 px images, each resized to the config's 256 px by load_split,
    # on a checkpoint of seeded weights: z = μ, so no reparam+KL launch,
    # and the default head
    over_root = os.path.join(root, "overfit")
    generate_demo_data(os.path.join(over_root, "processed"),
                       train_per_class=4, test_per_class=4, size=128)
    over_cfg = write_config("configs/overfit_capacity.yaml", over_root,
                            "overfit.yaml")
    reset_config_cache()
    over = get_config(over_cfg)
    torch.manual_seed(0)
    save_sharded_checkpoint(
        os.path.join(over.paths.models_dir, f"{over.paths.run_id}_latest.pt"),
        {"epoch": 1, "total_steps": 1, "model_state": {
            k: v.numpy() for k, v in model_from_config(
                over, device="cpu").state_dict().items()}})
    reset_config_cache()
    over_stats = run("diag_overfit_capacity", diag_overfit.main,
                     ["--config", over_cfg])
    want = dict(none, **block_launches(
        3, encodes=encodes["diag_overfit_capacity"]))
    if not all_finite(over_stats) or \
            launches["diag_overfit_capacity"] != want:
        fail(f"scripts: diag_overfit on overfit_capacity.yaml {over_stats}, "
             f"launched {launches['diag_overfit_capacity']}, want {want}")

    # generate_umap_and_grid on best, over the evaluation's traversal
    # figures: a GIF of 60 frames, a grid row a figure, and no kernel but
    # the encoder's (no decode, so no head or upsample launch)
    figures = os.path.join(root, "umap")
    os.makedirs(figures)
    eval_figures = os.path.join(tmp, "eval", "outputs", "figures")
    traversals = sorted(n for n in os.listdir(eval_figures)
                        if n.startswith("traversal_") and n.endswith(".png"))
    for name in traversals:
        shutil.copy(os.path.join(eval_figures, name), figures)
    cfg = config("umap.yaml", **{"training.fused_head": True,
                                 "paths.models_dir": models,
                                 "paths.processed_dir": e2e,
                                 "paths.figures_dir": figures})
    umap_out = run("generate_umap_and_grid", generate_umap_and_grid.main,
                   ["--config", cfg])
    with Image.open(umap_out["gif"]) as im:
        umap_gif = {"frames": im.n_frames, "size": list(im.size)}
    with Image.open(umap_out["grid"]) as im:
        grid_size = list(im.size)
    cell = generate_umap_and_grid.CELL
    want_grid = [180 + 7 * cell, 36 + 24 + len(traversals) * cell]
    # the GIF's encode: the GN kernels once an encoder block a batch
    want = dict(none, **block_launches(
        0, encodes=encodes["generate_umap_and_grid"]))
    if (umap_gif != {"frames": 60, "size": [600, 500]}
            or grid_size != want_grid or not traversals
            or launches["generate_umap_and_grid"] != want):
        fail(f"scripts: generate_umap_and_grid GIF {umap_gif}, grid "
             f"{grid_size} (want {want_grid} for {len(traversals)} "
             f"figures), launched {launches['generate_umap_and_grid']}")

    # the log tools on the epochs run's log and panels
    epochs_out = os.path.join(tmp, "epochs", "outputs")
    figures = os.path.join(root, "logs")
    os.makedirs(figures)
    panels = [n for n in os.listdir(os.path.join(epochs_out, "figures"))
              if n.startswith("recon_epoch") and n.endswith(".png")]
    for name in panels:
        shutil.copy(os.path.join(epochs_out, "figures", name), figures)
    cfg = config("logs.yaml", **{"paths.outputs_dir": epochs_out,
                                 "paths.figures_dir": figures})
    log = os.path.join(epochs_out, "logs", "beta_vae_se.log")
    plots = {"plot_logs": run("plot_logs", plot_logs.main, ["--config", cfg]),
             "plot_phase_losses": run("plot_phase_losses",
                                      plot_phase_losses.main,
                                      ["--config", cfg])}
    sizes = {}
    for name, path in plots.items():
        with Image.open(path) as im:
            sizes[name] = im.size
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        code = run("fix_steps", fix_steps.main,
                   [log, os.path.join(root, "fixed.log")])
    rewritten = int(printed.getvalue().split()[1])
    val_lines = sum(m["phase"] == "val" for m in metrics_lines(log))
    gif = run("make_recon_gif", make_recon_gif.main, ["--config", cfg])
    with Image.open(gif) as im:
        frames = im.n_frames
    want_frames = sum("_diff" not in n for n in panels)
    if not (code == 0 and rewritten == val_lines > 0
            and sizes == {"plot_logs": (1200, 1800),
                          "plot_phase_losses": (1500, 600)}
            and frames == want_frames > 0):
        fail(f"scripts: fix_steps exit {code} rewrote {rewritten} of "
             f"{val_lines} val lines; figures {sizes}; GIF {frames} frames "
             f"for {want_frames} panels")

    # parity_check --run-eval against the eval_toolchain phase's tables
    reference = os.path.join(root, "reference_tables")
    shutil.copytree(os.path.join(tmp, "eval", "outputs", "tables"), reference)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        code = run("parity_check", parity_check.main,
                   ["--reference-tables", reference, "--config",
                    os.path.join(tmp, "eval", "eval.yaml"), "--run-eval"])
    report = printed.getvalue().splitlines()
    parity = json.loads(report[-1].split("PARITY ", 1)[1])
    test_batches = -(-4 * REF_TEST_PER_CLASS // bs)
    want = dict(none, fused_reparam_kl=test_batches + 1,
                head_forward=test_batches + 2 + 7 + 3,
                **block_launches(test_batches + 2 + 7 + 3,
                                 encodes=encodes["parity_check"]))
    if code != 0 or launches["parity_check"] != want:
        fail(f"scripts: parity_check exit {code} ({report[-1]}), launched "
             f"{launches['parity_check']}, want {want}; rows not OK: "
             f"{[ln for ln in report if ln.endswith((' FAIL', ' MISSING'))]}")
    host_only(*(n for n in launches
                if n.startswith(("preprocess", "reshard", "preview"))),
              "plot_logs", "plot_phase_losses", "fix_steps", "make_recon_gif")

    return {"phase": "scripts", "seconds": seconds,
            "phase_seconds": sum(seconds.values()) + raw_seconds,
            "raw_tree_seconds": raw_seconds,
            "preprocess": {
                "images": images, "raw_px": SCRIPTS_RAW_PX,
                "stage_seconds": stages,
                "images_per_sec": {layout: {k: images / v
                                            for k, v in st.items()}
                                   for layout, st in stages.items()},
                "counts": counts, "norm_stats": norm_stats},
            "reshard": {"shards": len(written), "bitwise": bitwise,
                        "shrink_refused": refused},
            "traverse_figures": sorted(want_figures),
            "diag_overfit": stats,
            "diag_overfit_capacity": {
                "stats": over_stats, "image_size": int(over.data.image_size),
                "stored_px": 128,
                "decoder": "native" if native.available() else "PIL"},
            "generate_umap_and_grid": {"gif": umap_gif,
                                       "grid_size": grid_size,
                                       "grid_rows": len(traversals)},
            "fix_steps_rewritten": rewritten,
            "gif_frames": frames, "parity": parity,
            "launches": total, "launches_by_cli": launches,
            "head_launches_by_path": head_by_path}


def run_eval_vs_cpu(tmp: str, kernels: dict) -> dict:
    """One small fp32 checkpoint (seeded weights, the fused head) on the
    card and on the CPU: ``gather_reconstruction_metrics`` with sampling
    on (the card's reparam+KL kernel and the CPU's plain Philox draw the
    same ε) and ``extract_latents`` within 1e-3 relative, the logistic
    probe's metrics within 0.05; TF32 off."""
    import torch

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data.dataset import build_datasets
    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.eval.recon_metrics import (
        extract_latents, gather_reconstruction_metrics, logistic_probe)
    from betavae_tpu_torch.eval.run_evaluation import load_model
    from betavae_tpu_torch.io.checkpoint import save_sharded_checkpoint
    from betavae_tpu_torch.models.beta_vae import model_from_config

    root = os.path.join(tmp, "eval_cpu")
    cfg_path = write_config(
        "configs/beta_vae_se.yaml", root, "small.yaml",
        **{"data.image_size": 32, "model.base_channels": 8,
           "model.latent_dim": 8, "model.num_blocks": 2,
           "training.batch_size": 8, "training.mixed_precision": False,
           "training.fused_head": True, "logging.log_to_file": False})
    generate_demo_data(os.path.join(root, "processed"), train_per_class=2,
                       test_per_class=10, size=32)
    reset_config_cache()
    cfg = get_config(cfg_path)
    state = model_from_config(cfg, device="cpu").state_dict()
    save_sharded_checkpoint(
        os.path.join(cfg.paths.models_dir, f"{cfg.paths.run_id}_best.pt"),
        {"epoch": 0, "total_steps": 0,
         "model_state": {k: v.numpy() for k, v in state.items()}})
    _, test_ds = build_datasets()
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for device in ("cuda", "cpu"):
            zero_counts(kernels)
            model = load_model("best", device=device)
            recon = gather_reconstruction_metrics(model, test_ds)
            latents, labels, _ = extract_latents(model, test_ds)
            probe = logistic_probe(latents, labels, binary=False)
            out[device] = {"recon": recon, "latents": latents,
                           "probe": probe, "launches": read_counts(kernels)}
    finally:
        torch.backends.cudnn.allow_tf32 = True
        reset_config_cache()
    gpu, cpu = out["cuda"], out["cpu"]
    recon_rel = max(abs(gpu["recon"][k] - v) / max(abs(v), 1e-12)
                    for k, v in cpu["recon"].items())
    latent_rel = float(abs(gpu["latents"] - cpu["latents"]).max()
                       / abs(cpu["latents"]).max())
    probe_abs = max(abs(gpu["probe"][k] - cpu["probe"][k])
                    for k in ("probe_macro_f1", "probe_macro_auc"))
    batches = -(-len(test_ds) // 8)
    # the reconstruction metrics' forwards, then extract_latents' encodes
    want = {"fused_reparam_kl": batches, "head_forward": batches,
            **block_launches(batches, blocks=SMALL_BLOCKS,
                             encodes=2 * batches)}
    got = {k: gpu["launches"][k] for k in want}
    if not (recon_rel <= 1e-3 and latent_rel <= 1e-3 and probe_abs <= 0.05
            and got == want and not any(cpu["launches"].values())):
        fail(f"eval_vs_cpu: recon max rel {recon_rel}, latents max rel "
             f"{latent_rel}, probe max abs {probe_abs}, card launches "
             f"{gpu['launches']} (want {want}), CPU launches "
             f"{cpu['launches']}")
    return {"phase": "eval_vs_cpu", "test_images": len(test_ds),
            "recon_max_rel": recon_rel, "latents_max_rel": latent_rel,
            "probe_max_abs": probe_abs, "gpu_launches": got,
            "gpu_ssim_mean": gpu["recon"]["ssim_mean"],
            "cpu_ssim_mean": cpu["recon"]["ssim_mean"]}


def run_debug_config(tmp: str, kernels: dict) -> dict:
    """``train()`` on ``configs/beta_vae_se_debug.yaml`` as it is (its own
    ``debug:`` limits and 2 epochs, LPIPS on with random-init features
    allowed, FFL, l1, fp32), over seeded demo data, with the log written
    to a file to read back: the CONFIG line must name the LPIPS weight
    source, every train and val line must carry a finite LPIPS term above
    0, and the reparam+KL kernels must launch as the run's steps and
    validation batches say."""
    import yaml

    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train

    src = "configs/beta_vae_se_debug.yaml"
    root = os.path.join(tmp, "debug")
    cfg_path = write_config(src, root, "debug.yaml",
                            **{"logging.log_to_file": True})
    with open(src) as f:
        raw = yaml.safe_load(f)
    debug, batch = raw["debug"], int(raw["training"]["batch_size"])
    generate_demo_data(os.path.join(root, "processed"), train_per_class=6,
                       test_per_class=3, size=128)
    zero_counts(kernels)
    t0 = time.perf_counter()
    out = train(cfg_path)
    reset_logger()
    seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    log = os.path.join(root, "outputs", "logs", "beta_vae_se_debug.log")
    with open(log) as f:
        config_line = json.loads(next(
            ln for ln in f if "| CONFIG " in ln).split("| CONFIG ", 1)[1])
    lines = metrics_lines(log)
    lpips = {phase: [m[f"{phase}_recon_lpips"] for m in lines
                     if m["phase"] == phase] for phase in ("train", "val")}
    if not all(v and all(math.isfinite(x) and x > 0 for x in v)
               for v in lpips.values()):
        fail(f"debug config: recon_lpips not finite and > 0: {lpips}")
    source = config_line.get("lpips_weights")
    if source is None:
        fail("debug config: the CONFIG line names no lpips_weights source")
    steps = out["total_steps"]
    val_batches = min(int(debug["max_val_batches"]),
                      -(-int(debug["test_samples"]) // batch))
    want = {"fused_reparam_kl": steps + out["epoch"] * val_batches,
            "reparam_kl_backward": steps,
            # the train steps, validation batches and an epoch's panel
            **block_launches(steps + out["epoch"] * (val_batches + 1),
                                steps)}
    # one captured train step and validation batch
    want = plus(want, capture_warmup(kernels, False, train=1, val=1))
    got = {name: launches[name] for name in want}
    if (out["epoch"], steps) != (int(debug["epochs"]), int(debug["epochs"])
                                 * int(debug["max_train_batches"])) \
            or got != want:
        fail(f"debug config: {out['epoch']} epochs, {steps} steps, reparam+KL "
             f"launches {got}, want {want}")
    return {"phase": "debug_config", "config": src, "epochs": out["epoch"],
            "train_steps": steps, "lpips_weights": source,
            "train_recon_lpips": lpips["train"],
            "val_recon_lpips": lpips["val"],
            "val_total_loss": [m["val_total_loss"] for m in lines
                               if m["phase"] == "val"],
            "launches": launches, "seconds": seconds}


NOTEBOOK = "notebooks/train_and_eval_torch.ipynb"
NOTEBOOK_CONFIG = "configs/demo_notebook.yaml"
# its code cells: the device parameter, set-up, demo data, train(),
# evaluate_full, the reconstruction figure, the latent figures
NOTEBOOK_CELLS = ("parameter", "setup", "data", "train", "evaluate_full",
                  "reconstructions", "latent_figures")


def _finite_or_str(value):
    """A report value for a JSON line: NaN and infinities as strings."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def run_demo_notebook(tmp: str, kernels: dict) -> dict:
    """The port's demo notebook, every code cell in order in one namespace
    on the card (its own ``DEVICE = "cuda"``), in a copy of the notebook
    and ``configs/demo_notebook.yaml`` under ``tmp``, with TF32 off, as
    ``eval_vs_cpu`` runs, so that the card's evaluation can be held to the
    CPU's.  Each kernel must launch as the cells say: the reparam+KL
    forward each train step and validation batch, each test batch of
    ``evaluate_full`` and its panel; its backward each train step; the
    upsample DEMO_BLOCKS times a decode (train steps, validation batches,
    an epoch's panel; the test batches, the panel and its two traversal
    endpoints; the figure's one) and a backward, all on the vector path;
    the GN kernels DEMO_BLOCKS times an encode or decode and twice that a
    backward (``train()``'s encodes are its decodes; the other cells'
    are counted); the head kernels never.  Then the same ``best`` checkpoint is
    evaluated by ``evaluate_full`` on the CPU (into another output tree):
    the reconstruction metrics and latents within 1e-3 relative, every
    other number of the report (probe, traversal, silhouette) within 0.05,
    NaN equal to NaN.  Reports each cell's seconds, the run's peak memory
    and the files written."""
    import shutil

    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data.dataset import build_datasets
    from betavae_tpu_torch.eval.recon_metrics import (evaluate_full,
                                                      extract_latents)
    from betavae_tpu_torch.eval.run_evaluation import load_model
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.utils.notebook import code_cells, run_notebook

    root = os.path.join(tmp, "notebook")
    for src in (NOTEBOOK, NOTEBOOK_CONFIG):
        os.makedirs(os.path.join(root, os.path.dirname(src)), exist_ok=True)
        shutil.copy(src, os.path.join(root, src))
    if len(code_cells(NOTEBOOK)) != len(NOTEBOOK_CELLS):
        fail(f"notebook: {len(code_cells(NOTEBOOK))} code cells, want "
             f"{len(NOTEBOOK_CELLS)} ({NOTEBOOK_CELLS})")
    with open(NOTEBOOK_CONFIG) as f:
        raw = yaml.safe_load(f)
    debug, batch = raw["debug"], int(raw["training"]["batch_size"])

    after = []                  # each kernel's launches after each cell
    encodes = []                # the model's encode calls after each cell

    def after_cell(i):
        after.append(dict(read_counts(kernels)))
        encodes.append(forwards["encode"])

    reset_config_cache()
    reset_logger()
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    try:
        with counted_forwards() as forwards:
            run = run_notebook(os.path.join(root, NOTEBOOK),
                               after_cell=after_cell)
        launches = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        torch.backends.cudnn.allow_tf32 = True
        reset_logger()
        reset_config_cache()
    ns = run["namespace"]
    steps, epochs = ns["state"]["total_steps"], ns["state"]["epoch"]
    val_batches = min(int(debug["max_val_batches"]),
                      -(-int(debug["test_samples"]) // batch))
    test_batches = -(-len(ns["test_ds"]) // batch)

    def cell(fwd=0, bwd=0, decodes=0, encodes=None):
        return {**{name: 0 for name in kernels},
                "fused_reparam_kl": fwd, "reparam_kl_backward": bwd,
                **block_launches(decodes, bwd, blocks=DEMO_BLOCKS,
                                 encodes=encodes)}

    cell_encodes = {name: n - m for name, n, m in
                    zip(NOTEBOOK_CELLS, encodes, [0] + encodes)}
    # train() captures one train step and one validation batch
    want = {"train": plus(cell(steps + epochs * val_batches, steps,
                               steps + epochs * (val_batches + 1)),
                          capture_warmup(kernels, False, train=1, val=1,
                                         blocks=DEMO_BLOCKS)),
            "evaluate_full": cell(test_batches + 1, 0, test_batches + 2,
                                  cell_encodes["evaluate_full"]),
            "reconstructions": cell(0, 0, 1,
                                    cell_encodes["reconstructions"])}
    got, prev = {}, {name: 0 for name in kernels}
    for name, counts in zip(NOTEBOOK_CELLS, after):
        got[name] = {k: counts[k] - prev[k] for k in kernels}
        prev = counts
    # every other cell: the GN kernels of the encodes it runs, if any
    for name in NOTEBOOK_CELLS:
        want.setdefault(name, cell(encodes=cell_encodes[name]))
    bad = {name: (got[name], want[name])
           for name in NOTEBOOK_CELLS if got[name] != want[name]}
    if (epochs, steps) != (int(debug["epochs"]), int(debug["epochs"])
                           * int(debug["max_train_batches"])) or bad:
        fail(f"notebook: {epochs} epochs, {steps} steps; launches by cell "
             f"(got, want) where they differ: {bad}")
    figure = run["values"][NOTEBOOK_CELLS.index("reconstructions")]
    side = 2 * int(raw["data"]["image_size"])
    if not (isinstance(figure, Image.Image)
            and figure.size == (8 * side, 2 * side)
            and np.isfinite(ns["recon"]).all()):
        fail(f"notebook: the reconstruction cell gave {figure!r}")

    # the same best checkpoint evaluated on the CPU, into another tree
    card_report = ns["metrics"]
    for key in ("processed_dir", "models_dir"):
        raw["paths"][key] = os.path.join(root, raw["paths"][key])
    for key in ("outputs_dir", "figures_dir", "tables_dir"):
        raw["paths"][key] = os.path.join(root, "cpu_eval",
                                         raw["paths"][key])
    cpu_cfg = os.path.join(root, "cpu_eval.yaml")
    with open(cpu_cfg, "w") as f:
        yaml.safe_dump(raw, f)
    try:
        get_config(cpu_cfg)
        train_ds, test_ds = build_datasets()
        cpu_model = load_model("best", device="cpu")
        cpu_report = evaluate_full(cpu_model, train_ds, test_ds)
        latents = {"cuda": extract_latents(ns["model"], test_ds)[0],
                   "cpu": extract_latents(cpu_model, test_ds)[0]}
    finally:
        reset_logger()
        reset_config_cache()
    if set(card_report) != set(cpu_report):
        fail(f"notebook: the card's report has keys {sorted(card_report)}, "
             f"the CPU's {sorted(cpu_report)}")
    recon_rel, other_abs, mismatched = 0.0, 0.0, []
    for key, want_val in cpu_report.items():
        val = card_report[key]
        if isinstance(want_val, list):
            continue
        if math.isnan(float(want_val)) or math.isnan(float(val)):
            if not (math.isnan(float(want_val)) and math.isnan(float(val))):
                mismatched.append(key)
        elif key.startswith(("mse", "psnr", "ssim", "per_class/")):
            recon_rel = max(recon_rel, abs(val - want_val)
                            / max(abs(want_val), 1e-12))
        else:
            other_abs = max(other_abs, abs(val - want_val))
    latent_rel = float(np.abs(latents["cuda"] - latents["cpu"]).max()
                       / np.abs(latents["cpu"]).max())
    if not (not mismatched and recon_rel <= 1e-3 and latent_rel <= 1e-3
            and other_abs <= 0.05):
        fail(f"notebook: card vs CPU evaluation: NaN on one side "
             f"{mismatched}, recon max rel {recon_rel}, latents max rel "
             f"{latent_rel}, probe and others max abs {other_abs}")
    written = sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, files in os.walk(os.path.join(root, "outputs_demo"))
        for f in files)
    return {"phase": "notebook", "notebook": NOTEBOOK,
            "config": NOTEBOOK_CONFIG, "epochs": epochs, "train_steps": steps,
            "cell_seconds": dict(zip(NOTEBOOK_CELLS, run["seconds"])),
            "seconds": sum(run["seconds"]), "peak_mem_gib": peak,
            "launches": launches, "launches_by_cell": got,
            "recon_max_rel": recon_rel, "latents_max_rel": latent_rel,
            "probe_max_abs": other_abs,
            "reports": {side: {k: _finite_or_str(report[k])
                               for k in ("mse_mean", "ssim_mean",
                                         "probe_macro_f1", "probe_macro_auc",
                                         "silhouette")}
                        for side, report in (("card", card_report),
                                             ("cpu", cpu_report))},
            "files_written": written}


DP_STEPS, DP_GLOO_STEPS = 20, 10


def dp_fp32_case(tmp: str):
    """One fp32 step of the fused flagship over 32 seeded 128 px images,
    whose gradients :func:`fp32_grads` keeps."""
    import numpy as np

    from betavae_tpu_torch.parallel.dryrun import Case

    rng = np.random.default_rng(4)
    return Case(images=rng.integers(0, 256, (64, 128, 128, 1), np.uint8),
                batches=[(np.arange(32, dtype=np.int32),
                          np.ones(32, np.float32))],
                scheds=[{"beta": 1.0, "capacity": 30.0,
                         "capacity_weight": 1.0, "free_bits": 0.0,
                         "lr": 5e-4}],
                config=flagship_config(tmp, True, **{
                    "training.mixed_precision": False}),
                device="cuda")


def fp32_grads(mesh, case) -> dict:
    """The gradients this rank of ``mesh`` (one process when None) holds
    after ``case``'s one step's sync, before the clip, by parameter name;
    TF32 off for the step and put back after."""
    import torch

    from betavae_tpu_torch.parallel.dryrun import case_step, take_steps

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model, optimizer, step = case_step(mesh, case)
        names = {p: n for n, p in model.named_parameters()}
        grads = {}
        update = optimizer.step

        def update_keeping_grads(lr: float) -> None:
            grads.update({names[p]: p.grad.detach().float().cpu().numpy()
                          for p in names if p.grad is not None})
            update(lr)

        optimizer.step = update_keeping_grads
        take_steps(mesh, case, step)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return grads


def dp_shared_card_rank(mesh, cfg: str, case, dry_case) -> tuple:
    """Part (b)'s work on one rank (a spawned process, which imports this
    script by name): DP_GLOO_STEPS steps of ``train_steps``, the fp32
    step's gradients and the dry run's step."""
    from betavae_tpu_torch.parallel.dryrun import run_steps
    from betavae_tpu_torch.parallel.launch import train_rank

    return (train_rank(mesh, cfg, "none", "cuda", DP_GLOO_STEPS),
            fp32_grads(mesh, case), run_steps(mesh, dry_case))


def grad_rel(got: dict, want: dict) -> float:
    """‖g − g₀‖ / ‖g₀‖ over every parameter."""
    import numpy as np

    keys = sorted(want)
    a = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    b = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def flagship_parameters() -> list:
    """The flagship's parameters (on the CPU)."""
    from betavae_tpu_torch.bench import flagship_model

    return list(flagship_model(device="cpu").parameters())


def config_notes(cfg: str) -> list:
    """The ``step_dispatch`` notes of the CONFIG lines in ``cfg``'s log
    (``logging.log_to_file``), one a trainer run."""
    import yaml

    with open(cfg) as f:
        raw = yaml.safe_load(f)
    log = os.path.join(raw["paths"]["outputs_dir"], "logs",
                       f"{raw['paths']['run_id']}.log")
    with open(log) as f:
        return [json.loads(line.split("| CONFIG ", 1)[1]).get("step_dispatch")
                for line in f if "| CONFIG " in line]


def dp_in_turns(tmp: str, kernels: dict, mesh) -> dict:
    """One epoch of DP_STEPS flagship steps (fused head) through
    ``train_steps`` at K = DP_STEPS (one chunk of replays), the single
    process and the one-rank NCCL mesh in turns (single, mesh, mesh,
    single): every total of each run bitwise the first's, each run's
    dispatch a CUDA graph with no CONFIG note, its launches DP_STEPS steps'
    and the capture's warm-up; step ms, capture seconds, a replay's
    launches."""
    from unittest import mock

    import torch

    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    runs = []
    want = plus(launches_per_step(kernels, True, DP_STEPS),
                capture_warmup(kernels, True))
    all_reduce = torch.distributed.all_reduce
    for n, mode in enumerate(("single", "mesh", "mesh", "single")):
        cfg = scan_config(tmp, True, DP_STEPS, **{
            "paths.run_id": f"dp_{n}_{mode}"})
        captured = []

        def counting(tensor, *args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                captured.append(tensor.numel())
            return all_reduce(tensor, *args, **kwargs)

        zero_counts(kernels)
        with mock.patch.object(torch.distributed, "all_reduce", counting):
            out = train_steps(cfg, DP_STEPS,
                              mesh=mesh if mode == "mesh" else None)
        launches = read_counts(kernels)
        reset_logger()
        runs.append({"mode": mode, "totals": out["totals"],
                     "captured_all_reduces": captured,
                     "dispatch": out["dispatch"], "chunk_k": out["chunk_k"],
                     "notes": config_notes(cfg), "launches": launches,
                     "capture_seconds": out["capture_seconds"],
                     "launches_per_replay": out["launches_per_replay"],
                     "step_ms": out["timed_seconds"] / out["timed_steps"]
                     * 1e3})
    # the mesh's graph holds its collectives: the global sums and the
    # gradient all-reduce, one flat buffer of every parameter (NCCL
    # launches no kernel for a one-rank in-place all-reduce, so the
    # profiler cannot show them)
    n_params = sum(p.numel() for p in flagship_parameters())
    bad = [r for r in runs if r["totals"] != runs[0]["totals"]
           or len(r["totals"]) != DP_STEPS
           or not all(map(math.isfinite, r["totals"]))
           or (r["dispatch"], r["chunk_k"], r["notes"]) != (
               "cuda_graph", DP_STEPS, [None]) or r["launches"] != want
           or r["launches_per_replay"] != launches_per_step(kernels, True, 1)
           or (r["mode"] == "mesh") != (n_params in r["captured_all_reduces"])
           or (r["mode"] == "single") != (not r["captured_all_reduces"])]
    if bad:
        fail(f"data_parallel (a): runs in turns {bad} against the first "
             f"{runs[0]} (want launches {want}, a captured all-reduce of "
             f"{n_params} gradients on the mesh)")
    captured = runs[1]["captured_all_reduces"]
    return {"totals_bitwise": True, "totals": runs[0]["totals"],
            "dispatch": "cuda_graph", "chunk_k": DP_STEPS,
            "captured_all_reduces": {"calls": len(captured),
                                     "gradient_elements": n_params,
                                     "scalars": captured.count(1)},
            "launches": runs[1]["launches"],
            "launches_per_replay": runs[1]["launches_per_replay"],
            "step_ms_in_turns": [[r["mode"], r["step_ms"]] for r in runs],
            "capture_seconds_in_turns": [[r["mode"], r["capture_seconds"]]
                                         for r in runs]}


def run_data_parallel(tmp: str, kernels: dict, bench_run: dict,
                      card: str) -> dict:
    """The fused flagship at full width (bf16, global batch 32) through the
    data-parallel path: (a) one NCCL rank on cuda:0 in this process: one
    epoch of DP_STEPS steps as one chunk of CUDA-graph replays (the
    gradient all-reduce and the global sums as NCCL kernels inside the
    graph), in turns with the single process (:func:`dp_in_turns`: every
    total bitwise, launches a replay's one step plus the warm-up, no
    CONFIG note), the profiler's kernels a step (NCCL's among them) and
    busy share, and one fp32 backward's gradients within 1e-5 (norm) of
    the single process's; (b) two ranks sharing the card over gloo, 16 rows
    each, DP_GLOO_STEPS steps, eagerly (the CONFIG line's ``step_dispatch``
    says ``eager: gloo``): first total 1e-3 relative, one fp32 backward
    1e-4 (norm), both ranks' parameters bitwise equal after the last step,
    each kernel once a step a rank (the head on the TMA path); then the dry
    run on those two ranks; (c) the port's bench with ``--data-parallel 1
    --skip-e2e`` over NCCL (replayed) beside the bench phase's steady line,
    and the analytic 8-GPU prediction.  Nothing falls back: a failed rank
    fails the run."""
    from betavae_tpu_torch import bench
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.parallel.dryrun import dryrun_case, dryrun_check
    from betavae_tpu_torch.parallel.launch import launch
    from betavae_tpu_torch.parallel.mesh import data_parallel_mesh
    from betavae_tpu_torch.utils.flops import data_parallel_scaling

    t_phase = time.perf_counter()
    # (b)'s ranks train on (a)'s data, whose single process is their yardstick
    cfg = scan_config(tmp, True, DP_STEPS, **{"paths.run_id": "dp_gloo"})

    # (a) one NCCL rank, in this process
    mesh = data_parallel_mesh(devices=["cuda:0"])
    try:
        if mesh.backend != "nccl":
            fail(f"data_parallel (a): backend {mesh.backend}, want nccl")
        turns = dp_in_turns(tmp, kernels, mesh)
        single_first = turns["totals"][0]
        step_ms = statistics.mean(ms for mode, ms in turns["step_ms_in_turns"]
                                  if mode == "mesh")
        prof = profile_config(scan_config(tmp, True, DP_STEPS), step_ms,
                              steps=DP_STEPS, mesh=mesh)
        reset_logger()
        case = dp_fp32_case(tmp)
        single_grads = fp32_grads(None, case)
        rel_a = grad_rel(fp32_grads(mesh, case), single_grads)
    finally:
        mesh.close()
    if rel_a > 1e-5:
        fail(f"data_parallel (a): one fp32 backward, gradients rel {rel_a}")
    part_a = {"backend": "nccl", "steps": DP_STEPS, **turns,
              "fp32_grad_rel": rel_a, "step_ms": step_ms,
              "profile": {k: prof[k] for k in (
                  "device_ms_per_step", "device_busy_share",
                  "kernels_per_step", "collective_kernels_per_step",
                  "collective_device_ms_per_step",
                  "top_kernels_ms_per_step")}}

    # (b) two ranks on the one card over gloo, each its own process
    t0 = time.perf_counter()
    shared = ["cuda:0", "cuda:0"]
    dry_case = dryrun_case(shared)
    ranks = launch(dp_shared_card_rank, shared, (cfg, case, dry_case),
                   backend="gloo")
    spawn_s = time.perf_counter() - t0
    trained = [r[0] for r in ranks]
    rel_b = [grad_rel(r[1], single_grads) for r in ranks]
    first_rel = [_rel(t["totals"][0], single_first) for t in trained]
    want_b = launches_per_step(kernels, True, DP_GLOO_STEPS)
    rank_launches = [{k: t["launches"][k] for k in want_b} for t in trained]
    head_by_path = [t["launches"]["head_by_path"] for t in trained]
    upsample_by_path = [t["launches"]["upsample_by_path"] for t in trained]
    notes = config_notes(cfg)
    ok_b = (all(len(t["totals"]) == DP_GLOO_STEPS
                and all(map(math.isfinite, t["totals"]))
                and t["dispatch"] == "eager: gloo" for t in trained)
            and notes == ["eager: gloo"]
            and trained[0]["totals"] == trained[1]["totals"]
            and max(first_rel) <= 1e-3 and max(rel_b) <= 1e-4
            and trained[0]["checksum"] == trained[1]["checksum"]
            and all(rl == want_b for rl in rank_launches)
            and all(p[k]["generic"] == 0 for p in head_by_path for k in p)
            and all(p[k]["generic"] == 0 for p in upsample_by_path
                    for k in p))
    if not ok_b:
        fail(f"data_parallel (b): first totals rel {first_rel}, fp32 grads "
             f"rel {rel_b}, checksums {[t['checksum'] for t in trained]}, "
             f"dispatch {[t['dispatch'] for t in trained]}, CONFIG notes "
             f"{notes}, launches {rank_launches} (want {want_b}), head paths "
             f"{head_by_path}, upsample paths {upsample_by_path}, totals "
             f"{[t['totals'] for t in trained]}")
    t0 = time.perf_counter()
    dry = dryrun_check([r[2] for r in ranks], dry_case, shared, "gloo")
    part_b = {"backend": "gloo", "devices": shared, "rows_per_rank": 16,
              "steps": DP_GLOO_STEPS, "dispatch": trained[0]["dispatch"],
              "config_notes": notes,
              "totals": trained[0]["totals"],
              "first_total_rel": first_rel, "fp32_grad_rel": rel_b,
              "replicas_bitwise_equal": True,
              "checksum": trained[0]["checksum"],
              "step_ms": [t["timed_seconds"] / t["timed_steps"] * 1e3
                          for t in trained],
              "launch_seconds": spawn_s, "launches": rank_launches,
              "head_launches_by_path": head_by_path,
              "upsample_launches_by_path": upsample_by_path,
              "dryrun": dry,
              "dryrun_single_seconds": time.perf_counter() - t0}

    # (c) the bench's --data-parallel line over one NCCL rank
    zero_counts(kernels)
    line = bench.main(["--data-parallel", "1", "--skip-e2e",
                       "--scan-chunk", "32", "--steps", "96",
                       "--warmup", "32"])
    bench_launches = read_counts(kernels)
    n_params = sum(p.numel() for p in flagship_parameters())
    steady = bench_run["line"]["steady_state_images_per_sec"]
    pred = data_parallel_scaling(line["step_ms"], n_params, 8)
    if not (line["metric"] == "train_images_per_sec_dp1_128px_bs32"
            and line["backend"] == "nccl" and line["dispatch"] == "cuda_graph"
            and math.isfinite(line["value"])
            and bench_launches["fused_reparam_kl"] > 0):
        fail(f"data_parallel (c): bench line {line}, launches "
             f"{bench_launches}")
    part_c = {"line": line, "launches": bench_launches,
              "bench_steady_images_per_sec": steady,
              "dp1_over_single": line["value"] / steady,
              "dp8_prediction": {"label": "analytic, not measured",
                                 "param_count": n_params, **pred}}
    return {"phase": "data_parallel", "card": card,
            "seconds": time.perf_counter() - t_phase,
            "one_rank_nccl": part_a, "two_ranks_gloo": part_b,
            "bench_dp1": part_c}


def all_finite(value) -> bool:
    """Every number in a nested line is finite, and none is a string such
    as "FAIL: ..." or "skipped" where a number belongs."""
    if isinstance(value, dict):
        return all(map(all_finite, value.values()))
    if isinstance(value, list):
        return all(map(all_finite, value))
    if isinstance(value, bool):
        return True
    if isinstance(value, (int, float)):
        return math.isfinite(value)
    return False


def run_bench(tmp: str, kernels: dict) -> dict:
    """The port's bench in-process, its e2e work under ``tmp``: the kernel
    canary and PRNG check must read "ok", every number must be finite, and
    the GN kernels (the canary and every step), the head forward (the
    canary) and the reparam+KL forward and backward (every step) must each
    have launched."""
    import gc

    import torch

    from betavae_tpu_torch import bench
    from betavae_tpu_torch.utils.profiling import SPANS

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    device_launched = SPANS.counter("graphs.device_launches")
    t0 = time.perf_counter()
    with timed_prepares() as prepares:
        line = bench.main(BENCH_ARGS + ["--work-dir",
                                        os.path.join(tmp, "bench_e2e")])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    device_launched = (SPANS.counter("graphs.device_launches")
                       - device_launched)
    # a launch a step or validation batch: steady, a warm-up chunk and 3
    # passes of one chunk of 192 steps; e2e, 3 epochs of 182 steps and 41
    # validation batches
    want_device = 4 * 192 + 3 * (LAUNCH_CHECK_STEPS + 4 * REF_TEST_PER_CLASS
                                 // 32)
    if device_launched != want_device:
        fail(f"bench: {device_launched} graph launches from the device, "
             f"want {want_device} (4 steady chunks of 192 steps, 3 e2e "
             f"epochs of {LAUNCH_CHECK_STEPS} steps and their validation "
             f"passes)")
    launches = read_counts(kernels)
    if line["kernel_canary"] != "ok" or line["prng_check"] != "ok":
        fail(f"bench: kernel_canary {line['kernel_canary']!r}, prng_check "
             f"{line['prng_check']!r}")
    numbers = {k: v for k, v in line.items()
               if k not in ("metric", "unit", "prng_check", "kernel_canary",
                            "device", "dispatch", "e2e_epoch_breakdown")}
    numbers["e2e_epoch_breakdown"] = {
        k: v for k, v in line["e2e_epoch_breakdown"].items()
        if k != "dispatch"}
    if not all_finite(numbers):
        fail(f"bench: a number is missing or not finite: {line}")
    missing = [name for name in ("gn_forward", "gn_backward", "head_forward",
                                 "fused_reparam_kl", "reparam_kl_backward",
                                 "upsample_forward", "upsample_backward")
               if launches[name] < 1]
    if missing:
        fail(f"bench: kernels {missing} never launched ({launches})")
    # the GN launches by path: every forward on the generic path (the
    # canary's 2 calls, each train step's and validation batch's 8 blocks,
    # the batch-1 encodes' 4); backward, the canary's on the cluster path,
    # then each train step's 7 blocks on the cluster path and dec3 on the
    # generic one
    gn_paths = {name: dict(kernels[name].launches_by_path)
                for name in ("gn_forward", "gn_backward")}
    fwd, bwd = gn_paths["gn_forward"], gn_paths["gn_backward"]
    if not (bwd["generic"] and bwd["cluster"] - 1 == 7 * bwd["generic"]
            and list(fwd) == ["generic"]
            and fwd["generic"] - 2 >= 8 * bwd["generic"]):
        fail(f"bench: GN launches by path {gn_paths}, want every forward "
             f"generic, the canary's backward on the cluster path and 7 "
             f"cluster backward launches to each generic one a step")
    # the steady state's K = 192 graphs and the e2e run's K = 182 ones: the
    # seconds of each capture (warm-up included), the run's peak memory
    return {"phase": "bench", "args": BENCH_ARGS, "seconds": seconds,
            "launches": launches, "gn_launches_by_path": gn_paths,
            "capture_seconds": prepares, "peak_mem_gib": peak,
            "device_launched_graphs": device_launched, "line": line}


def main() -> None:
    import torch

    mesh_only = sys.argv[1:] == ["--mesh"]
    if sys.argv[1:] and not mesh_only:
        fail(f"unknown arguments {sys.argv[1:]} (only --mesh)")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    # the port itself: absent when this script stands alone
    from betavae_tpu_torch import _build
    from betavae_tpu_torch.ops import kernel_wrappers

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
                    for name in per_kernel},
          "ptxas_by_kernel": {name: ptxas_by_kernel(_build.build_log(name))
                              for name in per_kernel}})
    if mesh_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            mesh = run_mesh(tmp, kernel_wrappers())
        mesh["cards"] = smi.stdout.strip().splitlines()
        emit(mesh)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return

    elbo = {f"{s[0]}x{s[1]}": check_elbo(s, check_moments=s[0] >= 65536)
            for s in ELBO_SHAPES}
    emit({"phase": "kernel", "name": "fused_reparam_kl", "card": card,
          "checks": elbo})
    elbo_start = check_elbo_start()
    emit({"phase": "kernel", "name": "elbo_start", "card": card,
          **elbo_start})
    emit({"phase": "kernel", "name": "elbo_race_check", "card": card,
          **elbo_race_check()})
    emit({"phase": "kernel", "name": "elbo_host_split", "card": card,
          "shape": list(ELBO_SHAPES[0]), "host_us": elbo_host_split()})
    emit({"phase": "kernel", "name": "elbo_pdl_trial", "card": card,
          **elbo_pdl_trial()})
    elbo_device = check_elbo_device_offset()
    emit({"phase": "kernel", "name": "elbo_device_offset", "card": card,
          **elbo_device})
    heads = [check_head(shape, dtype) for shape, dtype in HEAD_CASES]
    emit({"phase": "kernel", "name": "fused_se_conv_head", "card": card,
          "cases": heads})
    gn = check_gn_cases()
    emit({"phase": "kernel", "name": "fused_gn_relu_pool", "card": card,
          **gn})
    emit({"phase": "kernel", "name": "gn_host_split", "card": card,
          "shape": list(GN_CANARY_CASE[0]), "dtype": GN_CANARY_CASE[1],
          "host_us": gn_host_split()})
    emit({"phase": "kernel", "name": "gn_cluster16_trial", "card": card,
          **gn_cluster16_trial()})
    ups = [check_upsample(shape, dtype) for shape, dtype in UPSAMPLE_CASES]
    emit({"phase": "kernel", "name": "upsample2x", "card": card,
          "cases": ups})
    emit({"phase": "kernel", "name": "timed_calls", "card": card,
          "kernels_per_call": KERNELS_PER_TIMED_CALL,
          "profiler_misses": PROFILER_MISSES})
    kernels = kernel_wrappers()
    # the path totals count the main paths' launches from here on
    for name in UPSAMPLE_PATH_TOTALS:
        kernels[name].launches_by_path.update(vector=0, generic=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        emit(check_small_slice(tmp, kernels, fused_head=False))
        emit(check_small_slice(tmp, kernels, fused_head=True))
        flagship = run_flagship(tmp, kernels, fused_head=False)
        flagship["card"] = card
        emit(flagship)
        flagship_fused = run_flagship(tmp, kernels, fused_head=True)
        flagship_fused["card"] = card
        emit(flagship_fused)
        replay = run_replay(tmp, kernels)
        replay["card"] = card
        emit(replay)
        scan = run_scan_chunks(tmp, kernels)
        scan["card"] = card
        emit(scan)
        scaled = run_scaled(tmp, kernels)
        scaled["card"] = card
        emit(scaled)
        remat = run_remat(tmp, kernels)
        remat["card"] = card
        emit(remat)
        determinism = cudnn_determinism(tmp, kernels)
        determinism["card"] = card
        emit(determinism)
        epochs = run_epochs(tmp, kernels)
        epochs["card"] = card
        emit(epochs)
        rotation = run_rotation(tmp, kernels)
        rotation["card"] = card
        emit(rotation)
        # after the epochs run, whose latest it exports
        reference = run_reference_ckpt(tmp, kernels)
        reference["card"] = card
        emit(reference)
        eval_cpu = run_eval_vs_cpu(tmp, kernels)
        eval_cpu["card"] = card
        emit(eval_cpu)
        debug_run = run_debug_config(tmp, kernels)
        debug_run["card"] = card
        emit(debug_run)
        notebook = run_demo_notebook(tmp, kernels)
        notebook["card"] = card
        emit(notebook)
        bench_run = run_bench(tmp, kernels)
        bench_run["card"] = card
        emit(bench_run)
        # after the bench, whose e2e data it reads
        rotation_e2e = rotation_e2e_in_turns(tmp)
        rotation_e2e["card"] = card
        emit(rotation_e2e)
        # after the bench, whose steady line it is set beside
        dp = run_data_parallel(tmp, kernels, bench_run, card)
        emit(dp)
        # after the bench, whose e2e data it reads
        eval_run = run_eval_toolchain(tmp, kernels)
        eval_run["card"] = card
        emit(eval_run)
        decoder = run_decoder(tmp)
        decoder["card"] = card
        emit(decoder)
        # after the epochs run and the evaluation, whose checkpoints, log,
        # panels and tables its CLIs read
        scripts = run_scripts(tmp, kernels)
        scripts["card"] = card
        emit(scripts)
        profiled = profile_flagship(tmp, flagship["step_ms"], fused_head=False)
        emit(profiled)
        profiled_fused = profile_flagship(tmp, flagship_fused["step_ms"],
                                          fused_head=True)
        profiled_fused["card"] = card
        emit(profiled_fused)
        turns = upsample_in_turns(tmp)
        turns["card"] = card
        emit(turns)
        # after the bench, whose e2e data it reads
        host = run_host_feed(tmp, kernels)
        host["card"] = card
        emit(host)
        prof_steps = run_profile_steps(tmp, kernels, profiled_fused)
        prof_steps["card"] = card
        emit(prof_steps)

    # the kernels' numbers at the main path's shapes: reparam+KL at the
    # flagship's [32, 64], the head at the flagship's bf16 y (autocast)
    main_shape = f"{ELBO_SHAPES[0][0]}x{ELBO_SHAPES[0][1]}"
    row = elbo[main_shape]
    head_main = heads[0]
    gn_main = gn["cases"]["2x64x32x32_float32"]
    ups_main = [c for c in ups if c["dtype"] == "bfloat16"
                and tuple(c["shape"]) in UPSAMPLE_FLAGSHIP]
    if any(c[part]["bound_by"] != "bytes" for c in ups_main
           for part in ("forward", "backward")):
        fail(f"upsample: a flagship shape bound by operations: {ups_main}")
    ups_paths = upsample_path_totals(kernels)
    if any(paths["generic"] for paths in ups_paths.values()):
        fail(f"upsample kernels took the generic path on the main paths: "
             f"{ups_paths}")

    def by_path(name):
        return {"epochs": epochs["launches"][name],
                "eval": eval_run["launches"][name],
                "flagship": flagship["launches"][name],
                "flagship_fused_head": flagship_fused["launches"][name],
                "debug_config": debug_run["launches"][name],
                "notebook": notebook["launches"][name],
                "bench": bench_run["launches"][name],
                "reference_ckpt": reference["launches"][name],
                **{f"remat_{mode}": launches[name]
                   for mode, launches in remat["launches"].items()},
                "host_feed": host["launches"][name],
                "host_feed_e2e": host["timing"]["host"]["e2e_launches"][name],
                "host_feed_flagship": host["timing"]["host"][
                    "flagship_launches"][name],
                "profile_steps": prof_steps["launches"][name],
                "data_parallel_nccl_1rank": dp["one_rank_nccl"]["launches"][
                    name],
                **{f"data_parallel_gloo_rank{r}": launches[name]
                   for r, launches in enumerate(
                       dp["two_ranks_gloo"]["launches"])},
                "data_parallel_bench_dp1": dp["bench_dp1"]["launches"][name],
                "scripts": scripts["launches"][name],
                **{f"replay_{head}": r["launches"][name]
                   for head, r in replay.items() if isinstance(r, dict)},
                **{f"scan_chunks_{head}_k{k}": launches[name]
                   for head in ("default_head", "fused_head",
                                "default_head_fp32")
                   for k, launches in scan[head]["launches"].items()},
                "scan_chunks_train_k3": scan["train_k3_vs_k1"]["launches"][
                    name],
                "scaled": scaled["launches"][name],
                "scaled_k1": scaled["launches_k1"][name],
                "rotation": rotation["launches"][name],
                "rotation_early_stop": rotation["early_stop"]["launches"][
                    name]}

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
        # an int offset: the wrapper writes it to the card first (a fill)
        "int_offset_ms": row["int_offset_ms"],
        # the kernel alone on the device in the flagship steps (profiler),
        # where "ms" above is a launch through the wrapper, host included
        "device_ms": profiled["elbo_kernel_device_ms_per_step"],
        "check": "ok",
        "card": card,
        "start_check": elbo_start,
        # the trainers' entry: the offset read from device memory, one
        # capture replayed at 3 offsets, and the clamp → forward chain in a
        # graph with programmatic dependent launch off and on
        "device_offset": elbo_device,
        "shapes": {k: {f: v for f, v in c.items() if f != "backward"}
                   for k, c in elbo.items()},
    }, {
        "name": "reparam_kl_backward",
        "route": "cuda",
        "source": "betavae_tpu_torch/csrc/elbo.cu",
        # the JAX custom VJP's backward, one XLA fusion on the TPU
        "replaces": "betavae_tpu/ops/pallas_elbo.py:118",
        "launches": epochs["launches"]["reparam_kl_backward"],
        "launches_by_path": by_path("reparam_kl_backward"),
        "max_abs_err": max(e for c in elbo.values()
                           for e in c["backward_max_abs_err"].values()),
        "ms": row["backward"]["ms"],
        "plain_ms": row["backward"]["plain_ms"],
        "bound_ms": row["backward"]["bound_ms"],
        "bound_by": row["backward"]["bound_by"],
        "library_ms": None,
        "device_ms": profiled["elbo_backward_kernel_device_ms_per_step"],
        "check": "ok",
        "card": card,
        "shapes": {k: c["backward"] for k, c in elbo.items()},
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
        # the kernel alone (profiler) in the kernel phase, at the flagship's
        # bf16 y, its bound over that time, and the fused flagship steps'
        # device time of the kernel per step
        "device_ms": head_main[part]["device_ms"],
        "bound_fraction": head_main[part]["bound_fraction"],
        "path": head_main[part]["path"],
        "device_ms_per_fused_step": profiled_fused[
            f"{profile_key}_device_ms_per_step"],
        "check": "ok",
        "card": card,
        "shapes": [{"shape": c["shape"], "dtype": c["dtype"], **c[part],
                    **c["checks"][part]} for c in heads],
    } for name, part, replaces, profile_key in (
        ("head_forward", "forward", "betavae_tpu/ops/pallas_head.py:127",
         "head_fwd_kernel"),
        ("head_m", "m", "betavae_tpu/ops/pallas_head.py:152",
         "head_m_kernel"))] + [{
        "name": name,
        "route": "cuda",
        "source": "betavae_tpu_torch/csrc/gn.cu",
        "replaces": replaces,
        # the GN kernels' main path is the bench's kernel canary
        "launches": bench_run["launches"][name],
        "launches_by_path": by_path(name),
        "max_abs_err": max(c["checks"][k]["max_abs_err"]
                           for c in gn["cases"].values() for k in keys),
        # at the main path's shape, the canary's fp32 [2, 64, 32, 32]
        "ms": gn_main[part]["ms"],
        "plain_ms": gn_main[part]["plain_ms"],
        "bound_ms": gn_main[part]["bound_ms"],
        "bound_by": gn_main[part]["bound_by"],
        # F.group_norm: the norm and affine only, no ReLU or pool
        "library_ms": gn_main[part]["library_ms"],
        "unfused_ms": gn_main[part]["unfused_ms"],
        "device_ms": gn_main[part]["device_ms"],
        # the canary's path and its bound over that device time
        "path": gn_main[part]["path"],
        "bound_fraction": gn_main[part]["bound_fraction"],
        "check": "ok",
        "card": card,
        "blocks": gn["blocks"],
        "shapes": [{"shape": c["shape"], "dtype": c["dtype"],
                    "k": c["k"], **c[part]}
                   for c in gn["cases"].values()],
    } for name, part, replaces, keys in (
        ("gn_forward", "forward", "betavae_tpu/ops/pallas_gn.py:113",
         ("y", "pooled", "m", "rstd")),
        ("gn_backward", "backward", "betavae_tpu/ops/pallas_gn.py:139",
         ("dx", "dgamma", "dbeta")))] + [{
        "name": name,
        "route": "cuda",
        "source": "betavae_tpu_torch/csrc/upsample.cu",
        # an XLA formulation in JAX (separable dilated depthwise convs, its
        # backward XLA's transposed conv), not a Pallas kernel
        "replaces": "betavae_tpu/ops/upsample.py:32",
        "launches": epochs["launches"][name],
        "launches_by_path": by_path(name),
        "max_abs_err": max(c["checks"][part]["max_abs_err"] for c in ups),
        "bitwise_vs_plain": all(c["checks"][part]["bitwise_vs_plain"]
                                for c in ups),
        # one flagship train step's four launches (the bf16 decoder shapes
        # under autocast), summed
        **{key: sum(c[part][key] for c in ups_main)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "device_ms")},
        "bound_by": "bytes",
        # every main-path launch of the script by the kernels' path (all
        # vector: ``read_counts`` fails on a generic one)
        "launches_by_kernel_path": ups_paths[name],
        "device_ms_per_profiled_step": profiled[f"{part}_upsample_ms"],
        "check": "ok",
        "card": card,
        "shapes": [{"shape": c["shape"], "dtype": c["dtype"], **c[part],
                    **c["checks"][part]} for c in ups],
    } for name, part in (("upsample_forward", "forward"),
                         ("upsample_backward", "backward"))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
