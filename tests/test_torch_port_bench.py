"""The port's bench entry and FLOP accounting against the JAX package's, on
the CPU.

``betavae_tpu_torch.utils.flops`` must count what ``betavae_tpu.utils.flops``
counts given the same peak rates; ``betavae_tpu_torch.bench``'s
``_windowed_rates``, ``_headline_fields`` and CPU derating must equal
``bench.py``'s on the same inputs; ``python -m betavae_tpu_torch.bench
--device cpu`` must print one JSON line with the BENCH line's keys; and a
tiny end-to-end run must give a finite pooled rate.
"""

import argparse
import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench as jax_bench  # noqa: E402
from betavae_tpu.utils import flops as jax_flops  # noqa: E402

from betavae_tpu_torch import bench  # noqa: E402
from betavae_tpu_torch.ops.gn import (_pre_relu,  # noqa: E402
                                      gn_forward_reference)
from betavae_tpu_torch.utils import flops  # noqa: E402

GEOMETRIES = [(128, 1, 64, 64, 4, 32), (64, 1, 32, 16, 3, 8),
              (256, 1, 128, 64, 5, 256)]
LINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "steady_state_images_per_sec",
    "vs_baseline_steady_state", "step_ms", "dispatch", "mfu", "sol_step_ms",
    "sol_fraction", "e2e_images_per_sec", "vs_baseline_e2e",
    "e2e_epoch_breakdown", "encode_p50_ms_bs1", "encode_device_ms_bs1",
    "prng_check", "kernel_canary", "device"}


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_flop_counts_match_jax_package(geom):
    size, cin, latent, base, blocks, batch = geom
    got = flops.model_forward_flops(size, cin, latent, base, blocks)
    want = jax_flops.model_forward_flops(size, cin, latent, base, blocks)
    assert [(l.name, l.flops, l.out_shape) for l in got] == \
        [(l.name, l.flops, l.out_shape) for l in want]
    for remat in (False, True):
        a = flops.train_step_flops(size, cin, latent, base, blocks, batch,
                                   remat=remat)
        b = jax_flops.train_step_flops(size, cin, latent, base, blocks, batch,
                                       remat=remat)
        assert {k: v for k, v in a.items() if k != "layers"} == \
            {k: v for k, v in b.items() if k != "layers"}


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("peak,hbm", [(197.0, 819.0), (989.0, 3350.0)])
def test_speed_of_light_matches_jax_package(geom, peak, hbm):
    size, cin, latent, base, blocks, batch = geom
    kw = dict(batch_size=batch, param_count=5_000_000, peak_tflops=peak,
              hbm_gbps=hbm)
    assert flops.speed_of_light_ms(size, cin, latent, base, blocks, **kw) == \
        jax_flops.speed_of_light_ms(size, cin, latent, base, blocks, **kw)


def test_h100_defaults_and_utilization():
    fl = flops.train_step_flops(128, 1, 64, 64, 4, batch_size=32)
    step = 0.02
    got = flops.utilization(step, fl["train_flops_per_step"])
    assert got["peak_tflops"] == flops.H100_SXM_BF16_TFLOPS == 989.0
    want = jax_flops.utilization(step, fl["train_flops_per_step"],
                                 peak_tflops=989.0)
    assert got["achieved_tflops"] == want["achieved_tflops"]
    assert got["mfu"] == want["mxu_utilization"]
    assert flops.speed_of_light_ms(128, 1, 64, 64, 4, 32) == \
        jax_flops.speed_of_light_ms(128, 1, 64, 64, 4, 32, peak_tflops=989.0,
                                    hbm_gbps=3350.0)


@pytest.mark.parametrize("spans,n_train,n_win", [
    ([1.0, 1.0, 1.0, 10.0], 100, 3), ([2.0, 2.0], 100, 3), ([4.0], 100, 3),
    ([1.0, 2.0, 4.0], 100, 3), ([0.5, 0.7, 0.6, 0.9, 1.1, 0.4, 0.8], 5824, 3),
    ([1.3, 1.2], 5824, 1)])
def test_windowed_rates_match_jax_bench(spans, n_train, n_win):
    assert bench._windowed_rates(spans, n_train, n_win) == \
        jax_bench._windowed_rates(spans, n_train, n_win)


@pytest.mark.parametrize("e2e,vs", [
    (3600.0, 59.016), (1234, 20.23), ("skipped", "skipped"),
    ("FAIL: boom", "FAIL")])
def test_headline_fields_match_jax_bench(e2e, vs):
    for size, batch in ((128, 32), (32, 4)):
        assert bench._headline_fields(4320.0, e2e, vs, size, batch) == \
            jax_bench._headline_fields(4320.0, e2e, vs, size, batch)


@pytest.mark.parametrize("size,batch,steps,warmup", [
    (128, 32, 384, 192), (32, 4, 1, 1), (64, 8, 2, 2), (48, 16, 100, 1)])
def test_cpu_derating_matches_jax_bench(size, batch, steps, warmup):
    fields = ("image_size", "batch_size", "steps", "warmup", "scan_chunk",
              "skip_e2e")
    port = argparse.Namespace(image_size=size, batch_size=batch,
                              steps=steps, warmup=warmup, scan_chunk=192,
                              skip_e2e=False)
    ref = argparse.Namespace(image_size=size, batch_size=batch, steps=steps,
                             warmup=warmup, skip_e2e=False, scan_chunk=192,
                             data_parallel=0)
    bench._derate_args_for_cpu(port)
    jax_bench._derate_args_for_cpu(ref)
    assert [getattr(port, f) for f in fields] == \
        [getattr(ref, f) for f in fields]


def test_cpu_run_prints_one_json_line(capsys):
    line = bench.main(["--device", "cpu", "--image-size", "32",
                       "--batch-size", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == LINE_KEYS | {"backend"}
    assert line["metric"] == "train_images_per_sec_per_chip_32px_bs4"
    assert line["value"] == line["steady_state_images_per_sec"] > 0
    assert math.isfinite(line["step_ms"]) and line["sol_step_ms"] > 0
    assert line["encode_p50_ms_bs1"] > 0 and line["encode_device_ms_bs1"] > 0
    assert line["prng_check"] == line["kernel_canary"] == "skipped (cpu)"
    assert line["mfu"] == line["sol_fraction"] == "not measured (cpu)"
    assert line["e2e_images_per_sec"] == "skipped"
    assert line["dispatch"] == "eager: cpu"
    assert line["device"] == "cpu" and "not a GPU number" in line["backend"]


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])


def test_tiny_e2e_gives_a_finite_pooled_rate(tmp_path):
    """The flagship config at 32 px over 8 train images per class (one step
    an epoch), 3 epochs with the background writer: a finite pooled rate
    from the drain stamps, the breakdown, and the run's checkpoints."""
    rate, breakdown = bench._e2e_images_per_sec(
        epochs=3, per_class_train=8, per_class_test=4, image_size=32,
        work_dir=str(tmp_path), device="cpu")
    assert math.isfinite(rate) and rate > 0
    assert set(breakdown) >= {"val_seconds", "probe_seconds", "ckpt_seconds",
                              "panel_seconds", "tail_seconds",
                              "epoch_wall_seconds",
                              "span_rates_hostjitter",
                              "walls_rate_images_per_sec", "dispatch",
                              "rotated_epochs", "rotate_dispatch_seconds"}
    assert breakdown["walls_rate_images_per_sec"] > 0
    # epochs 1 and 2 dispatch the next epoch's first step from their tail
    assert (breakdown["dispatch"], breakdown["rotated_epochs"]) == (
        "eager: cpu", 2)
    assert len(breakdown["rotate_dispatch_seconds"]) == 3
    assert breakdown["rotated_by_epoch"] == [True, True, False]
    assert len(breakdown["tail_seconds_by_epoch"]) == 3
    assert len(breakdown["train_images_per_sec_by_epoch"]) == 3
    assert all(r > 0 for r in breakdown["span_rates_hostjitter"])
    models = tmp_path / "outputs" / "models"
    assert {"bench_e2e_latest_shard0.pt", "bench_e2e_best_shard1.pt"} <= \
        set(os.listdir(models))


def test_flagship_model_has_the_jax_flagship_parameters():
    """The bench's model is ``__graft_entry__._flagship_model``'s: the same
    parameter count (at 32 px, where the flatten width is small)."""
    from __graft_entry__ import _flagship_model
    from betavae_tpu.train.loop import init_state
    from betavae_tpu.train.optim import build_optimizer
    from betavae_tpu.config import get_config

    get_config(os.path.join(ROOT, "configs", "beta_vae_se.yaml"))
    state = init_state(_flagship_model(image_size=32, mixed_precision=False),
                       build_optimizer(get_config()), jax.random.PRNGKey(0))
    want = sum(int(np.prod(p.shape))
               for p in jax.tree_util.tree_leaves(state.params))
    model = bench.flagship_model(32, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want
    assert model.mixed_precision and not model.fused_head


def test_canary_inputs_are_the_jax_canarys_draws():
    """The canary draws x, γ, β, s, k in the JAX canary's order from its
    seed (NHWC → NCHW, k [3, 3, C] → [C, 3, 3]); and no pre-ReLU value
    lies within 1e-7 of 0, so the kernel and the plain version, whose z
    differ by fp32 rounding of m and rstd, agree on every ReLU mask bit of
    the gradient check."""
    rng = np.random.default_rng(20260817)
    x = rng.normal(size=(2, 32, 32, 64)).astype(np.float32)
    gamma = rng.normal(size=64).astype(np.float32)
    beta = (rng.normal(size=64) * 0.1).astype(np.float32)
    s = rng.uniform(0.1, 1.0, size=(2, 64)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 64)) * 0.1).astype(np.float32)
    got = bench.canary_inputs()
    for a, b in zip(got, (x.transpose(0, 3, 1, 2), gamma, beta, s,
                          k.transpose(2, 0, 1))):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got[5].shape == (2, 64, 32, 32) and got[6].shape == (2, 64)
    _, _, m, rstd = gn_forward_reference(*got[:3])
    _, z = _pre_relu(got[0], got[1], got[2], m, rstd)
    assert float(z.abs().min()) > 1e-7


def test_prng_check_and_canary_skip_on_the_cpu():
    cpu = torch.device("cpu")
    assert bench._prng_self_check(cpu) == "skipped (cpu)"
    assert bench._kernel_canary(cpu) == "skipped (cpu)"


@pytest.mark.parametrize("argv,parsed,derated", [
    ([], 192, 2), (["--scan-chunk", "16"], 16, 2),
    (["--scan-chunk", "1"], 1, 1)])
def test_scan_chunk_parses_and_is_lowered_to_2_on_the_cpu(argv, parsed,
                                                          derated):
    """``--scan-chunk K``: the JAX flag's default (192) and meaning, K
    steps a dispatch; the CPU's derated check lowers it to 2, as the JAX
    bench's ``_derate_args_for_cpu`` does, and keeps a smaller K."""
    args = bench.parse_args(argv)
    assert args.scan_chunk == parsed
    ref = argparse.Namespace(image_size=args.image_size,
                             batch_size=args.batch_size, steps=args.steps,
                             warmup=args.warmup, skip_e2e=False,
                             scan_chunk=parsed, data_parallel=0)
    bench._derate_args_for_cpu(args)
    jax_bench._derate_args_for_cpu(ref)
    assert args.scan_chunk == ref.scan_chunk == derated
