"""The benchmark's own arithmetic: FLOP and byte counts at the flagship's
shapes, worked by hand, and the trace reader on a synthetic trace."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import yaml

from benchmark import flops, tracing

BENCH = Path(__file__).resolve().parent.parent
FLAGSHIP = flops.sizes(yaml.safe_load((BENCH / "configs" / "flagship.yaml")
                                      .read_text()))


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flagship_flops_by_hand():
    # encoder convs: out side, cout, cin → 2·s²·cout·9·cin
    enc = [(64, 64, 1), (32, 128, 64), (16, 256, 128), (8, 512, 256)]
    dec = [(16, 256, 512), (32, 128, 256), (64, 64, 128), (128, 64, 64)]
    convs = sum(2 * s * s * co * 9 * ci for s, co, ci in enc + dec)
    convs += 2 * 128 * 128 * 1 * 9 * 64                      # final conv
    se = sum(2 * c * (c // 8) * 2 for c in (64, 128, 256, 512, 256, 128, 64, 64))
    dense = 3 * 2 * (512 * 8 * 8) * 64                       # mu, logvar, dec
    per_image = convs + se + dense
    assert flops.forward_flops_per_image(**FLAGSHIP) == per_image
    assert flops.train_step_flops(32, **FLAGSHIP) == 3 * per_image * 32
    assert flops.train_step_flops(32, **FLAGSHIP) == pytest.approx(3.37e11,
                                                                   rel=0.01)


def test_flagship_flops_equal_the_programs_count():
    from betavae_tpu_torch.utils.flops import train_step_flops

    ours = flops.train_step_flops(32, **FLAGSHIP)
    theirs = train_step_flops(128, 1, 64, 64, 4, 32)["train_flops_per_step"]
    assert ours == theirs


def test_flagship_upsample_bytes_by_hand():
    # decoder inputs 512@8², 256@16², 128@32², 64@64², batch 32, bf16;
    # forward reads 1, writes 4, backward reads 4, writes 1
    elems = 512 * 64 + 256 * 256 + 128 * 1024 + 64 * 4096
    assert _metric("upsample_roofline").step_bytes(32, FLAGSHIP, 2) == \
        10 * 32 * elems * 2 == 314_572_800


def test_flagship_groupnorm_bytes_by_hand():
    enc = 64 * 64**2 + 128 * 32**2 + 256 * 16**2 + 512 * 8**2
    dec = 256 * 16**2 + 128 * 32**2 + 64 * 64**2 + 64 * 128**2
    channels = 64 + 128 + 256 + 512 + 256 + 128 + 64 + 64
    want = 5 * 32 * (enc + dec) * 2 + 16 * channels
    assert _metric("groupnorm_roofline").step_bytes(32, FLAGSHIP, 2) == \
        want == 639_654_912


def _synthetic(tmp_path: Path) -> Path:
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
         "ts": 1000.0, "dur": 1000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 1000.0, "dur": 150.0},
        {"ph": "X", "cat": "kernel", "name": "void gn_stats_kernel<bf16>()",
         "ts": 1100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "RowwiseMomentsCUDAKernel<float>",
         "ts": 1250.0, "dur": 150.0},       # overlaps the one before
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 1500.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
         "ts": 1420.0, "dur": 60.0},
        {"ph": "X", "cat": "kernel", "name": "upsample2x_fwd_vector_kernel",
         "ts": 1900.0, "dur": 200.0},       # half outside the window
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 10.0,
         "dur": 50.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_reader_on_a_synthetic_trace(tmp_path):
    t = tracing.Trace.load(str(_synthetic(tmp_path)))
    assert t.window_s == pytest.approx(1e-3)
    # busy: [1100, 1400] + [1500, 1600] + [1900, 2000] = 500 µs
    assert t.busy_s == pytest.approx(500e-6)
    assert t.idle_share == pytest.approx(0.5)
    assert t.kernel_seconds(("gn_stats", "RowwiseMoments")) == \
        pytest.approx(350e-6)
    assert t.kernel_seconds(("upsample2x",)) == pytest.approx(100e-6)
    assert t.kernel_seconds(("nothing",)) == 0.0
    top = dict(t.top_ops(10))
    assert top["void gn_stats_kernel<bf16>()"] == pytest.approx(200e-6)
    assert "outside" not in top
    gaps = dict(t.idle_by_host(10))
    # [1000, 1100] under the launch, [1400, 1500] under the copy,
    # [1600, 1900] under no host event
    assert gaps["cudaGraphLaunch"] == pytest.approx(100e-6)
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps["(no host event)"] == pytest.approx(300e-6)


def test_trace_without_the_window_is_refused(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError):
        tracing.Trace.load(str(path))


class _Trace:
    window_s = 0.5

    def kernel_seconds(self, patterns):
        return 0.0


def test_readers_give_nothing_where_nothing_ran():
    from benchmark.harness import Ctx

    ctx = Ctx(trace=_Trace(), steps=4, batch=32, cfg={"training": {}},
              sizes=FLAGSHIP, peaks={"bf16_flops": 1e15, "hbm_bytes": 3e12},
              counters={})
    assert _metric("upsample_roofline").read(ctx) is None
    assert _metric("groupnorm_roofline").read(ctx) is None
    no_peaks = Ctx(**{**ctx.__dict__, "peaks": None})
    assert _metric("step.mfu").read(no_peaks) is None
