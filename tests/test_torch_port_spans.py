"""The port's spans and counters (``betavae_tpu_torch/utils/profiling.py``):
the registry on its own (nesting, the rings' bounds, counts and spans from
many threads, a span inside a capture, a cycle's accounting), the ``spans``
METRICS line of a CPU ``train()`` beside its ``epoch_end`` line, and the
spans as annotations of a ``torch.profiler`` session, and only there."""

from __future__ import annotations

import json
import os
import sys
import threading

import pytest
import torch
import yaml

from betavae_tpu_torch.eval.logs import iter_metrics
from betavae_tpu_torch.utils import profiling
from betavae_tpu_torch.utils.profiling import CHUNK, SpanRecord, Spans

from test_torch_port_train import (_count_plain_calls, _port_train,
                                   _rotation_config, _stub_graphs)

TRAINER_SPANS = ("trainer.drain", "trainer.val_dispatch", "trainer.rotate",
                 "trainer.val_read", "trainer.probes", "trainer.checkpoint",
                 "trainer.panel", "trainer.tail", "trainer.panel_forward",
                 "trainer.snapshot")
DISPATCH_SPANS = (CHUNK, "dispatch.stage", "dispatch.upload",
                  "dispatch.draws", "dispatch.launch", "eval.pass",
                  "ckpt.pull")
SPANS_KEYS = ("phase", "step", "epoch", "cycle_seconds",
              "device_busy_seconds", "device_idle_seconds", "idle_by_span",
              "host_seconds", "device_seconds", "steps", "counters", "traced")
# the keys of the JAX package's lines, in order, which the port's keep
LINE_KEYS = {
    "train": ("phase", "step", "epoch", "beta", "capacity",
              "train_total_loss", "train_recon_loss", "train_recon_base",
              "train_recon_lpips", "train_recon_ffl", "train_kl",
              "train_kl_mean", "train_kl_effective_last",
              "train_kl_per_dim_mean", "loss_mode", "mu_mean_batch",
              "z_std_batch", "lr"),
    "val": ("phase", "step", "epoch", "beta", "capacity", "val_total_loss",
            "val_recon_loss", "val_recon_base", "val_recon_lpips",
            "val_recon_ffl", "val_kl", "val_kl_per_dim_mean", "loss_mode",
            "train_kl_mean", "train_kl_effective_last", "latent_probe_auc",
            "best_dim_auc", "best_dim_corr", "best_dim_r2", "epoch_seconds",
            "train_steps_per_sec", "train_images_per_sec"),
    "epoch_end": ("phase", "step", "epoch", "val_seconds",
                  "val_dispatch_seconds", "rotate_dispatch_seconds",
                  "rotated", "probe_seconds", "ckpt_seconds",
                  "panel_seconds", "tail_seconds", "epoch_wall_seconds",
                  "t_mono", "t_drain_mono"),
}
# the epoch_end keys that are a span's host seconds, rounded to 3 places
SPAN_KEYS = {"val_dispatch_seconds": "trainer.val_dispatch",
             "rotate_dispatch_seconds": "trainer.rotate",
             "probe_seconds": "trainer.probes",
             "ckpt_seconds": "trainer.checkpoint",
             "panel_seconds": "trainer.panel",
             "tail_seconds": "trainer.tail"}


def test_nested_spans_record_parents_and_host_times():
    spans = Spans()
    with spans.span("outer") as outer:
        with spans.span("inner") as inner:
            torch.ones(8).sum()
        with spans.span("second") as second:
            pass
    assert (outer.parent, inner.parent, second.parent) == (None, "outer",
                                                           "outer")
    assert outer.t0 <= inner.t0 <= inner.t1 <= second.t0 <= second.t1 \
        <= outer.t1
    # host spans on the CPU: no device interval
    assert all(r.d0 is None and r.events is None
               for r in (outer, inner, second))
    assert spans.host_total("outer") == pytest.approx(outer.t1 - outer.t0)
    with spans.span("after") as after:
        pass
    assert after.parent is None


def test_the_rings_keep_the_last_records():
    spans = Spans(epochs=4, chunks=8)
    recs = []
    for i in range(20):
        with spans.span(CHUNK) as rec:
            rec.steps = i
        recs.append(rec)
    with spans.span("dispatch.stage"):
        pass
    assert list(spans.chunks) == recs[-8:]
    spans.start_epochs(torch.device("cpu"))
    for epoch in range(1, 11):
        spans.end_epoch(epoch, 10 * epoch)
    assert [line["epoch"] for line in spans.epochs] == [7, 8, 9, 10]
    assert [step for step, _ in spans.lines()] == [10 * e for e in
                                                   range(1, 11)]
    assert spans.lines() == []


def test_counts_and_spans_from_many_threads():
    """More threads than cores count and open nested spans at a switch
    interval of a microsecond: no count is lost, and each thread's spans
    nest within its own."""
    spans = Spans()
    threads_n, n = (os.cpu_count() or 1) + 2, 2000
    parents, errors = [], []
    switch = sys.getswitchinterval()

    def work(k: int) -> None:
        try:
            for i in range(n):
                spans.count("hits")
                spans.count("pairs", 2)
                if i % 20 == 0:
                    with spans.span(f"outer{k}"):
                        with spans.span(f"inner{k}") as inner:
                            pass
                    parents.append((k, inner.parent))
        except Exception as err:  # raised below, on the test's thread
            errors.append(err)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert spans.counter("hits") == threads_n * n
    assert spans.counter("pairs") == 2 * threads_n * n
    assert all(parent == f"outer{k}" for k, parent in parents)
    assert len(parents) == threads_n * n // 20


def test_a_span_inside_a_capture_raises(monkeypatch):
    spans = Spans()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with spans.span(CHUNK):
            pass
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with spans.span(CHUNK):
        pass
    assert len(spans.chunks) == 1


def test_a_cycles_account():
    """A cycle [10, 20] on the device: a chunk running in from the one
    before, the validation pass, a gap under the drain, the next chunk
    running out of it, and a copy on a side stream over the last."""
    cycle = {"t0": 10.0, "t1": 20.0, "epoch": 3, "step": 30,
             "device": True, "counters": {"graphs.device_launches": 5},
             "counters_end": {"graphs.device_launches": 20,
                              "graphs.host_launches": 0},
             "tracing": (2, False), "tracing_end": (2, False)}
    recs = [
        SpanRecord(CHUNK, "trainer.rotate", 8.0, 8.1, 8.0, 16.0, 10),
        SpanRecord("trainer.drain", None, 10.5, 16.0),
        SpanRecord("trainer.tail", None, 16.0, 19.0),
        SpanRecord("eval.pass", "trainer.val_dispatch", 16.0, 16.2, 16.0,
                   17.0),
        SpanRecord("trainer.val_read", "trainer.tail", 17.5, 18.5),
        SpanRecord(CHUNK, "trainer.rotate", 17.0, 17.1, 18.0, 24.0, 12),
        SpanRecord("ckpt.pull", "trainer.checkpoint", 18.6, 18.7, 18.6,
                   19.0),
    ]
    line = Spans.account(cycle, recs)
    assert line["cycle_seconds"] == 10.0
    assert line["device_busy_seconds"] == pytest.approx(6 + 1 + 2)
    assert line["device_idle_seconds"] == pytest.approx(1.0)
    # the gap 17 … 18: the tail is open at 17.5, the read from 17.5 on
    assert line["idle_by_span"] == {"trainer.val_read": pytest.approx(1.0)}
    assert line["device_seconds"] == {CHUNK: pytest.approx(8.0),
                                      "eval.pass": pytest.approx(1.0),
                                      "ckpt.pull": pytest.approx(0.4)}
    # 6/8 of 10 steps, 2/6 of 12
    assert line["steps"] == pytest.approx(7.5 + 4.0)
    assert line["host_seconds"] == {
        "trainer.drain": pytest.approx(5.5), "trainer.tail": 3.0,
        "eval.pass": pytest.approx(0.2), "trainer.val_read": 1.0,
        CHUNK: pytest.approx(0.1), "ckpt.pull": pytest.approx(0.1)}
    assert line["counters"] == {"graphs.device_launches": 15,
                                "graphs.host_launches": 0}
    assert line["traced"] is False
    cycle["tracing_end"] = (3, True)
    assert Spans.account(cycle, recs)["traced"] is True
    # off the device: host seconds only
    cycle["device"] = False
    line = Spans.account(cycle, recs)
    assert (line["device_busy_seconds"], line["idle_by_span"],
            line["steps"], line["device_seconds"]) == (None, None, None, {})


@pytest.fixture(scope="module")
def rotation_lines(tmp_path_factory):
    """The METRICS lines of the rotation config's CPU ``train()`` (three
    epochs of 5 steps in chunks of 2, rotation on)."""
    path = _rotation_config(tmp_path_factory.mktemp("spans"))
    _port_train(path)
    cfg = yaml.safe_load(open(path))
    return iter_metrics(os.path.join(cfg["paths"]["outputs_dir"], "logs",
                                     "run.log"))


def test_one_spans_line_an_epoch_beside_its_epoch_end(rotation_lines):
    spans = [m for m in rotation_lines if m["phase"] == "spans"]
    ends = [m for m in rotation_lines if m["phase"] == "epoch_end"]
    assert [m["epoch"] for m in spans] == [m["epoch"] for m in ends] == \
        [1, 2, 3]
    assert [m["step"] for m in spans] == [m["step"] for m in ends]
    # each epoch's line at the next epoch's sync, the last at the run's end
    phases = [m["phase"] for m in rotation_lines]
    assert phases[-1] == "spans" and phases[-2] == "epoch_end"
    for line, end in zip(spans, ends):
        assert tuple(line) == SPANS_KEYS
        host = line["host_seconds"]
        assert set(TRAINER_SPANS + DISPATCH_SPANS) <= set(host), line
        assert all(v >= 0 for v in host.values())
        for key, name in SPAN_KEYS.items():
            assert abs(host[name] - end[key]) <= 5e-4 + 1e-6, key
        # the CPU: no device time, no graph
        assert (line["device_busy_seconds"], line["device_idle_seconds"],
                line["idle_by_span"], line["steps"]) == (None,) * 4
        assert line["device_seconds"] == {} and line["traced"] is False
        assert line["counters"] == {}
    # the cycles lie end to end on the epoch_end stamps' clock
    for a, b, line in zip(ends, ends[1:], spans[1:]):
        assert line["cycle_seconds"] == pytest.approx(b["t_mono"] - a["t_mono"],
                                                      abs=2e-6)


def test_train_val_and_epoch_end_keys_are_the_jax_packages(rotation_lines):
    for phase, keys in LINE_KEYS.items():
        got = {tuple(m) for m in rotation_lines if m["phase"] == phase}
        assert got == {keys}, phase
    for end in (m for m in rotation_lines if m["phase"] == "epoch_end"):
        # the tail's start to the validation read's end: the tail's first
        # three phases
        assert end["val_seconds"] >= end["val_dispatch_seconds"] - 1e-3
        assert end["tail_seconds"] >= end["val_seconds"] - 1e-3
        assert end["epoch_wall_seconds"] >= end["tail_seconds"]
        assert end["t_mono"] >= end["t_drain_mono"]


def test_spans_are_profiler_annotations_in_a_session_alone(tmp_path,
                                                           monkeypatch):
    opened = []
    record_function = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        opened.append(name)
        return record_function(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    spans = Spans()
    with spans.span(CHUNK) as outside:
        torch.ones(8).sum()
    assert opened == [] and outside.traced is False
    path = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span(CHUNK) as chunk:
            with spans.span("dispatch.launch"):
                torch.ones(8).sum()
    prof.export_chrome_trace(str(path))
    assert opened == [CHUNK, "dispatch.launch"] and chunk.traced is True
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {CHUNK, "dispatch.launch"} <= names
    with spans.span(CHUNK) as after:
        pass
    assert after.traced is False and len(opened) == 2
    assert profiling._Tracing.open is False


def test_spans_lines_count_the_captured_graphs_gn_calls_by_path(tmp_path,
                                                                monkeypatch):
    """The trainers' CUDA-graph path with a stand-in graph on the CPU (the
    rotation config: 3 epochs of 5 steps in chunks of 2, 2 validation
    batches an epoch), the GN plain versions counted as kernel calls on
    their paths: the ``spans`` lines' ``gn.cluster_launches`` and
    ``gn.generic_launches`` add up to the kernel launches of the captured
    step's GN calls (a forward, two kernels on the generic path, in each
    of the 2 encoder and 2 decoder blocks, and a backward on ``gn_path``'s
    path: one kernel on the cluster path, two on the generic) times its
    launches, plus the captured validation batch's forwards times its
    launches."""
    from betavae_tpu_torch.ops.gn import gn_path

    monkeypatch.setattr(profiling.SPANS, "counters",
                        profiling.collections.Counter())
    _count_plain_calls(monkeypatch)
    runs = _stub_graphs(monkeypatch)
    path = _rotation_config(tmp_path)
    _port_train(path)
    cfg = yaml.safe_load(open(path))
    lines = [m for m in iter_metrics(os.path.join(
        cfg["paths"]["outputs_dir"], "logs", "run.log"))
        if m["phase"] == "spans"]
    # 16 px, base 4, 2 blocks, batch 4, fp32: each block's conv output
    shapes = [(4, 4, 8, 8), (4, 8, 4, 4), (4, 4, 8, 8), (4, 4, 16, 16)]
    backward = {p: sum(gn_path(s, torch.float32)[0] == p for s in shapes)
                for p in ("cluster", "generic")}
    launches = {kind: sum(n for k, _, n in runs if k == kind)
                for kind in ("TrainChunks", "EvalChunks")}
    assert launches == {"TrainChunks": 15, "EvalChunks": 6}
    train, val = launches["TrainChunks"], launches["EvalChunks"]
    want = {"cluster": train * backward["cluster"],
            "generic": (train + val) * 2 * len(shapes)
            + train * 2 * backward["generic"]}
    for p, n in want.items():
        got = sum(m["counters"].get(f"gn.{p}_launches", 0) for m in lines)
        assert got == n, (p, [m["counters"] for m in lines])
    assert backward["cluster"] > 0 and [m["epoch"] for m in lines] == \
        [1, 2, 3]
