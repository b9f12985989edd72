"""The readers of the program's spans (``dispatch.*``, ``trainer.*``
metrics that read ``betavae_tpu_torch/utils/profiling.py``'s registry):
None on the CPU, and each metric from a hand-built registry."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from benchmark import harness
from betavae_tpu_torch.utils.profiling import CHUNK, SpanRecord, Spans

BENCH = Path(__file__).resolve().parent.parent
READERS = ("dispatch.device_idle_share", "dispatch.host_ms",
           "trainer.device_idle_share", "trainer.val_device_s",
           "trainer.step_device_ms")


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(**counters) -> harness.Ctx:
    return harness.Ctx(trace=None, steps=0, batch=32, cfg={}, sizes={},
                       peaks=None, counters=counters)


def _chunk(t0, host_s, d0, d1, steps, traced=False) -> SpanRecord:
    return SpanRecord(CHUNK, None, t0, t0 + host_s, d0, d1, steps, traced)


def _steady() -> Spans:
    """Warm-up chunks, a window of three chunks of 10 steps (0.5 s idle
    between the second and the third), then two traced chunks."""
    spans = Spans()
    spans.chunks.extend([
        _chunk(0.0, 0.01, 0.0, 1.0, 10),            # warm-up
        _chunk(2.0, 0.010, 2.0, 3.0, 10),           # the window
        _chunk(2.5, 0.012, 3.0, 4.0, 10),
        _chunk(4.5, 0.014, 4.5, 5.5, 10),
        _chunk(6.0, 0.05, 6.0, 7.5, 4, traced=True),
        _chunk(7.6, 0.05, 7.6, 9.0, 4, traced=True)])
    return spans


def _line(epoch, cycle, idle, chunk_s, steps, val_s, **kw) -> dict:
    line = {"epoch": epoch, "cycle_seconds": cycle,
            "device_busy_seconds": cycle - idle, "device_idle_seconds": idle,
            "idle_by_span": {}, "host_seconds": {},
            "device_seconds": {CHUNK: chunk_s, "eval.pass": val_s},
            "steps": steps, "counters": {"graphs.host_launches": 0},
            "traced": False}
    line.update(kw)
    return line


def _epochs() -> Spans:
    """Epochs 1-6 of a run; the readers take 4 … 6."""
    spans = Spans()
    spans.epochs.extend([
        _line(1, 9.0, 5.0, 1.5, 182, 0.1, traced=True),
        _line(2, 9.0, 5.0, 1.5, 182, 0.1, traced=True),
        _line(3, 8.0, 5.0, 1.5, 182, 0.1,
              counters={"graphs.host_launches": 182}),
        _line(4, 1.7, 0.10, 1.55, 180.0, 0.03),
        _line(5, 1.8, 0.20, 1.56, 182.0, 0.04),
        _line(6, 1.5, 0.30, 1.10, 130.0, 0.05)])
    return spans


def test_every_reader_is_none_on_the_cpu():
    """The process's own registry on the CPU holds no device time (its
    records, if any, are host spans): every reader returns None."""
    ctx = _ctx(window={"steps": 30, "seconds": 1.0}, epochs=6,
               trainer={"epochs": 3})
    for name in READERS:
        assert harness.metric_reader(name)(ctx) is None, name
        assert _metric(name).read(ctx, Spans()) is None, name


def test_dispatch_readers_read_the_untraced_window():
    spans, ctx = _steady(), _ctx(window={"steps": 30, "seconds": 3.5})
    # 3.5 s from the first start to the last end, 0.5 s of it idle
    assert _metric("dispatch.device_idle_share").read(ctx, spans) == \
        pytest.approx(100 * 0.5 / 3.5)
    assert _metric("dispatch.host_ms").read(ctx, spans) == pytest.approx(12.0)
    # steps that no run of whole untraced chunks sums to
    for steps in (25, 50):
        ctx = _ctx(window={"steps": steps, "seconds": 1.0})
        assert _metric("dispatch.device_idle_share").read(ctx, spans) is None
        assert _metric("dispatch.host_ms").read(ctx, spans) is None


def test_trainer_readers_read_the_epochs_of_trainer_tail_s():
    spans, ctx = _epochs(), _ctx(epochs=6, trainer={"epochs": 3})
    assert _metric("trainer.device_idle_share").read(ctx, spans) == \
        pytest.approx(100 * 0.6 / 5.0)
    assert _metric("trainer.val_device_s").read(ctx, spans) == \
        pytest.approx(0.04)
    assert _metric("trainer.step_device_ms").read(ctx, spans) == \
        pytest.approx(1e3 * 4.21 / 492.0)


@pytest.mark.parametrize("first", [1, 3])
def test_trainer_readers_refuse_traced_or_host_launched_epochs(first):
    """An epoch traced (1, 2) or with host launches (3) among those read:
    None, as where an epoch has no line."""
    spans = _epochs()
    for ctx in (_ctx(epochs=6, trainer={"epochs": 7 - first}),
                _ctx(epochs=7, trainer={"epochs": 3})):
        for name in READERS[2:]:
            assert _metric(name).read(ctx, spans) is None, name
