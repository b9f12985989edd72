"""Whole runs of the harness on the CPU at the tiny cell's size (the look
for a card skipped): the result line, a cell and a metric added from files
alone, the faults the training cells can have, the control, and the check
that nothing of JAX is loaded."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import check, harness
from benchmark.tests import tiny

BENCH = Path(__file__).resolve().parent.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(layout, capsys, trace):
    rc, line = tiny.run(*layout, capsys, trace=trace)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in line) == bool(trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["checks"]) == {"loss1", "grad", "change_median"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    dev = line["device"]
    assert dev["count"] == 1 and "memory_peak_bytes" in dev
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        # no device on the CPU: no roofline, and no peak for step.mfu
        assert set(line["metrics"]) == {"device.idle_share.step"}
        assert line["attempted"] > 16  # the window, then the traced chunk
    else:
        assert set(line["metrics"]) == {"step_images_per_sec",
                                        "peak_mem_gib", "setup_s"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_epochs_result_line(layout, capsys, trace):
    """``train()`` over whole epochs: on the CPU every step is fed as the
    seed says, and the reference follows the trainer's first step and
    checkpoint bitwise, the rest to rounding."""
    rc, line = tiny.run(*layout, capsys, trace=trace, cell=tiny.EPOCHS)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert list(line["checks"]) == ["feed", "loss1", "loss_median", "val",
                                    "latest"]
    checks = {k: c["value"] for k, c in line["checks"].items()}
    assert checks["feed"] == 0.0
    assert checks["loss1"] == 0.0 and checks["latest"] == 0.0
    assert checks["loss_median"] < 1e-5 and checks["val"] < 1e-5
    # epochs W + 1 … E of E = W + 4, 8 steps of 8 images each
    assert line["attempted"] == 32
    if trace:
        assert set(line["metrics"]) == {"trainer.tail_s",
                                        "trainer.train_images_per_sec"}
        assert line["metrics"]["trainer.train_images_per_sec"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"epoch_images_per_sec",
                                        "peak_mem_gib", "setup_s"}


def test_a_cell_and_a_metric_from_new_files(tmp_path, capsys):
    """A new configuration, traffic mix, cell and per-layer metric: new
    files and new entries in BENCHMARK.json, no file that is there
    edited."""
    root, bench = tiny.make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (bench / "configs" / "tiny2.yaml").write_text(
        (bench / "configs" / "tiny.yaml").read_text())
    spec["configs"].append({"name": "tiny2", "source": "test",
                            "file": "benchmark/configs/tiny2.yaml",
                            "reduced": [], "why": "test"})
    traffic = json.loads((bench / "traffic" / "tiny.json").read_text())
    traffic["images"] = 32
    (bench / "traffic" / "small.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": "tiny2.small", "config": "tiny2",
                              "traffic": "small", "chips": 1, "why": "t"})
    (bench / "workloads" / "tiny2.small.json").write_text(
        (bench / "workloads" / f"{tiny.CELL}.json").read_text())
    spec["end_to_end"][0]["workloads"].append("tiny2.small")
    (bench / "metrics" / "steps.traced.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    spec["per_layer"].append({"name": "steps.traced", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "dispatch", "moves": spec[
                                  "end_to_end"][0]["name"],
                              "workloads": ["tiny2.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = tiny.run(root, bench, capsys, trace=1, cell="tiny2.small")
    assert rc == 0 and line["correct"] is True
    # the traced chunk: trace_images 16 over a batch of 8
    assert line["metrics"]["steps.traced"]["value"] == 2


@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell in (tiny.CELL, tiny.EPOCHS)
    for fault in ("unchanged", "half_batch")] + [
    (tiny.EPOCHS, "stale_order"), (tiny.EPOCHS, "stale_schedule")])
def test_a_broken_step_is_not_correct(layout, capsys, fault, cell):
    """Each fault fails a number; a later epoch fed the previous epoch's
    shuffle or learning rate fails the feed, which the first steps, the
    validation pass and the checkpoint cannot see."""
    rc, line = tiny.run(*layout, capsys, fault=fault, cell=cell)
    assert rc == 0
    assert line["correct"] is False
    failing = {k for k, c in line["checks"].items()
               if c["value"] == "inf" or c["value"] > c["limit"]}
    assert failing
    if fault.startswith("stale"):
        assert failing == {"feed"}


def test_the_control_is_not_correct(layout):
    """The plain reference with fp8 operands in the program's place fails
    the cell's limits; the reference itself passes them."""
    root, bench = layout
    cell = harness.load_cell(root, tiny.CELL, bench)
    drive = harness.runner(cell.traffic["runner"], bench)
    for seed in (11, 12, 13):
        r = drive.Steady(cell, seed, torch.device("cpu"))
        r.make_inputs()
        ref = r.reference_readings()
        ok, _ = check.judge(check.numbers(r.reference_readings("fp8"), ref),
                            cell.limits)
        assert not ok
        ok, _ = check.judge(check.numbers(ref, ref), cell.limits)
        assert ok


def test_the_epochs_control_is_not_correct(layout):
    """The epochs cell: the reference with fp8 operands in the program's
    place, from the trainer's start and on its final state, fails the
    cell's limits."""
    root, bench = layout
    cell = harness.load_cell(root, tiny.EPOCHS, bench)
    drive = harness.runner(cell.traffic["runner"], bench)
    r = drive.Epochs(cell, 1_618_033_988, torch.device("cpu"))
    try:
        r.prepare(0.5)
        r.train()
        prog = r.program_readings()
        r.release()
        ref = r.reference_readings(prog)
        fp8 = r.reference_readings(prog, "fp8")
        feed = r.feed()["feed"]
    finally:
        r.close()
    fp8["latest"] = ref["latest"]
    assert feed == 0.0
    assert check.judge({**drive.numbers(prog, ref), "feed": feed},
                       cell.limits)[0]
    assert not check.judge({**drive.numbers(fp8, ref), "feed": feed},
                           cell.limits)[0]


def test_the_reference_follows_the_program_in_fp32(tmp_path):
    """At fp32 and a tiny size the plain reference and the program's
    first three steps agree to rounding."""
    root, bench = tiny.make_root(tmp_path, mixed_precision=False)
    cell = harness.load_cell(root, tiny.CELL, bench)
    drive = harness.runner(cell.traffic["runner"], bench)
    r = drive.Steady(cell, 3_141_592_653, torch.device("cpu"))
    try:
        r.setup()
    finally:
        r.close()
    n = check.numbers(r.readings, r.reference_readings())
    assert n["loss1"] < 1e-6 and n["loss"] < 1e-5
    assert n["grad"] < 1e-5 and n["change"] < 1e-3


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "betavae_tpu_torch.fake", object())
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "betavae_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.loaded_forbidden() == ["betavae_tpu", "jaxlib"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_no_program():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "betavae_tpu_torch" not in tops, path


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder alone
    prints no result and exits with another code than 0."""
    import shutil

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns(
        "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flagship.steady",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
