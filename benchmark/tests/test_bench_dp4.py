"""Whole runs of the harness on the CPU for the data-parallel runner
(``runners/dp4.py``): the tiny cell's model (``tiny.py``: 32 px, 2 blocks,
batch 8, chunks of 4 over 64 images) over two gloo ranks, four rows each,
under the flagship's limits, as ``test_bench_run.py`` holds the tiny steady
cell: the result line, the faults and the control.  Each run spawns its
two ranks (~10 s)."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import check, harness
from benchmark.tests import tiny

CELL = "tiny.dp2"


def make_root(tmp: Path) -> tuple:
    """The tiny layout with a cell of the tiny configuration driven by the
    data-parallel runner over two ranks."""
    root, bench = tiny.make_root(tmp)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny",
                              "traffic": "tinydp", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if tiny.CELL in m.get("workloads", []):
            m["workloads"].append(CELL)
        if "scaled.dp4" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((bench / "traffic" / "tiny.json").read_text())
    traffic.update(runner="dp4", ranks=2)
    (bench / "traffic" / "tinydp.json").write_text(json.dumps(traffic))
    (bench / "workloads" / f"{CELL}.json").write_text(
        (bench / "workloads" / f"{tiny.CELL}.json").read_text())
    return root, bench


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("benchdp"))


def run(root: Path, bench: Path, capsys, *, seed: int = 2_718_281_829,
        trace: int = 0, fault=None) -> tuple:
    from benchmark import run as entry

    rc = entry.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                     "0.5", "--trace", str(trace)], device="cpu",
                    fault=fault, root=root, bench_dir=bench,
                    t_start=time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(layout, capsys, trace):
    """Every rank runs the same chunks (an agreed count), rank 0 times
    them and reads the first steps, which the reference of the global
    batch follows."""
    rc, line = run(*layout, capsys, trace=trace)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    if trace:
        assert "device.idle_share.step" in line["metrics"]
        assert "dp.allreduce_share" not in line["metrics"]  # no NCCL here
    else:
        assert set(line["metrics"]) == {"step_images_per_sec",
                                        "peak_mem_gib", "setup_s"}
        assert line["metrics"]["step_images_per_sec"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(layout, capsys, fault):
    rc, line = run(*layout, capsys, fault=fault)
    assert rc == 0 and line["correct"] is False


def test_the_control_is_not_correct(layout):
    """The control needs no rank: the reference of the global batch with
    fp8 operands fails the cell's limits."""
    root, bench = layout
    cell = harness.load_cell(root, CELL, bench)
    drive = harness.runner(cell.traffic["runner"], bench)
    r = drive.Steady(cell, 11, torch.device("cpu"))
    r.make_inputs()
    ref = r.reference_readings()
    assert not check.judge(check.numbers(r.reference_readings("fp8"), ref),
                           cell.limits)[0]
