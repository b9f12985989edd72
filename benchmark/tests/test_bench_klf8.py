"""Whole runs of the harness on the CPU for the autoencoder's runner
(``runners/klf8.py``) at a tiny size of ``klf8``'s configuration (32 px,
``ch`` 32, ``ch_mult`` [1, 2], one res block, 32 groups, batch 4, chunks of
4 over 32 images): the result line, the faults and the control.

The limits are this size's own (:data:`LIMITS`), not the cell's: the
CPU's bf16 autocast rounds elsewhere than the card's, and at this size
the program and the reference part by up to 2.7e-4 in ``loss1``, 0.096 in
``grad`` and 5.0e-3 in ``change_median`` over four seeds, the fp8 control
by at least 2.5e-3, 0.14 and 9.7e-3, the planted faults by 5e-6 / 1.5e-2,
0.89 / 1 and 3.6e-2 / 1 (readings on the CPU, torch 2.13)."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch
import yaml

from benchmark import check, harness

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELL = "tinykl.steady"
# the control fails loss1, a fault grad and change_median
LIMITS = {"loss1": 1e-3, "grad": 0.3, "change_median": 0.02}


def make_root(tmp: Path) -> tuple:
    """``(root, bench_dir)``: ``BENCHMARK.json`` with the tiny cell added
    to every metric that lists ``klf8.steady``, and a copy of the
    benchmark's folder with the tiny configuration, traffic and limits."""
    root = tmp / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = yaml.safe_load((bench / "configs" / "klf8.yaml").read_text())
    cfg["data"]["image_size"] = 32
    cfg["model"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                        latent_dim=4 * 16 * 16)
    cfg["training"].update(batch_size=4, scan_chunk_steps=4)
    (bench / "configs" / "tinykl.yaml").write_text(yaml.safe_dump(cfg))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinykl", "source": "test",
                            "file": "benchmark/configs/tinykl.yaml",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tinykl",
                              "traffic": "tinykl", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "klf8.steady" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((bench / "traffic" / "steady_klf8.json").read_text())
    traffic.update(images=32, warmup_seconds=0.2, trace_images=8)
    (bench / "traffic" / "tinykl.json").write_text(json.dumps(traffic))
    (bench / "workloads" / f"{CELL}.json").write_text(
        json.dumps({"limits": LIMITS}))
    return root, bench


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("benchkl"))


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
    rc, line = run(*layout, capsys, trace=trace)
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"loss1", "grad", "change_median"}
    if trace:
        # no device on the CPU: no peak, so no MFU or roofline
        assert line["metrics"] == {}
        # the window (at least one chunk of 4), then the traced chunk of 2
        assert line["attempted"] >= 6
    else:
        assert set(line["metrics"]) == {"step_images_per_sec",
                                        "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(layout, capsys, fault):
    rc, line = run(*layout, capsys, fault=fault)
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"]
               for c in line["checks"].values())


def test_the_control_is_not_correct(layout):
    """The plain reference with fp8 operands in the program's place fails
    the cell's limits; the reference itself passes them."""
    root, bench = layout
    cell = harness.load_cell(root, CELL, bench)
    drive = harness.runner(cell.traffic["runner"], bench)
    for seed in (11, 12):
        r = drive.Steady(cell, seed, torch.device("cpu"))
        r.make_inputs()
        ref = r.reference_readings()
        ok, _ = check.judge(check.numbers(r.reference_readings("fp8"), ref),
                            cell.limits)
        assert not ok
        assert check.judge(check.numbers(ref, ref), cell.limits)[0]


def test_a_program_without_the_autoencoder_fails_before_it_makes_anything(
        layout, monkeypatch):
    """Set-up imports the program's autoencoder first: where it is
    missing, the run raises before any image or model is made."""
    import sys

    root, bench = layout
    cell = harness.load_cell(root, CELL, bench)
    drive = harness.runner(cell.traffic["runner"], bench)
    monkeypatch.setitem(sys.modules, "betavae_tpu_torch.models.autoencoder_kl",
                        None)
    r = drive.Steady(cell, 5, torch.device("cpu"))
    with pytest.raises(ImportError):
        r.setup()
    assert not hasattr(r, "images") and not hasattr(r, "model")
