"""A tiny cell of the flagship's model for the CPU tests: 32 px, 2 blocks,
base 8, latent 8, batch 8, chunks of 4, over 64 images, in a copy of the
benchmark laid out under a temporary root."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import yaml

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELL = "tiny.steady"
EPOCHS = "tiny.epochs"


def tiny_config(mixed_precision: bool = True) -> dict:
    cfg = yaml.safe_load((BENCH / "configs" / "flagship.yaml").read_text())
    cfg["data"]["image_size"] = 32
    cfg["model"].update(base_channels=8, num_blocks=2, latent_dim=8)
    cfg["training"].update(batch_size=8, scan_chunk_steps=4,
                           mixed_precision=mixed_precision)
    return cfg


def make_root(tmp: Path, *, mixed_precision: bool = True,
              limits: dict | None = None) -> tuple:
    """``(root, bench_dir)``: ``BENCHMARK.json`` with the tiny cell added
    to every metric that lists the flagship's steady cell, and a copy of
    the benchmark's folder with the tiny traffic mix and limits."""
    root = tmp / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (bench / "configs" / "tiny.yaml").write_text(
        yaml.safe_dump(tiny_config(mixed_precision)))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.yaml",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tiny",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    spec["workloads"].append({"name": EPOCHS, "config": "tiny",
                              "traffic": "tinyepochs", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "flagship.steady" in m.get("workloads", []):
            m["workloads"].append(CELL)
        if "flagship.epochs" in m.get("workloads", []):
            m["workloads"].append(EPOCHS)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((bench / "traffic" / "steady.json").read_text())
    traffic.update(images=64, warmup_seconds=0.2, trace_images=16)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    cell = json.loads((bench / "workloads" / "flagship.steady.json")
                      .read_text())
    if limits is not None:
        cell["limits"] = limits
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    traffic = json.loads((bench / "traffic" / "epochs.json").read_text())
    # E = W + 4 epochs at 0.5 s: a traced run reads the last two
    traffic.update(train_per_class=16, test_per_class=4, epoch_seconds=0.125)
    (bench / "traffic" / "tinyepochs.json").write_text(json.dumps(traffic))
    cell = json.loads((bench / "workloads" / "flagship.epochs.json")
                      .read_text())
    (bench / "workloads" / f"{EPOCHS}.json").write_text(json.dumps(cell))
    return root, bench


def run(root: Path, bench: Path, capsys, *, seed: int = 2_718_281_829,
        trace: int = 0, fault=None, cell: str = CELL) -> tuple:
    """One run of the harness on the CPU: ``(exit code, result line)``."""
    from benchmark import run as entry

    rc = entry.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "0.5", "--trace", str(trace)], device="cpu",
                    fault=fault, root=root, bench_dir=bench,
                    t_start=time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
