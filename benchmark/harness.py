"""What every run of the benchmark shares: the cell's files found by name,
the caches, the look for a card, the per-layer readers, the check that
nothing of JAX was loaded, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the harness finds

- the configuration's file by its ``file`` in ``BENCHMARK.json``;
- the traffic mix in ``benchmark/traffic/<traffic>.json``, whose ``runner``
  names the module ``benchmark/runners/<runner>.py`` that drives it;
- the cell's limits of ``correct`` in ``benchmark/workloads/<cell>.json``;
- each per-layer metric's reader in ``benchmark/metrics/<metric>.py``, a
  function ``read(ctx)`` that returns the number or None.

So a cell, a configuration, a traffic mix or a metric is added by adding
files and entries, with no edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass
from pathlib import Path

import yaml

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "betavae_tpu")
# kernel and build caches: fixed directories inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def set_caches(root: Path) -> None:
    base = root / "build" / "bench_cache"
    for var, sub in CACHES.items():
        os.environ[var] = str(base / sub)


@dataclass
class Cell:
    """A cell's entry, its configuration (file and contents), its traffic
    mix, its limits of ``correct``, and the metrics it reports."""
    name: str
    chips: int
    config_path: Path
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config_path = root / conf["file"]
    cfg = yaml.safe_load(config_path.read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench_dir / "workloads" / f"{name}.json")
                        .read_text())["limits"]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    # every per-layer metric lists the cells it is read in
    layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]), config_path=config_path,
                cfg=cfg, traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(name: str, bench_dir: Path = HERE):
    """The module ``runners/<name>.py``, which drives a traffic mix."""
    return _load(bench_dir / "runners" / f"{name}.py",
                 f"benchmark.runners.{name}")


def metric_reader(name: str, bench_dir: Path = HERE):
    return _load(bench_dir / "metrics" / f"{name}.py",
                 f"benchmark.metrics.{name.replace('.', '_')}").read


def card_problem(chips: int) -> str | None:
    """Why the run cannot measure (no CUDA, too few cards), or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    return None


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def bytes_written() -> dict:
    """What this process has written, where the OS says: ``wchar`` the
    bytes handed to ``write()``, ``write_bytes`` those sent to storage."""
    try:
        with open("/proc/self/io") as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
    except OSError:
        return {}
    return {k: int(fields[k]) for k in ("wchar", "write_bytes")
            if k in fields}


@dataclass
class Ctx:
    """What a per-layer reader gets: the trace of the traced window, the
    steps in it, the configuration and its sizes, the card's peaks (None
    for a card the table does not know) and the runner's counters."""
    trace: object
    steps: int
    batch: int
    cfg: dict
    sizes: dict
    peaks: dict | None
    counters: dict


def per_layer(cell: Cell, ctx: Ctx, bench_dir: Path = HERE) -> dict:
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"], bench_dir)(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)
