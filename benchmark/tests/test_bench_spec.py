"""BENCHMARK.json against the benchmark's contract, and the files each of
its entries is found by."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    n = 24
    assert ((2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200
            <= 43200)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_the_contract_keys(kind, keys):
    for entry in SPEC[kind]:
        assert set(entry) == keys, entry["name"]


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [m["name"] for m in _metrics()]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    assert len({m["name"] for m in _metrics()}) == len(_metrics())


def test_metric_entries_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        # the harness reads a per-layer metric in the cells it lists
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in cells
            assert _reports(moved, cell), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in SPEC["per_layer"])


def test_four_chip_cells_are_at_most_a_quarter():
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_every_entry_finds_its_files():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("benchmark/") and (ROOT / f).is_file()
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                            .read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "runners" / f"{traffic['runner']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
