"""On the card (marked ``cuda``; skipped where there is none): the control
at each steady cell's own size, on three seeds, fails the cell's limits,
and the reference passes against itself.

    python -m pytest --noconftest benchmark/tests/test_bench_card.py -q
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark import check, harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship.steady", "scaled.steady"])
def test_control_at_the_cells_size_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell(ROOT, cell)
    drive = harness.runner(c.traffic["runner"])
    for seed in (2_900_000_001, 2_900_000_002, 2_900_000_003):
        r = drive.Steady(c, seed, torch.device("cuda"))
        r.make_inputs()
        ref = r.reference_readings()
        ok, checks = check.judge(
            check.numbers(r.reference_readings("fp8"), ref), c.limits)
        assert not ok, checks
        del r
        torch.cuda.empty_cache()
