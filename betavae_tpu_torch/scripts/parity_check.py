"""Metric parity of this run's ``metrics_summary.csv`` against a reference.

``python -m betavae_tpu_torch.scripts.parity_check --reference-tables DIR
[--config CONFIG] [--run-eval] [--rtol-recon R] [--rtol-std R]
[--atol-loose A] [--device cuda|cpu]``, the port's
``scripts/parity_check.py``: with ``--run-eval`` the port's
``eval/run_evaluation.py`` runs first (on the card by default; it raises
without a GPU), then ``<tables_dir>/metrics_summary.csv`` is held to
``DIR/metrics_summary.csv`` by ``eval/parity.py::compare_metrics`` and the
report printed.  Returns (and exits with) 0 at parity, 1 on any FAIL or
MISSING row.
"""

from __future__ import annotations

import argparse
import os

from ..config import get_config
from ..eval.parity import compare_metrics, format_report, load_metrics_csv


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.parity_check",
        description="Diff our metrics_summary.csv against a reference run")
    parser.add_argument("--reference-tables", required=True,
                        help="reference tables dir (metrics_summary.csv)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--run-eval", action="store_true",
                        help="run our full evaluation first")
    parser.add_argument("--rtol-recon", type=float, default=0.05)
    parser.add_argument("--rtol-std", type=float, default=0.25)
    parser.add_argument("--atol-loose", type=float, default=0.05)
    parser.add_argument("--device", default="cuda",
                        help="the evaluation's device, with --run-eval")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    if args.run_eval:
        from ..eval.run_evaluation import main as eval_main

        eval_argv = ["--device", args.device]
        if args.config:
            eval_argv += ["--config", args.config]
        eval_main(eval_argv)

    ours_csv = os.path.join(cfg.paths.tables_dir, "metrics_summary.csv")
    ref_csv = os.path.join(args.reference_tables, "metrics_summary.csv")
    result = compare_metrics(
        load_metrics_csv(ref_csv), load_metrics_csv(ours_csv),
        rtol_recon=args.rtol_recon, rtol_std=args.rtol_std,
        atol_loose=args.atol_loose)
    print(format_report(result))
    return 0 if result["parity"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
