"""Plot the key train-phase metrics of a run's METRICS log (thin CLI).

``python -m betavae_tpu_torch.scripts.plot_logs [--config CONFIG]``, the
port's ``scripts/plot_logs.py``: ``<outputs_dir>/logs/<run_id>.log`` →
``<figures_dir>/<run_id>_train_metrics.png`` through
``eval/logs.py::train_metrics_figure`` (PIL).  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import get_config
from ..eval.logs import parse_metrics, train_metrics_figure


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.plot_logs",
        description="Plot train metrics from log.")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to YAML config.")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    log_path = Path(cfg.paths.outputs_dir) / "logs" / f"{cfg.paths.run_id}.log"
    out_path = (Path(cfg.paths.figures_dir)
                / f"{cfg.paths.run_id}_train_metrics.png")
    fig = train_metrics_figure(parse_metrics(log_path))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.save(out_path)
    print(f"Saved train metrics plot to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
