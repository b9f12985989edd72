"""Plot a run's train and val total losses from its METRICS log (thin CLI).

``python -m betavae_tpu_torch.scripts.plot_phase_losses [--config CONFIG]
[--log PATH] [--out PATH]``, the port's ``scripts/plot_phase_losses.py``:
``eval/logs.py::phase_losses_figure`` (the first 7 train points dropped,
val epochs × 180 where val records carry no step), by default from
``<outputs_dir>/logs/<run_id>.log`` to ``<figures_dir>/<run_id>_losses.png``.
Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import get_config
from ..eval.logs import parse_metrics, phase_losses_figure


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.plot_phase_losses",
        description="Plot train/val losses from log.")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to YAML config (sets run_id).")
    parser.add_argument("--log", type=str, default=None,
                        help="Override log path.")
    parser.add_argument("--out", type=str, default=None,
                        help="Override output figure path.")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    log_path = (Path(args.log) if args.log else
                Path(cfg.paths.outputs_dir) / "logs" / f"{cfg.paths.run_id}.log")
    out_path = (Path(args.out) if args.out else
                Path(cfg.paths.figures_dir) / f"{cfg.paths.run_id}_losses.png")
    fig = phase_losses_figure(parse_metrics(log_path))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.save(out_path)
    print(f"Saved plot to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
