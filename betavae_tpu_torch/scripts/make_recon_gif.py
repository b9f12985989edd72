"""Animate the per-epoch recon panels into a GIF (thin CLI).

``python -m betavae_tpu_torch.scripts.make_recon_gif [--config CONFIG]
[--pattern GLOB] [--output NAME] [--duration MS] [--no-crop]
[--include-diff]``, the port's ``scripts/make_recon_gif.py``:
``eval/logs.py::recon_gif`` over ``paths.figures_dir`` (numeric order, the
bottom half of each panel, ``*_diff`` panels left out by default).  Host
only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import get_config
from ..eval.logs import epoch_sort_key, recon_gif


def natural_sort_key(path):
    """The JAX script's name for ``eval/logs.py::epoch_sort_key``."""
    return epoch_sort_key(path)


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.make_recon_gif",
        description="Create GIF from recon panels (bottom half only).")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to YAML config.")
    parser.add_argument("--pattern", type=str, default="recon_epoch*.png",
                        help="Glob pattern within figures_dir.")
    parser.add_argument("--output", type=str, default="recons_only.gif",
                        help="Output GIF filename (saved to figures_dir).")
    parser.add_argument("--duration", type=int, default=200,
                        help="Frame duration (ms).")
    parser.add_argument("--no-crop", action="store_true",
                        help="Do not crop; use full images.")
    parser.add_argument("--include-diff", action="store_true",
                        help="Include *_diff.png files (default: exclude).")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    out = recon_gif(cfg.paths.figures_dir, pattern=args.pattern,
                    output=args.output, duration_ms=args.duration,
                    crop_bottom_half=not args.no_crop,
                    include_diff=args.include_diff)
    print(f"Saved GIF to {out}")
    return out


if __name__ == "__main__":
    main()
