"""Render the first validation batch, so the seeded order can be diffed.

``python -m betavae_tpu_torch.scripts.preview_val_batch [--config
CONFIG]``, the port's ``scripts/preview_val_batch.py``: the first
``training.batch_size`` test images as ``val_preview_seed{seed}.png`` (up
to 8 a row, normalised over the grid) and ``val_preview_seed{seed}_paths.txt``,
one ``{i}: class=... path=...`` line a sample, under ``paths.figures_dir``.
Two runs, or a run of either package, give equal manifests when the order
is a function of ``data.seed``.  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import get_config
from ..data.dataset import build_datasets
from ..io.artifacts import ensure_dirs, save_image_grid


def _write_manifest(path: Path, ds, count: int) -> None:
    lines = (f"{i}: class={ds.class_names[i]} path={ds.paths[i]}\n"
             for i in range(count))
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(lines)


def main(argv=None) -> tuple:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.preview_val_batch",
        description="Render the first val batch for determinism checks.")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config to activate for this run.")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    ensure_dirs()
    _, test_ds = build_datasets()

    imgs = test_ds.images[: int(cfg.training.batch_size)].astype(
        np.float32) / 255.0
    out_dir = Path(cfg.paths.figures_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    stem = f"val_preview_seed{cfg.data.seed}"
    grid_path = out_dir / f"{stem}.png"
    save_image_grid(imgs, str(grid_path), nrow=min(len(imgs), 8),
                    normalize=True)
    meta_path = out_dir / f"{stem}_paths.txt"
    _write_manifest(meta_path, test_ds, imgs.shape[0])

    print(f"Val-batch grid: {grid_path}")
    print(f"Val-batch paths/classes: {meta_path}")
    return grid_path, meta_path


if __name__ == "__main__":
    main()
