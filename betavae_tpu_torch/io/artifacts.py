"""Run-directory artifacts: output directories, checkpoint paths, JSON,
CSV tables, PNG figures and grids.

The port's own copy of ``betavae_tpu/io/artifacts.py``: ``ensure_dirs``,
``model_checkpoint_path`` (``<models_dir>/<run_id>_<tag>.pt``),
``save_json`` (``<outputs_dir>/<name>.json``), ``save_table``
(``<tables_dir>/<name>.csv``, written with the stdlib ``csv`` module in the
layout ``pandas.DataFrame.to_csv(index=False)`` gives the JAX package's
tables), ``save_figure`` (a PIL image as ``<figures_dir>/<name>.png``) and
the image-grid writer, whose layout is torchvision ``make_grid``'s as the
trainer calls it (``nrow`` images per row, 2 px of zero padding,
``normalize`` over the whole grid's min and max).
"""

from __future__ import annotations

import csv
import json
import math
import os

import numpy as np

from ..config import get_config


def ensure_dirs() -> None:
    cfg = get_config()
    for key in ("outputs_dir", "models_dir", "figures_dir", "tables_dir"):
        os.makedirs(getattr(cfg.paths, key), exist_ok=True)
    os.makedirs(os.path.join(cfg.paths.outputs_dir, "logs"), exist_ok=True)


def model_checkpoint_path(tag: str) -> str:
    cfg = get_config()
    os.makedirs(cfg.paths.models_dir, exist_ok=True)
    return os.path.join(cfg.paths.models_dir, f"{cfg.paths.run_id}_{tag}.pt")


def save_json(data, name: str) -> str:
    cfg = get_config()
    os.makedirs(cfg.paths.outputs_dir, exist_ok=True)
    out = os.path.join(cfg.paths.outputs_dir, f"{name}.json")
    with open(out, "w") as f:
        json.dump(data, f, indent=2)
    return out


def _cell(value) -> str:
    """One CSV field as pandas writes it: NaN and None empty, numpy
    scalars by their own shortest repr (float32 as float32), anything else
    (lists included) by ``str``."""
    if value is None or (isinstance(value, (float, np.floating))
                         and math.isnan(value)):
        return ""
    return str(value)


def save_table(table, name: str) -> str:
    """Write ``table`` to ``<tables_dir>/<name>.csv``: a ``{column:
    values}`` dict (columns in its order) or a list of row dicts (columns
    in the first row's order)."""
    if isinstance(table, dict):
        columns = list(table)
        rows = zip(*(list(table[c]) for c in columns))
    else:
        columns = list(table[0]) if table else []
        rows = ([row[c] for c in columns] for row in table)
    cfg = get_config()
    os.makedirs(cfg.paths.tables_dir, exist_ok=True)
    path = os.path.join(cfg.paths.tables_dir, f"{name}.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows([_cell(v) for v in row] for row in rows)
    return path


def save_figure(image, name: str) -> str:
    """Write a PIL image to ``<figures_dir>/<name>.png``."""
    cfg = get_config()
    os.makedirs(cfg.paths.figures_dir, exist_ok=True)
    path = os.path.join(cfg.paths.figures_dir, f"{name}.png")
    image.save(path)
    return path


def make_grid(images: np.ndarray, nrow: int = 8,
              normalize: bool = False) -> np.ndarray:
    """Tile ``(N, H, W, C)`` images into one ``(H', W', C)`` grid."""
    padding = 2
    imgs = np.asarray(images, dtype=np.float32)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    if normalize:
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-8)
    ncols = min(nrow, n)
    nrows = int(np.ceil(n / ncols))
    grid = np.full((padding + nrows * (h + padding),
                    padding + ncols * (w + padding), c), 0.0,
                   dtype=np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = imgs[idx]
    return grid


def save_image_grid(images, path: str, nrow: int = 8,
                    normalize: bool = False) -> str:
    """Write an image grid as a PNG (grayscale or RGB)."""
    from PIL import Image

    grid = make_grid(np.asarray(images), nrow=nrow, normalize=normalize)
    arr = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
    # uint8 (H, W) is read as mode L, (H, W, 3) as RGB
    im = Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    im.save(path)
    return path
