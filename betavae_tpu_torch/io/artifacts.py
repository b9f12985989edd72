"""Run-directory artifacts: output directories, checkpoint paths, PNG grids.

The port's own copy of the parts of ``betavae_tpu/io/artifacts.py`` that
training writes through: ``ensure_dirs``, ``model_checkpoint_path``
(``<models_dir>/<run_id>_<tag>.pt``) and the image-grid writer, whose
layout is torchvision ``make_grid``'s as the trainer calls it (``nrow``
images per row, 2 px of zero padding, ``normalize`` over the whole grid's
min and max).
"""

from __future__ import annotations

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
