"""Rotating 3-D latent-embedding GIF and traversal grid from saved PNGs.

``python -m betavae_tpu_torch.scripts.generate_umap_and_grid [--config
CONFIG] [--weights best] [--frames 60] [--skip-gif] [--skip-grid]
[--device cuda|cpu]``, the port's ``scripts/generate_umap_and_grid.py``:

- :func:`make_umap_gif`: the test split's latents (``evaluation.
  num_umap_samples`` of them, from ``--weights``) reduced to 3 components,
  a scatter coloured by class (tab10, a legend for up to 10 classes)
  rotating through ``frames`` azimuths at 30° elevation, written as
  ``umap3d.gif`` (80 ms a frame, looping).  umap-learn is absent, so the
  reduction is PCA, the JAX package's own fallback;
- :func:`make_traversal_grid`: every ``traversal_*.png`` of the figures
  directory cut into 7 columns (:func:`split_image_into_columns`, the JAX
  script's arithmetic), one row a file, the column titles above and the
  file's stem left of each row, as ``traversal_grid.png``.

Both are drawn with PIL (``eval/plots.py``): the port carries no
matplotlib.  The GIF's encode runs on the card (the default device; it
raises without a GPU unless given ``--device cpu``); the grid is host
work.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

from ..config import get_config
from ..data.dataset import build_datasets
from ..device import resolve_device
from ..eval import plots
from ..eval.latent_viz import reduce_latents
from ..eval.recon_metrics import extract_latents
from ..eval.run_evaluation import load_model

GIF_SIZE = (600, 500)          # the JAX figure's 6 × 5 inches at 100 dpi
CELL = 260                     # a grid cell: 2.6 inches at 100 dpi
AXIS_LABELS = ("UMAP-1", "UMAP-2", "UMAP-3")


def _project(emb: np.ndarray, azim: float, elev: float) -> tuple:
    """Screen ``(x, y, depth)`` of points in the unit cube seen from
    azimuth ``azim`` and elevation ``elev`` (degrees), orthographically;
    ``y`` up, larger depth nearer the viewer."""
    a, e = np.deg2rad(azim), np.deg2rad(elev)
    x, y, z = emb[..., 0], emb[..., 1], emb[..., 2]
    u = -np.sin(a) * x + np.cos(a) * y
    w = np.cos(a) * x + np.sin(a) * y
    v = np.cos(e) * z - np.sin(e) * w
    return u, v, np.cos(e) * w + np.sin(e) * z


def _unit_cube(emb: np.ndarray) -> np.ndarray:
    lo, hi = emb.min(axis=0), emb.max(axis=0)
    return 2.0 * (emb - lo) / np.where(hi > lo, hi - lo, 1.0) - 1.0


def _frame(cube: np.ndarray, colors: list, azim: float, elev: float,
           legend: list) -> Image.Image:
    w, h = GIF_SIZE
    img = Image.new("RGB", GIF_SIZE, "white")
    draw = ImageDraw.Draw(img)
    scale, cx, cy = 0.27 * min(w, h), w / 2, h / 2 + 10

    def px(u, v):
        return cx + scale * u, cy - scale * v

    corners = np.array([[i, j, k] for i in (-1, 1) for j in (-1, 1)
                        for k in (-1, 1)], np.float64)
    cu, cv, _ = _project(corners, azim, elev)
    for a in range(8):
        for b in range(a + 1, 8):
            if np.abs(corners[a] - corners[b]).sum() == 2:
                draw.line([px(cu[a], cv[a]), px(cu[b], cv[b])],
                          fill="#c8c8c8")
    for axis, label in enumerate(AXIS_LABELS):
        end = np.full(3, -1.0)
        end[axis] = 1.25
        eu, ev, _ = _project(end, azim, elev)
        plots.centered_text(draw, px(eu, ev), label)
    u, v, depth = _project(cube, azim, elev)
    for i in np.argsort(depth):
        x, y = px(u[i], v[i])
        draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=colors[i])
    for k, (name, color) in enumerate(legend):
        y = 12 + 14 * k
        draw.ellipse([w - 120, y, w - 112, y + 8], fill=color)
        draw.text((w - 106, y - 2), name, fill="black", font=plots.font())
    if legend:
        draw.text((w - 120, 12 + 14 * len(legend)), "class", fill="gray",
                  font=plots.font())
    return img


def make_umap_gif(latents, labels, out_path, frames: int = 60,
                  elev: float = 30, class_names=None) -> Path:
    """The rotating 3-D scatter of ``latents``' 3-component reduction."""
    emb = reduce_latents(latents, method="umap", n_components=3)
    cube = _unit_cube(np.asarray(emb, np.float64))
    colors = [plots.TAB10[int(lbl) % 10] for lbl in labels]
    uniq = np.unique(labels)
    legend = ([(class_names.get(int(c), str(c)) if class_names else str(c),
                plots.TAB10[int(c) % 10]) for c in uniq]
              if len(uniq) <= 10 else [])
    images = [_frame(cube, colors, azim, elev, legend)
              for azim in np.linspace(0, 360, frames, endpoint=False)]
    images[0].save(out_path, save_all=True, append_images=images[1:],
                   duration=80, loop=0)
    return Path(out_path)


def split_image_into_columns(img: Image.Image,
                             num_cols: int = 7) -> list:
    """``img`` cut into ``num_cols`` full-height columns at
    ``round(i·w / num_cols)``, the JAX script's edges."""
    w, h = img.size
    cols = []
    for i in range(num_cols):
        left = round(i * w / num_cols)
        right = round((i + 1) * w / num_cols)
        cols.append(img.crop((left, 0, right, h)))
    return cols


def make_traversal_grid(saved_dir, out_path, titles=None,
                        grid_title: str = "Traversal Grid") -> Path:
    """One row a ``traversal_*.png`` of ``saved_dir`` (sorted), one column
    a title, each cell a column of the file in gray, fitted into CELL
    pixels; raises ``FileNotFoundError`` when there is none."""
    saved_dir = Path(saved_dir)
    files = sorted(saved_dir.glob("traversal_*.png"))
    if not files:
        raise FileNotFoundError(f"No traversal PNGs found in {saved_dir}")
    titles = titles or ["-3", "-2", "-1", "0", "+1", "+2", "+3"]
    label_w, title_h, head_h = 180, 24, 36
    grid = Image.new("RGB", (label_w + CELL * len(titles),
                             head_h + title_h + CELL * len(files)), "white")
    draw = ImageDraw.Draw(grid)
    plots.centered_text(draw, (grid.width / 2, head_h / 2), grid_title)
    for c, title in enumerate(titles):
        plots.centered_text(draw, (label_w + CELL * (c + 0.5),
                                   head_h + title_h / 2), title)
    for r, f in enumerate(files):
        top = head_h + title_h + CELL * r
        plots.centered_text(draw, (label_w / 2, top + CELL / 2), f.stem)
        with Image.open(f) as img:
            columns = split_image_into_columns(img, len(titles))
        for c, col in enumerate(columns):
            col = col.convert("L")
            fit = min((CELL - 8) / col.width, (CELL - 8) / col.height)
            col = col.resize((max(1, round(col.width * fit)),
                              max(1, round(col.height * fit))))
            left = label_w + CELL * c + (CELL - col.width) // 2
            grid.paste(col.convert("RGB"),
                       (left, top + (CELL - col.height) // 2))
    grid.save(out_path)
    return Path(out_path)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.generate_umap_and_grid",
        description="Generate rotating 3-D latent GIF and traversal grid.")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--weights", type=str, default="best")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--skip-gif", action="store_true")
    parser.add_argument("--skip-grid", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    figures_dir = Path(cfg.paths.figures_dir)
    figures_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    if not args.skip_gif:
        device = resolve_device(args.device)
        _, test_ds = build_datasets()
        model = load_model(args.weights, device=device)
        latents, labels, _ = extract_latents(
            model, test_ds, limit=int(cfg.evaluation.num_umap_samples))
        written["gif"] = make_umap_gif(latents, labels,
                                       figures_dir / "umap3d.gif",
                                       frames=args.frames,
                                       class_names=test_ds.idx_to_class)
        print(f"Saved rotating 3-D GIF to {written['gif']}")
    if not args.skip_grid:
        try:
            written["grid"] = make_traversal_grid(
                figures_dir, figures_dir / "traversal_grid.png")
            print(f"Saved traversal grid to {written['grid']}")
        except FileNotFoundError as e:
            print(f"Skipping grid: {e}")
    return written


if __name__ == "__main__":
    main()
