"""Latent-space figures: the 2-D scatter and the per-dimension violins.

The port's own copy of ``betavae_tpu/eval/latent_viz.py``, drawn with PIL
(``eval/plots.py``):

- :func:`reduce_latents`: ``"umap"`` takes PCA, the JAX package's fallback
  when umap-learn is absent (the port carries no umap); ``"pca"`` is
  scikit-learn's ``PCA.fit_transform`` (``eval/probes.py::pca``);
  ``"tsne"`` raises ``NotImplementedError``: t-SNE is not ported,
- :func:`plot_latent_scatter`: ``latent_scatter.png`` (binary labels in a
  fixed blue/red pair, multiclass in tab10),
- :func:`per_dim_violin`: one violin per class for every latent dimension
  (``scipy.stats.gaussian_kde`` with Scott's bandwidth, matplotlib's
  ``violinplot`` default) → ``latent_per_dim_violin.png``.

:func:`generate_latent_visualizations` keeps the JAX package's guarded
t-SNE call, so ``latent_scatter_tsne.png`` is not written and a warning
says so.  The 3-D scatters, which the JAX package shows on screen and never
saves, are not ported.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw
from scipy.stats import gaussian_kde

from ..config import get_config
from ..io.artifacts import save_figure
from ..logging_utils import init_logger
from . import plots
from .probes import pca
from .recon_metrics import extract_latents


def reduce_latents(latents, method="umap", n_components=2):
    if method in ("umap", "pca"):
        return pca(latents, n_components)
    if method == "tsne":
        raise NotImplementedError("t-SNE is not ported (it needs "
                                  "scikit-learn, which the port does not "
                                  "carry)")
    raise ValueError(f"unknown reduction method {method}")


def _class_series(labels, binary, class_names=None):
    """``[(class_id, display_name, colour), ...]`` for every class to
    draw."""
    if binary:
        return [(0, "0", plots.BINARY_COLORS[0]),
                (1, "1", plots.BINARY_COLORS[1])]
    return [(c, class_names.get(c, str(c)) if class_names else str(c),
             plots.TAB10[i % len(plots.TAB10)])
            for i, c in enumerate(sorted(np.unique(labels)))]


def _span(values: np.ndarray) -> tuple:
    lo, hi = float(np.min(values)), float(np.max(values))
    pad = 0.05 * (hi - lo) or 0.5
    return lo - pad, hi + pad


def plot_latent_scatter(emb, labels, title, binary=True, class_names=None):
    """The 2-D embedding's points coloured by class, with a legend."""
    size, margin = 500, 60
    img = Image.new("RGB", (size + 2 * margin, size + 2 * margin), "white")
    draw = ImageDraw.Draw(img)
    ax = plots.Axes(draw, (margin, margin, margin + size, margin + size),
                    _span(emb[:, 0]), _span(emb[:, 1]), title=title)
    ax.xticks(plots.nice_ticks(*ax.xlim))
    ax.yticks(plots.nice_ticks(*ax.ylim))
    series = _class_series(labels, binary, class_names)
    for i, (cls, cname, color) in enumerate(series):
        pts = emb[labels == cls]
        ax.points(pts[:, 0], pts[:, 1], color)
        y = margin + 8 + 14 * i
        draw.ellipse([margin + size - 110, y, margin + size - 102, y + 8],
                     fill=color)
        draw.text((margin + size - 96, y - 2), cname, fill="black",
                  font=plots.font())
    return img


def per_dim_violin(latents, labels, binary=True):
    """One panel per latent dimension, one violin per class (an empty
    class draws as a zero stub) → ``latent_per_dim_violin.png``."""
    series = _class_series(labels, binary)
    dim_count = latents.shape[1]
    cols = min(4, dim_count)
    rows = -(-dim_count // cols)
    cell_w, cell_h = 240, 190
    img = Image.new("RGB", (cols * cell_w, rows * cell_h), "white")
    draw = ImageDraw.Draw(img)
    for dim in range(dim_count):
        r, c = divmod(dim, cols)
        groups = [latents[labels == cls, dim] for cls, _, _ in series]
        groups = [g if g.size else np.zeros(1) for g in groups]
        box = (c * cell_w + 50, r * cell_h + 24, (c + 1) * cell_w - 10,
               (r + 1) * cell_h - 40)
        ax = plots.Axes(draw, box, (0.5, len(groups) + 0.5),
                        _span(np.concatenate(groups)), title=f"z{dim}")
        ax.yticks(plots.nice_ticks(*ax.ylim, count=3))
        ax.xticks(np.arange(1, len(groups) + 1), [s[1] for s in series])
        for pos, (g, (_, _, color)) in enumerate(zip(groups, series), 1):
            _violin(ax, pos, g, color)
    return save_figure(img, "latent_per_dim_violin")


def _violin(ax: plots.Axes, pos: int, values: np.ndarray, color) -> None:
    """A kernel-density outline of ``values``, half-width 0.4 at its
    peak, centred on ``pos``; a constant group draws as a line."""
    lo, hi = float(values.min()), float(values.max())
    if values.size < 2 or hi <= lo:
        ax.polygon(np.array([pos - 0.4, pos + 0.4]), np.array([lo, lo]),
                   color)
        return
    ys = np.linspace(lo, hi, 64)
    dens = gaussian_kde(values)(ys)
    half = 0.4 * dens / dens.max()
    ax.polygon(np.concatenate([pos - half, (pos + half)[::-1]]),
               np.concatenate([ys, ys[::-1]]), color)


def generate_latent_visualizations(model, test_ds):
    cfg = get_config()
    lim = int(cfg.evaluation.num_umap_samples)
    latents, labels, _ = extract_latents(model, test_ds, limit=lim)
    binary = cfg.data.class_mode == "binary"
    idx_to_class = test_ds.idx_to_class or None
    emb = reduce_latents(latents, method="umap", n_components=2)
    save_figure(plot_latent_scatter(emb, labels, "Latent Scatter (UMAP/PCA)",
                                    binary=binary, class_names=idx_to_class),
                "latent_scatter")
    try:
        emb_tsne = reduce_latents(latents, method="tsne", n_components=2)
        save_figure(plot_latent_scatter(emb_tsne, labels,
                                        "Latent Scatter (t-SNE)",
                                        binary=binary,
                                        class_names=idx_to_class),
                    "latent_scatter_tsne")
    except NotImplementedError as err:
        init_logger().warning("latent_scatter_tsne.png not written: %s", err)
    per_dim_violin(latents, labels, binary)
