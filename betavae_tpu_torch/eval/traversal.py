"""Latent traversals: per-dimension sweeps and class-direction sweeps.

The port's own copy of ``betavae_tpu/eval/traversal.py``:

- :func:`latent_traversal`: the first image's μ swept one dimension at a
  time over ``linspace(-span, span, steps)``; the dims default to
  ``inference.traversal_latent_indices``, else the first ``min(latent_dim,
  4)``; one PNG row per dim, ``traversal_dim{d}.png``,
- :func:`run_traversals`: class directions from ``latent_usage.csv``'s
  ``logreg_weight_*`` columns where the analysis CLI wrote them, else from
  a logistic regression fitted on the test latents now; sweeps ``μ +
  v·dir`` → ``traversal_tumor_{class}.png``, classes whose name holds
  "notumor" left out; ``images_override`` (one user image, as
  ``scripts/traverse_image.py`` passes it) takes the first test image's
  place.

A whole sweep decodes in one call.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

from ..config import get_config
from ..io.artifacts import save_image_grid
from ..models.beta_vae import BetaVAEModule, decode_latents, encode_split
from .probes import fit_logistic
from .recon_metrics import extract_latents


def _render_sweep(model: BetaVAEModule, zs: np.ndarray, png_path: str,
                  steps: int) -> None:
    """Decode a ``(steps, D)`` latent stack in one call and save the
    strip."""
    save_image_grid(decode_latents(model, zs), png_path, nrow=steps,
                    normalize=True)


def _default_dims(model: BetaVAEModule) -> list:
    cfg = get_config()
    configured = list(cfg.inference.traversal_latent_indices or [])
    return configured or list(range(min(model.latent_dim, 4)))


def latent_traversal(model: BetaVAEModule, images, out_dir, indices=None,
                     steps=None, span=3.0) -> None:
    cfg = get_config()
    if steps is None:
        steps = int(cfg.evaluation.traversal_steps)
    dims = _default_dims(model) if indices is None else indices
    anchor = encode_split(model, images[:1], 1)[0]
    sweep_vals = np.linspace(-span, span, steps)
    os.makedirs(out_dir, exist_ok=True)
    for dim in dims:
        zs = np.repeat(anchor, steps, axis=0)
        zs[:, dim] = sweep_vals
        _render_sweep(model, zs,
                      os.path.join(out_dir, f"traversal_dim{dim}.png"), steps)


def _unit(vec: np.ndarray):
    norm = np.linalg.norm(vec)
    return vec / norm if norm > 0 else None


def _directions_from_usage_csv(tables_dir) -> dict:
    """Per-class probe directions read back from ``latent_usage.csv``; the
    ``logreg_weight_maxabs`` summary column is not a class direction."""
    usage_path = Path(tables_dir) / "latent_usage.csv"
    if not usage_path.exists():
        return {}
    with open(usage_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    out = {}
    for col in rows[0]:
        if not col.startswith("logreg_weight_") or \
                col == "logreg_weight_maxabs":
            continue
        u = _unit(np.array([float(r[col]) for r in rows], np.float32))
        if u is not None:
            out[col[len("logreg_weight_"):]] = u
    return out


def _directions_from_fresh_probe(model: BetaVAEModule, test_ds) -> dict:
    """A logistic regression fitted on the test latents now, one unit
    direction per class."""
    L, y, _ = extract_latents(model, test_ds)
    if len(y) < 2 or len(np.unique(y)) < 2:
        return {}
    clf = fit_logistic(L, y)
    out = {}
    for row, cls in zip(np.atleast_2d(clf.coef_), clf.classes_):
        u = _unit(row)
        if u is not None:
            name = test_ds.idx_to_class.get(cls, f"class{cls}")
            out[name] = u.astype(np.float32)
    return out


def run_traversals(model: BetaVAEModule, test_ds, indices=None, steps=None,
                   span=3.0, images_override=None) -> None:
    """The sweeps around the first test image, or around the first of
    ``images_override`` (float ``(N, H, W, C)`` in [0, 1]) where given."""
    cfg = get_config()
    out_dir = cfg.paths.figures_dir

    class_dirs = _directions_from_usage_csv(cfg.paths.tables_dir)
    if not class_dirs:
        class_dirs = _directions_from_fresh_probe(model, test_ds)

    if images_override is not None:
        imgs = np.asarray(images_override, np.float32)[:1]
    elif len(test_ds) > 0:
        imgs = test_ds.images[:1]
    else:
        return

    latent_traversal(model, imgs, out_dir, indices=indices, steps=steps,
                     span=span)

    tumor_dirs = {name: d for name, d in class_dirs.items()
                  if "notumor" not in name.lower()}
    if not tumor_dirs:
        return
    if steps is None:
        steps = int(cfg.evaluation.traversal_steps)
    anchor = encode_split(model, imgs[:1], 1)[0]
    sweep_vals = np.linspace(-span, span, steps)
    for cls_name, direction in tumor_dirs.items():
        zs = anchor + sweep_vals[:, None] * direction[None, :]
        _render_sweep(model, zs, os.path.join(
            out_dir, f"traversal_tumor_{cls_name}.png"), steps)
