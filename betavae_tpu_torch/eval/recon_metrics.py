"""Full evaluation: reconstruction metrics, probes, traversal validation,
figures.

The port's own copy of ``betavae_tpu/eval/recon_metrics.py``:

- :func:`gather_reconstruction_metrics`: per-image MSE, PSNR and SSIM from
  the *sampling* forward (:func:`..models.beta_vae.sample_forward`, noise
  at ``(data.seed, batch index)``), with per-class means keyed by class
  name,
- :func:`extract_latents`: μ only, limited to
  ``evaluation.num_umap_samples``,
- :func:`logistic_probe`: a seeded shuffle split at
  ``evaluation.probe_train_split``; binary AUC, F1 and confusion, or
  multiclass macro-F1, macro one-vs-rest AUC and per-class F1; a fit split
  of one class reports NaN,
- :func:`compute_probe_directions`, :func:`traversal_probe_validation`
  (``traversal_probe_validation.csv``), the probe-weight heatmap and the
  four-panel original / reconstruction / μ ∓ span·direction figure, the
  silhouette,
- :func:`evaluate_full`: all of it, ``metrics_summary.csv`` and
  ``confusion_matrix.csv``, and one ``phase="eval"`` METRICS line.

scikit-learn, pandas and matplotlib give way to ``eval/probes.py``, the
stdlib ``csv`` module (``io/artifacts.py::save_table``) and PIL
(``eval/plots.py``).  Eager PyTorch takes the ragged last batch as it is,
so no batch is padded.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image, ImageDraw

from ..config import get, get_config
from ..data.dataset import ArrayDataset, images_to_tensor
from ..io.artifacts import save_figure, save_table
from ..logging_utils import log_metrics
from ..models.beta_vae import (BetaVAEModule, decode_latents, encode_split,
                               sample_forward, to_numpy_images)
from ..ops.metrics import batched_image_metrics
from . import plots
from .probes import (binary_auc, confusion_matrix, f1_score, fit_logistic,
                     macro_ovr_auc, silhouette)


def _device(model: BetaVAEModule) -> torch.device:
    return model.fc_mu.weight.device


def gather_reconstruction_metrics(model: BetaVAEModule, test_ds: ArrayDataset,
                                  seed: int | None = None) -> dict:
    """Means and spreads of the per-image metrics, and per-class means and
    counts, over the test split.  Batch ``i`` draws its noise at ``(seed,
    i)``, ``seed`` defaulting to ``data.seed``; the model's
    ``deterministic`` flag (the config's ``deterministic_overfit``) turns
    sampling off, as the reference's bare ``model.forward`` does."""
    cfg = get_config()
    seed = int(cfg.data.seed) if seed is None else int(seed)
    bs = int(cfg.training.batch_size)
    dev = _device(model)
    pending = []
    for i, s in enumerate(range(0, len(test_ds), bs)):
        x = images_to_tensor(test_ds.images[s:s + bs], dev)
        recon = sample_forward(model, x, seed, offset=i)[0]
        pending.append(batched_image_metrics(recon, x))
    per_img = {k: torch.cat([m[k] for m in pending]).cpu().numpy()
               .astype(np.float64) for k in ("mse", "psnr", "ssim")}

    members: dict = {}
    for i, (label, name) in enumerate(zip(test_ds.labels,
                                          test_ds.class_names)):
        cname = name or test_ds.idx_to_class.get(int(label), str(int(label)))
        members.setdefault(cname, []).append(i)
    d = {}
    for k in ("mse", "psnr", "ssim"):
        d[f"{k}_mean"] = float(np.mean(per_img[k]))
        d[f"{k}_std"] = float(np.std(per_img[k]))
    for cname, idx in members.items():
        for k in ("mse", "psnr", "ssim"):
            d[f"per_class/{cname}/{k}_mean"] = float(np.mean(per_img[k][idx]))
        d[f"per_class/{cname}/count"] = len(idx)
    return d


def extract_latents(model: BetaVAEModule, ds: ArrayDataset, limit=None):
    """``(mu (N, D) float32, labels (N,), paths)`` of the first ``limit``
    samples (all when falsy)."""
    cfg = get_config()
    mu, _ = encode_split(model, ds.images, int(cfg.training.batch_size),
                         limit)
    n = len(mu)
    return mu, np.asarray(ds.labels[:n]), list(ds.paths[:n])


def _idx_to_name(class_map) -> dict:
    return {v: k for k, v in class_map.items()} if class_map else {}


def _held_out_split(n: int, train_fraction: float, seed: int):
    """The reference's ``RandomState(seed)`` shuffle, cut at
    ``train_fraction``."""
    order = np.random.RandomState(seed).permutation(n)
    cut = int(train_fraction * n)
    return order[:cut], order[cut:]


def logistic_probe(latents, labels, train_fraction=0.3, seed=42, binary=True,
                   return_model=False):
    """Held-out logistic probe on latent means: binary mode reports AUC
    and F1 at a 0.5 threshold on P(class 1), multiclass macro-F1, macro
    one-vs-rest AUC and per-class F1 on argmax predictions."""
    fit_idx, held_idx = _held_out_split(latents.shape[0], train_fraction, seed)
    y_held = labels[held_idx]
    classes = np.unique(labels)
    try:
        clf = fit_logistic(latents[fit_idx], labels[fit_idx])
    except ValueError:
        # the seeded fit split holds one class (or none): NaN metrics
        nan = float("nan")
        res = ({"probe_auc": nan, "probe_f1": nan} if binary else
               {"probe_macro_f1": nan, "probe_macro_auc": nan})
        only = int(labels[fit_idx][0]) if len(fit_idx) else int(classes[0])
        hard = np.full(len(y_held), only, dtype=labels.dtype)
        res["confusion_matrix"] = confusion_matrix(y_held, hard,
                                                   classes).tolist()
        res["classes"] = classes.tolist()
        if not binary:
            res["per_class_f1"] = [nan] * len(classes)
        return (res, None, classes) if return_model else res
    probs = clf.predict_proba(latents[held_idx])

    res = {}
    if binary:
        hard = (probs[:, 1] >= 0.5).astype(int)
        res["probe_auc"] = binary_auc(y_held, probs[:, 1])
        res["probe_f1"] = f1_score(y_held, hard)
    else:
        hard = np.argmax(probs, axis=1)
        res["probe_macro_f1"] = f1_score(y_held, hard, average="macro")
        try:
            res["probe_macro_auc"] = macro_ovr_auc(y_held, probs)
        except ValueError:
            res["probe_macro_auc"] = float("nan")
    res["confusion_matrix"] = confusion_matrix(y_held, hard, classes).tolist()
    res["classes"] = classes.tolist()
    if not binary:
        res["per_class_f1"] = f1_score(y_held, hard, average=None,
                                       labels=classes).tolist()
    return (res, clf, classes) if return_model else res


def compute_probe_directions(probe_model, class_map=None) -> dict:
    """Unit-norm probe coefficient rows keyed by class name, zero rows
    dropped; rows follow ``probe_model.classes_``, the classes of the fit
    split."""
    if probe_model is None:
        return {}
    coef = np.atleast_2d(probe_model.coef_)
    names = _idx_to_name(class_map)
    norms = np.linalg.norm(coef, axis=1)
    return {names.get(cls, str(cls)): (row / n).astype(np.float32)
            for cls, row, n in zip(probe_model.classes_, coef, norms) if n > 0}


def traversal_probe_validation(probe_model, latents, labels, class_dirs,
                               steps=7, span=3.0, class_map=None):
    """Probe probability along each class direction from the class's mean
    latent, over ``linspace(-span, span, steps)``, every sweep in one
    ``predict_proba`` call → ``traversal_probe_validation.csv``.  Returns
    ``(metrics, rows)``."""
    if probe_model is None or not class_dirs:
        return {}, None
    sweep = np.linspace(-span, span, steps)
    names = _idx_to_name(class_map)
    grand_mean = latents.mean(axis=0)
    work = []
    for pos, cls_id in enumerate(probe_model.classes_):
        cname = names.get(cls_id, str(cls_id))
        direction = class_dirs.get(cname)
        if direction is None:
            continue
        members = latents[labels == cls_id]
        anchor = members.mean(axis=0) if members.size else grand_mean
        work.append((pos, cname, anchor, np.asarray(direction)))
    if not work:
        return {}, None
    grid = np.concatenate(
        [a[None, :] + sweep[:, None] * d[None, :] for _, _, a, d in work])
    all_probs = probe_model.predict_proba(grid)
    rows = []
    for i, (pos, cname, _, _) in enumerate(work):
        curve = all_probs[i * steps:(i + 1) * steps, pos]
        rows.append({"class": cname, "start_prob": float(curve[0]),
                     "end_prob": float(curve[-1]),
                     "delta": float(curve[-1] - curve[0]),
                     "corr": float(np.corrcoef(sweep, curve)[0, 1])})
    save_table(rows, "traversal_probe_validation")
    metrics = {}
    for r in rows:
        metrics[f"traversal_probe/{r['class']}/delta"] = r["delta"]
        metrics[f"traversal_probe/{r['class']}/corr"] = r["corr"]
    return metrics, rows


def save_logreg_weight_heatmap(probe_model, class_map=None,
                               name="latent_logreg_weights"):
    """Diverging heatmap of the probe's weights, classes × latent dims,
    with a colour bar."""
    if probe_model is None:
        return None
    coef = np.atleast_2d(probe_model.coef_)
    n_cls, n_dim = coef.shape
    names = _idx_to_name(class_map)
    limit = float(np.abs(coef).max()) or 1.0
    cell_w, cell_h, left, top = max(4, 960 // n_dim), 48, 110, 40
    width, height = left + cell_w * n_dim + 120, top + cell_h * n_cls + 60
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    cells = plots.rdbu_r(coef / limit)
    heat = Image.fromarray(cells).resize((cell_w * n_dim, cell_h * n_cls),
                                         Image.NEAREST)
    img.paste(heat, (left, top))
    ax = plots.Axes(draw, (left, top, left + cell_w * n_dim,
                           top + cell_h * n_cls), (0, n_dim), (n_cls, 0),
                    title="Latent-probe weights per class")
    every = max(1, int(np.ceil(n_dim / 32)))
    ax.xticks(np.arange(0, n_dim, every) + 0.5, np.arange(0, n_dim, every))
    ax.yticks(np.arange(n_cls) + 0.5,
              [names.get(int(c), str(int(c)))
               for c in list(probe_model.classes_)[:n_cls]])
    plots.centered_text(draw, (left + cell_w * n_dim / 2, height - 14),
                        "latent dimension")
    draw.text((4, top - 16), "class", fill="black", font=plots.font())
    bar_x = left + cell_w * n_dim + 30
    ramp = plots.rdbu_r(np.linspace(1.0, -1.0, cell_h * n_cls))[:, None, :]
    img.paste(Image.fromarray(np.repeat(ramp, 16, axis=1)), (bar_x, top))
    bar = plots.Axes(draw, (bar_x, top, bar_x + 16, top + cell_h * n_cls),
                     (0, 1), (-limit, limit))
    draw.text((bar_x + 20, top - 16), "weight", fill="black",
              font=plots.font())
    for val in (-limit, 0.0, limit):
        _, v = bar.px(0, val)
        draw.text((bar_x + 20, v - 5), f"{val:.2g}", fill="black",
                  font=plots.font())
    return save_figure(img, name)


def _pick_traversal_direction(class_dirs: dict, cname: str, latent_dim: int):
    """The class's own probe direction, else any probe direction, else
    axis 0."""
    if cname in class_dirs:
        return np.asarray(class_dirs[cname], np.float32)
    if class_dirs:
        return np.asarray(next(iter(class_dirs.values())), np.float32)
    axis0 = np.zeros((latent_dim,), np.float32)
    axis0[0] = 1.0
    return axis0


def save_recon_traversal_comparison(model: BetaVAEModule,
                                    test_ds: ArrayDataset, class_dirs=None,
                                    span=3.0):
    """``recon_vs_traversal.png``: original, reconstruction (one sampling
    forward, noise at ``(data.seed, 0)``) and μ ∓ span·direction of the
    first test image, the two endpoints decoded in one call."""
    cfg = get_config()
    if len(test_ds) == 0:
        return None
    if span is None:
        span = get(cfg.inference, "edit_span", 3.0)
    dev = _device(model)
    x = images_to_tensor(test_ds.images[:1], dev)
    label = int(test_ds.labels[0])
    cname = test_ds.idx_to_class.get(label, str(label))
    direction = _pick_traversal_direction(class_dirs or {}, cname,
                                          model.latent_dim)
    recon, mu = sample_forward(model, x, int(cfg.data.seed), 0)[:2]
    endpoints = mu.cpu().numpy()[None, 0] + np.stack(
        [-span * direction, span * direction])
    ends = decode_latents(model, endpoints)
    panels = [("original", to_numpy_images(x)[0]),
              ("reconstruction", to_numpy_images(recon)[0]),
              (f"traverse -{span}", ends[0]), (f"traverse +{span}", ends[1])]
    size, pad = 256, 12
    img = Image.new("RGB", (len(panels) * (size + pad) + pad, size + 40),
                    "white")
    draw = ImageDraw.Draw(img)
    for i, (title, frame) in enumerate(panels):
        x0 = pad + i * (size + pad)
        img.paste(plots.image_panel(frame, size), (x0, 32))
        plots.centered_text(draw, (x0 + size / 2, 16), title)
    return save_figure(img, "recon_vs_traversal")


def latent_separability_scores(latents, labels) -> dict:
    try:
        return {"silhouette": silhouette(latents, labels)}
    except ValueError:
        return {"silhouette": float("nan")}


def _write_summary_tables(report: dict, probe: dict) -> None:
    """``metrics_summary.csv`` (metric, value rows) and
    ``confusion_matrix.csv`` (an ``index`` column of ``true_<c>`` and one
    ``pred_<c>`` column per class)."""
    save_table({"metric": list(report), "value": list(report.values())},
               "metrics_summary")
    cm, classes = probe.get("confusion_matrix"), probe.get("classes")
    if cm is not None and classes is not None:
        table = {"index": [f"true_{c}" for c in classes]}
        for j, c in enumerate(classes):
            table[f"pred_{c}"] = [row[j] for row in cm]
        save_table(table, "confusion_matrix")


def evaluate_full(model: BetaVAEModule, train_ds: ArrayDataset,
                  test_ds: ArrayDataset) -> dict:
    """Reconstruction metrics → latents → probe → directions → traversal
    validation → separability → tables, figures and one ``phase="eval"``
    METRICS line; returns the report."""
    cfg = get_config()
    class_map = test_ds.class_to_idx
    binary = cfg.data.class_mode == "binary"
    span = float(get(cfg.inference, "edit_span", 3.0))
    sweep_steps = int(cfg.evaluation.traversal_steps)

    report = gather_reconstruction_metrics(model, test_ds)
    latents, labels, _ = extract_latents(
        model, test_ds, limit=int(cfg.evaluation.num_umap_samples))
    probe, probe_model, _ = logistic_probe(
        latents, labels,
        train_fraction=float(cfg.evaluation.probe_train_split),
        binary=binary, return_model=True)
    report.update(probe)

    class_dirs = compute_probe_directions(probe_model, class_map)
    sweep_metrics, _ = traversal_probe_validation(
        probe_model, latents, labels, class_dirs, steps=sweep_steps,
        span=span, class_map=class_map)
    report.update(sweep_metrics)
    report.update(latent_separability_scores(latents, labels))

    _write_summary_tables(report, probe)
    save_logreg_weight_heatmap(probe_model, class_map)
    save_recon_traversal_comparison(model, test_ds, class_dirs=class_dirs,
                                    span=span)
    log_metrics(report, step=None, phase="eval")
    return report
