"""Latent-dimension analysis: per-dim AUCs, KL usage, probe ranking.

``python -m betavae_tpu_torch.infer.latent_analysis --config CONFIG
[--weights best|latest] [--device cuda|cpu]``, the port's
``betavae_tpu/infer/latent_analysis.py``:

- per-dim AUC on μ and |μ| (the max over classes one-vs-rest for
  multiclass, the larger label's for binary; constant dims 0.5),
- logistic-regression weights (``eval/probes.py::fit_logistic``) and the
  dims ordered by max |weight|,
- per-dim KL mean ``½(μ² + σ² − logσ² − 1)`` and μ variance,
- the latent correlation pairs,
- ``per_dimension_auc.csv``, ``latent_usage.csv`` (sorted by ``kl_mean``
  descending, with the per-class ``logreg_weight_<class>`` columns that
  ``eval/traversal.py`` reads back), ``latent_corr_pairs.csv``, and
  ``latent_ranking_summary.json`` (``traversal_order_auc`` / ``_kl``, the
  top 10 probe dims, the class balance, the 20 strongest pairs).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..config import get_config
from ..data.dataset import ArrayDataset, build_datasets
from ..device import resolve_device
from ..eval.probes import fit_logistic, rank_auc_matrix
from ..eval.run_evaluation import load_model
from ..io.artifacts import save_json, save_table
from ..models.beta_vae import BetaVAEModule, encode_split


def extract_latents_with_kl(model: BetaVAEModule, ds: ArrayDataset):
    """``(mu, kl per dim, labels)`` of every sample of ``ds``."""
    mu, logvar = encode_split(model, ds.images,
                              int(get_config().training.batch_size))
    kl = 0.5 * (mu ** 2 + np.exp(logvar) - logvar - 1.0)
    return mu, kl, np.asarray(ds.labels)


def _ovr_auc_per_dim(scores_mat: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-column one-vs-rest AUC: the max over classes for multiclass,
    the larger label's for two classes, NaN for one."""
    auc, classes = rank_auc_matrix(scores_mat, y)
    if len(classes) < 2:
        return np.full(scores_mat.shape[1], np.nan)
    if len(classes) == 2:
        return auc[:, 1]
    return np.max(auc, axis=1)


def per_dimension_auc(L, y):
    return [(d, float(a)) for d, a in enumerate(_ovr_auc_per_dim(L, y))]


def per_dimension_abs_auc(L, y):
    return [(d, float(a))
            for d, a in enumerate(_ovr_auc_per_dim(np.abs(L), y))]


def logistic_weights(L, y):
    """``(dims by max |weight| descending, coef, classes)``; a binary fit's
    one row becomes ±row, one per class."""
    clf = fit_logistic(L, y)
    coef = np.atleast_2d(clf.coef_)
    if len(clf.classes_) == 2 and coef.shape[0] == 1:
        coef = np.concatenate([-coef, coef], axis=0)
    order = np.argsort(np.max(np.abs(coef), axis=0))[::-1]
    return order, coef, clf.classes_


def _nan_last(values: np.ndarray) -> np.ndarray:
    """Rank order, descending, NaNs last."""
    keyed = np.where(np.isnan(values), -np.inf, values)
    return np.argsort(-keyed, kind="stable")


def build_report(L: np.ndarray, K: np.ndarray, y: np.ndarray,
                 idx_to_class: dict) -> dict:
    """Write ``per_dimension_auc.csv``, ``latent_usage.csv`` and
    ``latent_corr_pairs.csv``; return the ``latent_ranking_summary``."""
    n_dims = L.shape[1]
    auc_mu = _ovr_auc_per_dim(L, y)
    auc_abs = _ovr_auc_per_dim(np.abs(L), y)
    kl_mean = K.mean(axis=0)
    mu_var = L.var(axis=0)
    order, coef, classes = logistic_weights(L, y)
    class_name = {cls: str(idx_to_class.get(cls, f"class{cls}"))
                  for cls in classes}
    dims = np.arange(n_dims)

    save_table({"latent_dim": dims, "single_dim_auc": auc_mu},
               "per_dimension_auc")
    usage = {"latent_dim": dims, "kl_mean": kl_mean, "mu_var": mu_var,
             "single_dim_auc": auc_mu, "single_dim_auc_abs": auc_abs,
             "logreg_weight_maxabs": np.max(np.abs(coef), axis=0),
             **{f"logreg_weight_{class_name[cls]}": coef[row]
                for row, cls in enumerate(classes)}}
    by_kl = np.argsort(-kl_mean, kind="stable")
    save_table({k: np.asarray(v)[by_kl] for k, v in usage.items()},
               "latent_usage")

    iu, ju = np.triu_indices(n_dims, k=1)
    corr_full = np.corrcoef(L, rowvar=False)[iu, ju]
    save_table({"i": iu, "j": ju, "corr": corr_full}, "latent_corr_pairs")
    strongest = np.argsort(-np.abs(corr_full), kind="stable")[:20]

    auc_rank = _nan_last(auc_mu)
    abs_rank = _nan_last(auc_abs)
    return {
        "best_auc_dim": int(auc_rank[0]),
        "best_auc": float(auc_mu[auc_rank[0]]),
        "best_abs_auc_dim": int(abs_rank[0]),
        "best_abs_auc": float(auc_abs[abs_rank[0]]),
        "top_logreg_dims": [{
            "latent_dim": int(d),
            "abs_weight_max": float(np.max(np.abs(coef[:, d]))),
            "weights": {class_name[cls]: float(coef[row, d])
                        for row, cls in enumerate(classes)},
            "kl_mean": float(kl_mean[d]),
            "mu_var": float(mu_var[d]),
            "single_dim_auc": float(auc_mu[d]),
        } for d in order[:10]],
        "traversal_order_auc": [int(d) for d in auc_rank],
        "traversal_order_kl": [int(d) for d in np.argsort(-kl_mean)],
        "class_balance": {
            "counts": {int(k): int(v)
                       for k, v in zip(*np.unique(y, return_counts=True))}
        },
        "top_corr_pairs": [{"i": int(iu[p]), "j": int(ju[p]),
                            "corr": float(corr_full[p])} for p in strongest],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.infer.latent_analysis",
        description="Latent dimension analysis")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--weights", type=str, default="best")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    get_config(args.config)
    _, test_ds = build_datasets()
    model = load_model(args.weights, device=device)
    L, K, y = extract_latents_with_kl(model, test_ds)
    report = build_report(L, K, y, test_ds.idx_to_class)
    save_json(report, "latent_ranking_summary")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
