"""Linear-probe diagnostics on latent means, on the host (numpy, scipy).

The port's own copy of ``betavae_tpu/eval/probes.py``: the probe AUC of a
logistic regression fitted on the latents (binary, or macro one-vs-rest
over the classes) plus the best per-dimension AUC, |correlation| and R²
against one-vs-rest class indicators.  The JAX package fits its probe with
scikit-learn.  The port keeps scikit-learn out of its dependencies, so that
its trainer runs on a GPU install that has PyTorch, numpy and scipy alone;
here the same model is fitted by L-BFGS in scipy: an L2 penalty ½‖W‖² with
C = 1 on the summed log loss, the intercept free, one sigmoid for two
classes and a softmax for more (scikit-learn's ``LogisticRegression()``
with its lbfgs solver; ``tests/test_torch_port_train.py`` holds the two to
1e-6).  The per-dimension statistics are the same closed forms as the JAX
package's.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize
from scipy.special import expit, log_expit, logsumexp, softmax
from scipy.stats import rankdata

NAN_METRICS = ("latent_probe_auc", "best_dim_auc", "best_dim_corr",
               "best_dim_r2")


def rank_auc_matrix(scores: np.ndarray, y: np.ndarray):
    """One-vs-rest ROC-AUC of every score column for every class:
    ``AUC = (Σ_pos R − n_pos(n_pos+1)/2) / (n_pos · n_neg)`` with midranks
    ``R``.  Returns ``(auc (D, C), classes (C,))``."""
    scores = np.asarray(scores, np.float64)
    y = np.asarray(y)
    classes = np.unique(y)
    onehot = y[:, None] == classes[None, :]
    n_pos = onehot.sum(axis=0).astype(np.float64)
    n = float(len(y))
    pos_rank_sum = rankdata(scores, axis=0).T @ onehot
    with np.errstate(invalid="ignore", divide="ignore"):
        auc = (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * (n - n_pos))
    return auc, classes


def logistic_probabilities(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                           max_iter: int = 2000) -> np.ndarray:
    """Class probabilities ``(N, K)`` of an L2 logistic regression fitted on
    ``(x, y)`` and evaluated on ``x``."""
    x = np.asarray(x, np.float64)
    classes = np.unique(y)
    n, d = x.shape
    if len(classes) == 2:
        t = (np.asarray(y) == classes[1]).astype(np.float64)

        def objective(theta):
            w, b = theta[:d], theta[d]
            z = x @ w + b
            loss = -np.sum(t * log_expit(z) + (1.0 - t) * log_expit(-z))
            r = expit(z) - t
            grad = np.concatenate([x.T @ r + w / c, [r.sum()]])
            return loss + 0.5 * (w @ w) / c, grad

        res = minimize(objective, np.zeros(d + 1), jac=True, method="L-BFGS-B",
                       options={"maxiter": max_iter, "gtol": 1e-10})
        p1 = expit(x @ res.x[:d] + res.x[d])
        return np.stack([1.0 - p1, p1], axis=1)

    k = len(classes)
    onehot = (np.asarray(y)[:, None] == classes[None, :]).astype(np.float64)

    def objective(theta):
        w, b = theta[:d * k].reshape(d, k), theta[d * k:]
        z = x @ w + b
        loss = np.sum(logsumexp(z, axis=1) - np.sum(z * onehot, axis=1))
        r = softmax(z, axis=1) - onehot
        grad = np.concatenate([(x.T @ r + w / c).ravel(), r.sum(axis=0)])
        return loss + 0.5 * np.sum(w * w) / c, grad

    res = minimize(objective, np.zeros(d * k + k), jac=True, method="L-BFGS-B",
                   options={"maxiter": max_iter, "gtol": 1e-10})
    w, b = res.x[:d * k].reshape(d, k), res.x[d * k:]
    return softmax(x @ w + b, axis=1)


def compute_probe_metrics(latents, labels) -> dict:
    out = {name: float("nan") for name in NAN_METRICS}
    if latents is None or len(latents) < 2:
        return out
    lat = np.asarray(latents)
    y = np.asarray(labels)
    classes = np.unique(y)
    if len(classes) < 2:
        return out
    prob = logistic_probabilities(lat, y)
    auc, _ = rank_auc_matrix(prob, y)
    # binary: the AUC of P(second class); else the macro one-vs-rest mean
    out["latent_probe_auc"] = float(auc[1, 1] if len(classes) == 2
                                    else np.mean(np.diag(auc)))

    live = ~np.all(np.isclose(lat, lat[:1, :]), axis=0)      # per-dim gate
    onehot = y[:, None] == classes[None, :]                  # (N, C)
    n_pos = onehot.sum(axis=0).astype(np.float64)
    n = float(len(y))
    valid_cls = (n_pos > 0) & (n_pos < n)
    if not (live.any() and valid_cls.any()):
        return out
    sub = lat[:, live].astype(np.float64)                    # (N, D')
    auc, _ = rank_auc_matrix(sub, y)                         # (D', C)
    if len(classes) == 2:
        best_auc = auc[:, 1][np.isfinite(auc[:, 1])]
    else:
        best_auc = np.nanmax(auc[:, valid_cls], axis=1)

    zc = sub - sub.mean(axis=0)
    bc = onehot - n_pos / n
    cov = zc.T @ bc / n                                      # (D', C)
    sb = onehot.std(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.abs(cov / (sub.std(axis=0)[:, None] * sb[None, :]))
    corr = corr[:, valid_cls]
    best_corr = corr[np.isfinite(corr)]

    # r2_score(y_bin, z) = 1 − Σ(y_bin − z)² / Σ(y_bin − ȳ)², expanded so
    # the cross term is one (D', C) product and Σy_bin² = n_pos
    ss_tot = (sb ** 2) * n
    ss_res = ((sub ** 2).sum(axis=0)[:, None]
              - 2.0 * (sub.T @ onehot.astype(np.float64)) + n_pos[None, :])
    with np.errstate(invalid="ignore", divide="ignore"):
        r2 = 1.0 - ss_res / ss_tot[None, :]
    r2 = r2[:, valid_cls]
    best_r2 = r2[np.isfinite(r2)]

    if len(best_auc):
        out["best_dim_auc"] = float(np.max(best_auc))
    if len(best_corr):
        out["best_dim_corr"] = float(np.max(best_corr))
    if len(best_r2):
        out["best_dim_r2"] = float(np.max(best_r2))
    return out
