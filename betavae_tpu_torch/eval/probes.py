"""Linear-probe diagnostics on latent means, on the host (numpy, scipy).

The port's own copy of ``betavae_tpu/eval/probes.py``: the probe AUC of a
logistic regression fitted on the latents (binary, or macro one-vs-rest
over the classes) plus the best per-dimension AUC, |correlation| and R²
against one-vs-rest class indicators.  The JAX package fits its probe with
scikit-learn.  The port keeps scikit-learn out of its dependencies, so that
its trainer runs on a GPU install that has PyTorch, numpy and scipy alone;
here the same model is fitted by L-BFGS in scipy: an L2 penalty ½‖W‖² with
C = 1 on the summed log loss, the intercept free, one sigmoid for two
classes and a softmax for more, with the objective's scaling and the
stopping rule of scikit-learn's ``LogisticRegression()`` and its lbfgs
solver, so that on float64 data the two fits agree to rounding
(``tests/test_torch_port_train.py`` holds the probe AUCs to 1e-6).  The per-dimension statistics are the same closed forms as the JAX
package's.

The evaluation's probes use the same fit (:func:`fit_logistic`, a
:class:`LogisticModel` with scikit-learn's attributes) and the metrics the
JAX package takes from scikit-learn, in numpy and scipy: the confusion
matrix, F1, the binary and macro one-vs-rest ROC-AUC, the silhouette and
PCA (``tests/test_torch_port_eval.py`` holds each to scikit-learn).
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import svd
from scipy.optimize import minimize
from scipy.spatial.distance import cdist
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


class LogisticModel:
    """A fitted L2 logistic regression, as scikit-learn's
    ``LogisticRegression`` exposes it: ``coef_`` (one row for two classes,
    one per class for more), ``intercept_``, ``classes_`` and
    :meth:`predict_proba`."""

    def __init__(self, coef: np.ndarray, intercept: np.ndarray,
                 classes: np.ndarray):
        self.coef_, self.intercept_, self.classes_ = coef, intercept, classes

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        z = np.asarray(x, np.float64) @ self.coef_.T + self.intercept_
        if len(self.classes_) == 2:
            p1 = expit(z[:, 0])
            return np.stack([1.0 - p1, p1], axis=1)
        return softmax(z, axis=1)


def fit_logistic(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                 max_iter: int = 2000) -> LogisticModel:
    """L2 logistic regression on ``(x, y)`` in float64, with
    scikit-learn's lbfgs objective and stopping rule: the mean log loss
    plus ``‖W‖² / (2·C·n)``, L-BFGS-B from zeros with ``gtol`` 1e-4, ``ftol``
    64·eps and 50 line-search steps.  Fewer than two classes raise
    ``ValueError``, as scikit-learn's fit does."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y)
    classes = np.unique(y)
    if len(classes) < 2:
        raise ValueError(f"logistic regression needs samples of at least 2 "
                         f"classes, got {classes.tolist()}")
    n, d = x.shape
    l2 = 1.0 / (c * n)
    options = {"maxiter": max_iter, "maxls": 50, "gtol": 1e-4,
               "ftol": 64 * np.finfo(np.float64).eps}
    if len(classes) == 2:
        t = (y == classes[1]).astype(np.float64)

        def objective(theta):
            w, b = theta[:d], theta[d]
            z = x @ w + b
            loss = -np.sum(t * log_expit(z) + (1.0 - t) * log_expit(-z)) / n
            r = (expit(z) - t) / n
            grad = np.concatenate([x.T @ r + l2 * w, [r.sum()]])
            return loss + 0.5 * l2 * (w @ w), grad

        res = minimize(objective, np.zeros(d + 1), jac=True, method="L-BFGS-B",
                       options=options)
        return LogisticModel(res.x[None, :d], res.x[d:], classes)

    k = len(classes)
    onehot = (y[:, None] == classes[None, :]).astype(np.float64)

    def objective(theta):
        wb = theta.reshape(k, d + 1)
        w = wb[:, :d]
        z = x @ w.T + wb[:, d]
        loss = np.sum(logsumexp(z, axis=1) - np.sum(z * onehot, axis=1)) / n
        r = (softmax(z, axis=1) - onehot) / n
        grad = np.concatenate([r.T @ x + l2 * w, r.sum(axis=0)[:, None]],
                              axis=1)
        return loss + 0.5 * l2 * np.sum(w * w), grad.ravel()

    res = minimize(objective, np.zeros(k * (d + 1)), jac=True,
                   method="L-BFGS-B", options=options)
    wb = res.x.reshape(k, d + 1)
    return LogisticModel(wb[:, :d], wb[:, d], classes)


def logistic_probabilities(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                           max_iter: int = 2000) -> np.ndarray:
    """Class probabilities ``(N, K)`` of an L2 logistic regression fitted on
    ``(x, y)`` and evaluated on ``x``."""
    return fit_logistic(x, y, c, max_iter).predict_proba(x)


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """Counts ``[i, j]`` of true ``labels[i]`` predicted ``labels[j]``;
    samples with another label on either side are not counted."""
    labels = np.asarray(labels)
    t = (np.asarray(y_true)[:, None] == labels[None, :]).astype(np.int64)
    p = (np.asarray(y_pred)[:, None] == labels[None, :]).astype(np.int64)
    return t.T @ p


def _f1_per_label(y_true, y_pred, labels) -> np.ndarray:
    labels = np.asarray(labels)
    t = np.asarray(y_true)[:, None] == labels[None, :]
    p = np.asarray(y_pred)[:, None] == labels[None, :]
    tp = (t & p).sum(axis=0)
    denom = t.sum(axis=0) + p.sum(axis=0)           # 2·tp + fp + fn
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(denom > 0, 2.0 * tp / denom, 0.0)


def f1_score(y_true, y_pred, average: str | None = "binary", labels=None):
    """scikit-learn's ``f1_score`` with zero division giving 0:
    ``"binary"`` is the F1 of label 1, ``"macro"`` the mean over ``labels``
    (default: every label in either array), ``None`` the per-label array."""
    if average == "binary":
        return float(_f1_per_label(y_true, y_pred, [1])[0])
    if labels is None:
        labels = np.unique(np.concatenate([np.asarray(y_true),
                                           np.asarray(y_pred)]))
    f1 = _f1_per_label(y_true, y_pred, labels)
    if average is None:
        return f1
    if average == "macro":
        return float(np.mean(f1))
    raise ValueError(f"unsupported average {average!r}")


def binary_auc(y, score) -> float:
    """ROC-AUC of ``score`` for the larger of two labels; ``ValueError``
    for fewer than two, as ``roc_auc_score`` raises."""
    auc, classes = rank_auc_matrix(np.asarray(score)[:, None], y)
    if len(classes) != 2:
        raise ValueError(f"binary ROC-AUC needs two classes in y, got "
                         f"{classes.tolist()}")
    return float(auc[0, 1])


def macro_ovr_auc(y, probs) -> float:
    """``roc_auc_score(y, probs, multi_class="ovr", average="macro")``:
    the mean over the classes of y of the AUC of their column.  Like
    scikit-learn it raises ``ValueError`` unless y holds three classes or
    more, one per column."""
    probs = np.asarray(probs)
    auc, classes = rank_auc_matrix(probs, y)
    if len(classes) < 3 or len(classes) != probs.shape[1]:
        raise ValueError(f"one-vs-rest AUC needs one column per class of y "
                         f"(at least 3): {len(classes)} classes, "
                         f"{probs.shape[1]} columns")
    return float(np.mean(np.diag(auc)))


def silhouette(x, labels) -> float:
    """Mean silhouette coefficient over Euclidean distances
    (``sklearn.metrics.silhouette_score``): members of one-sample classes
    score 0; ``ValueError`` unless 2 ≤ classes ≤ samples − 1."""
    x = np.asarray(x, np.float64)
    classes, idx = np.unique(np.asarray(labels), return_inverse=True)
    n, k = len(idx), len(classes)
    if not 2 <= k <= n - 1:
        raise ValueError(f"silhouette needs 2 <= classes <= samples - 1, got "
                         f"{k} classes of {n} samples")
    onehot = (idx[:, None] == np.arange(k)[None, :]).astype(np.float64)
    sums = cdist(x, x) @ onehot                             # (N, K)
    counts = onehot.sum(axis=0)
    rows = np.arange(n)
    own = counts[idx]
    with np.errstate(invalid="ignore", divide="ignore"):
        a = sums[rows, idx] / (own - 1)
        other = sums / counts
        other[rows, idx] = np.inf
        b = other.min(axis=1)
        s = (b - a) / np.maximum(a, b)
    s[own == 1] = 0.0
    return float(np.mean(np.nan_to_num(s)))


def pca(latents, n_components: int = 2) -> np.ndarray:
    """``PCA(n_components).fit_transform(latents)``: the centred data's
    coordinates on its leading right singular vectors, each vector's sign
    set so that its largest-magnitude entry is positive (scikit-learn's
    ``svd_flip``)."""
    x = np.asarray(latents, np.float64)
    u, s, vt = svd(x - x.mean(axis=0), full_matrices=False)
    signs = np.sign(vt[np.arange(len(vt)), np.abs(vt).argmax(axis=1)])
    return (u * (s * signs))[:, :n_components]


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
