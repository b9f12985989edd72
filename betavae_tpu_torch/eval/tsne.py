"""Exact t-SNE in numpy and scipy, with scikit-learn's semantics.

The JAX package's evaluation calls scikit-learn (``betavae_tpu/eval/
latent_viz.py:41-48``)::

    TSNE(n_components, random_state=seed, init="random",
         learning_rate="auto", perplexity=min(30, max(2, n / 4 - 1)))

The port carries no scikit-learn, so this module is the same optimisation
written out, in the exact (O(n²)) form: the JAX call's default is
Barnes–Hut, an approximation of the same gradient, so the two agree in
distribution (KL divergence, trustworthiness), not point for point.  It
follows ``sklearn/manifold/_t_sne.py`` and ``_utils.pyx`` step for step:

- squared Euclidean distances, in float32, and for each point the
  Gaussian precision β found by bisection (100 steps at most, until the
  row's entropy is within 1e-5 of ``log(perplexity)``), the joint ``P`` the
  symmetrised conditionals over their sum, floored at the double epsilon;
- the initial embedding ``1e-4 · RandomState(seed).standard_normal`` in
  float32; learning rate ``max(n / 12 / 4, 50)``;
- Student-t ``Q`` with ``max(n_components − 1, 1)`` degrees of freedom, the
  KL divergence and its gradient;
- gradient descent with momentum and gains (+0.2 where the step changes
  sign, ×0.8 elsewhere, floored at 0.01): 250 iterations with ``P``
  exaggerated 12× and momentum 0.5, then momentum 0.8 up to ``max_iter``
  (1000); every 50 iterations the run stops when the error has not
  improved for ``n_iter_without_progress`` iterations (250 in the first
  stage, 300 in the second) or the gradient norm is at most 1e-7.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import pdist, squareform

MACHINE_EPSILON = np.finfo(np.double).eps
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITER = 250
N_ITER_CHECK = 50
# C floats in scikit-learn's binary search, so their float32 values
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
EPSILON_DBL = float(np.float32(1e-8))


def default_perplexity(n: int) -> float:
    """The JAX call's ``min(30, max(2, n / 4 − 1))``."""
    return min(30.0, max(2.0, n / 4 - 1))


def squared_distances(x: np.ndarray) -> np.ndarray:
    """Squared Euclidean distances as float32 ``[n, n]``: ``‖x‖² + ‖y‖² −
    2·x·y`` in float64, clipped at 0, the diagonal 0 (scikit-learn's
    ``pairwise_distances(squared=True)``)."""
    x = np.asarray(x, dtype=np.float64)
    sq = np.einsum("ij,ij->i", x, x)
    d = -2.0 * (x @ x.T) + sq[:, None] + sq[None, :]
    np.maximum(d, 0.0, out=d)
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float32)


def conditional_probabilities(sqdist: np.ndarray,
                              perplexity: float) -> np.ndarray:
    """``p_{j|i}`` as float64 ``[n, n]`` (0 on the diagonal) from float32
    squared distances: every row's bisection on β, run for all rows at
    once, each row stopping where its own would."""
    d = np.asarray(sqdist, dtype=np.float32).astype(np.float64)
    n = d.shape[0]
    off = ~np.eye(n, dtype=bool)
    desired = np.log(float(np.float32(perplexity)))
    beta = np.ones(n)
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    active = np.ones(n, dtype=bool)
    p = np.zeros((n, n))
    for _ in range(100):
        rows = np.flatnonzero(active)
        if rows.size == 0:
            break
        pr = np.where(off[rows], np.exp(-d[rows] * beta[rows, None]), 0.0)
        s = pr.sum(axis=1)
        s[s == 0.0] = EPSILON_DBL
        pr /= s[:, None]
        p[rows] = pr
        entropy = np.log(s) + beta[rows] * (d[rows] * pr).sum(axis=1)
        diff = entropy - desired
        done = np.abs(diff) <= PERPLEXITY_TOLERANCE
        up = ~done & (diff > 0.0)
        down = ~done & ~up
        b = beta[rows]
        lo_r, hi_r = lo[rows], hi[rows]
        lo_r[up] = b[up]
        b[up] = np.where(np.isinf(hi_r[up]), b[up] * 2.0,
                         (b[up] + hi_r[up]) / 2.0)
        hi_r[down] = b[down]
        b[down] = np.where(np.isinf(lo_r[down]), b[down] / 2.0,
                           (b[down] + lo_r[down]) / 2.0)
        beta[rows], lo[rows], hi[rows] = b, lo_r, hi_r
        active[rows[done]] = False
    return p


def joint_probabilities(x: np.ndarray, perplexity: float) -> np.ndarray:
    """The condensed joint ``P`` (``n·(n−1)/2`` float64 values) of the
    points ``x``."""
    cond = conditional_probabilities(squared_distances(x), perplexity)
    p = cond + cond.T
    total = np.maximum(np.sum(p), MACHINE_EPSILON)
    return np.maximum(squareform(p) / total, MACHINE_EPSILON)


def kl_divergence(params: np.ndarray, p: np.ndarray, dof: float,
                  n_components: int, compute_error: bool = True):
    """``(KL(P‖Q), dKL/dY)`` at the flat embedding ``params``; the gradient
    in ``params``' dtype."""
    y = params.reshape(-1, n_components)
    dist = pdist(y, "sqeuclidean")
    dist /= dof
    dist += 1.0
    dist **= (dof + 1.0) / -2.0
    q = np.maximum(dist / (2.0 * np.sum(dist)), MACHINE_EPSILON)
    error = (2.0 * np.dot(p, np.log(np.maximum(p, MACHINE_EPSILON) / q))
             if compute_error else np.nan)
    pqd = squareform((p - q) * dist)
    # row by row, as scikit-learn sums it, so that the rounding is its own
    grad = np.ndarray(y.shape, dtype=params.dtype)
    for i in range(y.shape[0]):
        grad[i] = np.dot(pqd[i], y[i] - y)
    grad = grad.ravel()
    grad *= 2.0 * (dof + 1.0) / dof
    return error, grad


def gradient_descent(params, p, dof, n_components, *, it, max_iter,
                     momentum, learning_rate, n_iter_without_progress,
                     min_gain=0.01, min_grad_norm=1e-7):
    """scikit-learn's ``_gradient_descent`` over :func:`kl_divergence`:
    ``(params, error, last iteration)``."""
    p0 = params.copy().ravel()
    update = np.zeros_like(p0)
    gains = np.ones_like(p0)
    error = best_error = np.finfo(float).max
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        error, grad = kl_divergence(p0, p, dof, n_components,
                                    compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        dec = np.invert(inc)
        gains[inc] += 0.2
        gains[dec] *= 0.8
        np.clip(gains, min_gain, np.inf, out=gains)
        grad *= gains
        update = momentum * update - learning_rate * grad
        p0 += update
        if check:
            grad_norm = np.linalg.norm(grad)
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return p0, error, i


def tsne(x: np.ndarray, n_components: int = 2, *, seed: int = 42,
         perplexity: float | None = None, max_iter: int = 1000,
         init: np.ndarray | None = None, n_iter_without_progress: int = 300):
    """``(embedding [n, n_components] float32, final KL divergence, last
    iteration)`` of the points ``x`` [n, d]; ``init`` replaces the random
    start (for holding the optimisation to scikit-learn's from one)."""
    x = np.asarray(x)
    n = x.shape[0]
    if perplexity is None:
        perplexity = default_perplexity(n)
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than "
                         f"n_samples ({n})")
    learning_rate = np.maximum(n / EARLY_EXAGGERATION / 4, 50)
    p = joint_probabilities(x, perplexity)
    if init is None:
        init = 1e-4 * np.random.RandomState(seed).standard_normal(
            size=(n, n_components)).astype(np.float32)
    params = np.asarray(init).ravel()
    dof = max(n_components - 1, 1)
    common = dict(learning_rate=learning_rate)
    p *= EARLY_EXAGGERATION
    params, error, it = gradient_descent(
        params, p, dof, n_components, it=0, max_iter=EXPLORATION_ITER,
        momentum=0.5, n_iter_without_progress=EXPLORATION_ITER, **common)
    p /= EARLY_EXAGGERATION
    if it < EXPLORATION_ITER or max_iter - EXPLORATION_ITER > 0:
        params, error, it = gradient_descent(
            params, p, dof, n_components, it=it + 1, max_iter=max_iter,
            momentum=0.8, n_iter_without_progress=n_iter_without_progress,
            **common)
    return params.reshape(n, n_components), float(error), it
