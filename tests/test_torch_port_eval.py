"""The port's evaluation against the JAX package's, on the CPU.

- The scikit-learn stand-ins of ``eval/probes.py`` (F1 binary, macro and
  per class, the confusion matrix, the binary and macro one-vs-rest AUC,
  the silhouette, PCA up to each component's sign, the logistic fit) held
  to scikit-learn at 1e-9 on float64 data.
- ``logistic_probe`` (binary, multiclass, and a fit split of one class),
  ``compute_probe_directions`` and ``traversal_probe_validation`` held to
  the JAX functions on seeded float32 latents: probabilities and
  directions 1e-3 (scikit-learn fits float32 data in float32), confusion
  matrices and classes equal.
- One checkpoint written by the JAX package, evaluated by both:
  ``metrics_summary.csv`` through the JAX package's ``compare_metrics``
  at ``rtol_recon=1e-4``, ``rtol_std=1e-3``, ``atol_loose=1e-3`` with
  ``model.deterministic_overfit: true`` (z = μ on both sides) and
  ``confusion_matrix.csv`` equal; with sampling on, at
  ``compare_metrics``' default tolerances (the two packages draw other
  noise of one distribution).  ``run_evaluation.main`` writes every
  artifact the JAX ``main`` writes but ``latent_scatter_tsne.png`` and
  takes its traversal dims from ``latent_ranking_summary.json``.
- ``load_model`` reads the port's ``train()`` checkpoints, the JAX
  package's and the reference's torch pickle, and falls back from ``best``
  to ``latest``.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn import metrics as skm
from sklearn.decomposition import PCA
from sklearn.linear_model import LogisticRegression

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.data.dataset import build_datasets as jax_build_datasets
from betavae_tpu.eval import recon_metrics as jax_recon
from betavae_tpu.eval import run_evaluation as jax_run_evaluation
from betavae_tpu.eval.parity import compare_metrics, load_metrics_csv
from betavae_tpu.infer import latent_analysis as jax_latent_analysis
from betavae_tpu.logging_utils import reset_logger as jax_reset_logger

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.data.dataset import build_datasets
from betavae_tpu_torch.eval import probes, recon_metrics
from betavae_tpu_torch.eval import run_evaluation
from betavae_tpu_torch.eval.run_evaluation import load_model
from betavae_tpu_torch.infer import latent_analysis
from betavae_tpu_torch.io.checkpoint import load_sharded_checkpoint
from betavae_tpu_torch.io.weights import params_from_jax
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.train.loop import train

from test_torch_port_infer import (_config, jax_loaded, port_loaded,
                                   read_csv, write_jax_checkpoint)

NAMES = {0: "glioma", 1: "meningioma", 2: "notumor", 3: "pituitary"}


@pytest.fixture(autouse=True)
def _fresh_port_config():
    reset_config_cache()
    reset_logger()
    yield
    reset_config_cache()
    reset_logger()


def _labels(k: int, n: int = 60, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, n), rng.integers(0, k, n)


@pytest.mark.parametrize("case", ["f1_binary", "f1_macro", "f1_per_class",
                                  "confusion_matrix", "binary_auc",
                                  "macro_ovr_auc", "silhouette", "pca"])
def test_probe_helpers_match_sklearn(case):
    rng = np.random.default_rng(3)
    y, pred = _labels(2 if case in ("f1_binary", "binary_auc") else 4)
    x = rng.normal(size=(60, 6)) + y[:, None] * 0.7
    if case == "f1_binary":
        got, want = probes.f1_score(y, pred), skm.f1_score(y, pred)
    elif case == "f1_macro":
        got = probes.f1_score(y, pred, average="macro")
        want = skm.f1_score(y, pred, average="macro")
    elif case == "f1_per_class":
        labels = np.arange(5)            # label 4 is absent: F1 0 by rule
        got = probes.f1_score(y, pred, average=None, labels=labels)
        want = skm.f1_score(y, pred, average=None, labels=labels,
                            zero_division=0)
    elif case == "confusion_matrix":
        got = probes.confusion_matrix(y, pred, [0, 1, 2, 3])
        want = skm.confusion_matrix(y, pred, labels=[0, 1, 2, 3])
        assert got.dtype.kind == "i"
    elif case == "binary_auc":
        got, want = probes.binary_auc(y, x[:, 0]), skm.roc_auc_score(y, x[:, 0])
        with pytest.raises(ValueError):
            probes.binary_auc(np.zeros(5), np.arange(5.0))
    elif case == "macro_ovr_auc":
        p = LogisticRegression(max_iter=2000).fit(x, y).predict_proba(x)
        got = probes.macro_ovr_auc(y, p)
        want = skm.roc_auc_score(y, p, multi_class="ovr", average="macro")
        with pytest.raises(ValueError):
            probes.macro_ovr_auc(y, p[:, :3])
    elif case == "silhouette":
        y[0] = 4                         # a one-sample class scores 0
        got, want = probes.silhouette(x, y), skm.silhouette_score(x, y)
        with pytest.raises(ValueError):
            probes.silhouette(x, np.zeros(60))
    else:
        got = probes.pca(x, 2)
        want = PCA(n_components=2, random_state=42).fit_transform(x)
        assert np.abs(np.abs(got) - np.abs(want)).max() < 1e-9
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("k", [2, 4])
def test_logistic_fit_matches_sklearn(k):
    y, _ = _labels(k)
    x = np.random.default_rng(4).normal(size=(60, 6)) + y[:, None] * 0.5
    clf = LogisticRegression(max_iter=2000).fit(x, y)
    model = probes.fit_logistic(x, y)
    np.testing.assert_array_equal(model.classes_, clf.classes_)
    assert model.coef_.shape == clf.coef_.shape
    for a, b in ((model.coef_, clf.coef_), (model.intercept_, clf.intercept_),
                 (model.predict_proba(x), clf.predict_proba(x))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        probes.fit_logistic(x, np.ones(60))


def _probe_inputs(k: int, n: int = 40):
    rng = np.random.default_rng(20 + k)
    y = (np.arange(n) % k).astype(np.int32)
    L = rng.normal(size=(n, 8)).astype(np.float32)
    L[:, 2] += 1.2 * y
    return L, y


@pytest.mark.parametrize("mode", ["binary", "multiclass", "one_class_split"])
def test_logistic_probe_matches_jax(mode):
    L, y = _probe_inputs(2 if mode == "binary" else 4)
    if mode == "one_class_split":
        fit_idx, _ = recon_metrics._held_out_split(len(y), 0.3, 42)
        y = np.where(np.isin(np.arange(len(y)), fit_idx), 3, y)
    binary = mode == "binary"
    want, jclf, _ = jax_recon.logistic_probe(L, y, binary=binary,
                                             return_model=True)
    got, clf, _ = recon_metrics.logistic_probe(L, y, binary=binary,
                                               return_model=True)
    assert (clf is None) == (jclf is None) == (mode == "one_class_split")
    assert got.keys() == want.keys()
    for key, val in want.items():
        if key in ("confusion_matrix", "classes"):
            assert got[key] == val, key
        else:
            np.testing.assert_allclose(got[key], val, atol=1e-3, err_msg=key)


def test_probe_directions_and_sweeps_match_jax(tmp_path):
    L, y = _probe_inputs(4)
    class_map = {v: k for k, v in NAMES.items()}
    _, jclf, jclasses = jax_recon.logistic_probe(L, y, binary=False,
                                                 return_model=True)
    _, clf, _ = recon_metrics.logistic_probe(L, y, binary=False,
                                             return_model=True)
    jdirs = jax_recon.compute_probe_directions(jclf, jclasses, class_map)
    dirs = recon_metrics.compute_probe_directions(clf, class_map)
    assert list(dirs) == list(jdirs) == list(NAMES.values())
    for name in dirs:
        assert dirs[name].dtype == np.float32
        np.testing.assert_allclose(dirs[name], jdirs[name], atol=1e-3)

    jax_reset_config()
    jax_get_config(_config(tmp_path, "jax.yaml", "jax_out"))
    get_config(_config(tmp_path, "port.yaml", "port_out"))
    jm, _ = jax_recon.traversal_probe_validation(jclf, jclasses, L, y, jdirs,
                                                 class_map=class_map)
    m, rows = recon_metrics.traversal_probe_validation(
        clf, L, y, dirs, class_map=class_map)
    assert list(m) == list(jm) and len(rows) == 4
    np.testing.assert_allclose([m[k] for k in m], [jm[k] for k in m],
                               atol=1e-3)
    head, got = read_csv(tmp_path / "port_out" / "tables"
                         / "traversal_probe_validation.csv")
    jhead, want = read_csv(tmp_path / "jax_out" / "tables"
                           / "traversal_probe_validation.csv")
    assert head == jhead == ["class", "start_prob", "end_prob", "delta",
                             "corr"]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got], float),
                               np.array([r[1:] for r in want], float),
                               atol=1e-3)


def _jax_cli(main, path):
    jax_reset_config()
    jax_reset_logger()
    try:
        main(["--config", path])
    finally:
        os.environ.pop("CONFIG_PATH", None)
        jax_reset_logger()
        jax_reset_config()


def _port_cli(main, path):
    reset_config_cache()
    reset_logger()
    try:
        main(["--config", path, "--device", "cpu"])
    finally:
        reset_logger()
        reset_config_cache()


def _jax_evaluate_full(path):
    model, variables = jax_loaded(path)
    train_ds, test_ds = jax_build_datasets()
    try:
        return jax_recon.evaluate_full(model, variables, train_ds, test_ds)
    finally:
        jax_reset_logger()
        jax_reset_config()


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """Both packages' analysis and evaluation CLIs over one JAX-written
    checkpoint (sampling on), and ``evaluate_full`` with
    ``deterministic_overfit`` on."""
    root = tmp_path_factory.mktemp("eval")
    paths = {"jax": _config(root, "jax.yaml", "jax_out"),
             "port": _config(root, "port.yaml", "port_out"),
             "jax_det": _config(root, "jax_det.yaml", "jax_det",
                                **{"model.deterministic_overfit": True}),
             "port_det": _config(root, "port_det.yaml", "port_det",
                                 **{"model.deterministic_overfit": True})}
    write_jax_checkpoint(paths["jax"])
    _jax_cli(jax_latent_analysis.main, paths["jax"])
    _jax_cli(jax_run_evaluation.main, paths["jax"])
    _port_cli(latent_analysis.main, paths["port"])
    _port_cli(run_evaluation.main, paths["port"])
    _jax_evaluate_full(paths["jax_det"])
    model = port_loaded(paths["port_det"])
    recon_metrics.evaluate_full(model, *build_datasets())
    reset_logger()
    return root


def _summaries(root, jax_out, port_out):
    return (load_metrics_csv(str(root / jax_out / "tables"
                                 / "metrics_summary.csv")),
            load_metrics_csv(str(root / port_out / "tables"
                                 / "metrics_summary.csv")))


def test_deterministic_metrics_match_jax(evaluated):
    want, got = _summaries(evaluated, "jax_det", "port_det")
    assert list(got) == list(want)
    result = compare_metrics(want, got, rtol_recon=1e-4, rtol_std=1e-3,
                             atol_loose=1e-3)
    assert result["parity"], [r for r in result["rows"]
                              if r["status"] != "OK"]
    assert read_csv(evaluated / "port_det" / "tables"
                    / "confusion_matrix.csv") == \
        read_csv(evaluated / "jax_det" / "tables" / "confusion_matrix.csv")


def test_sampled_metrics_match_jax_in_distribution(evaluated):
    want, got = _summaries(evaluated, "jax_out", "port_out")
    assert list(got) == list(want)
    result = compare_metrics(want, got)
    assert result["parity"], [r for r in result["rows"]
                              if r["status"] != "OK"]


def test_run_evaluation_writes_the_jax_artifacts(evaluated):
    def listing(out):
        return {str(p.relative_to(evaluated / out))
                for p in (evaluated / out).rglob("*") if p.is_file()}

    want = listing("jax_out")
    assert "figures/latent_scatter_tsne.png" in want
    assert listing("port_out") == want
    ranking = json.loads(
        (evaluated / "port_out" / "latent_ranking_summary.json").read_text())
    dims = ranking["traversal_order_auc"][:3]     # min(latent 8, steps 3)
    assert {p for p in want if p.startswith("figures/traversal_dim")} == \
        {f"figures/traversal_dim{d}.png" for d in dims}


def test_load_model_reads_both_packages_with_fallback(tmp_path):
    path = _config(tmp_path, **{"training.epochs": 1,
                                "debug.max_train_batches": 2,
                                "debug.max_val_batches": 1})
    train(path, device="cpu")
    reset_logger()
    models = tmp_path / "models"
    for tag in ("best", "latest"):
        reset_config_cache()
        get_config(path)
        model = load_model(tag, device="cpu")
        assert not model.training
        state = load_sharded_checkpoint(str(models / f"run_{tag}.pt"))
        for name, val in model.state_dict().items():
            np.testing.assert_array_equal(val.numpy(),
                                          state["model_state"][name], name)

    for shard in models.glob("run_*"):
        shard.unlink()
    write_jax_checkpoint(path, tag="latest", seed=3)
    reset_config_cache()
    get_config(path)
    model = load_model("best", device="cpu")      # no best: latest
    want = params_from_jax(load_sharded_checkpoint(
        str(models / "run_latest.pt"))["model_state"])
    for name, val in model.state_dict().items():
        assert torch.equal(val, want[name]), name

    for shard in models.glob("run_*"):
        shard.unlink()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"model_state": saved}, models / "run_best.pt")
    reference = load_model("best", device="cpu")   # the reference's pickle
    assert not reference.training
    for name, val in reference.state_dict().items():
        assert torch.equal(val, saved[name]), name
    shutil.rmtree(models)


# --------------------------------------------------------------------------
# t-SNE: the port's exact optimisation against scikit-learn's, and its
# result against the JAX call (Barnes–Hut) in distribution
# --------------------------------------------------------------------------

def _tsne_points(n: int = 200, d: int = 16, seed: int = 0):
    """Four Gaussian clusters of latents, ``n`` points in ``d`` dims (the
    evaluation's ``num_umap_samples`` is 200)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 3.0, size=(4, d))
    labels = np.arange(n) % 4
    return (centres[labels] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n", [12, 200])
def test_tsne_joint_probabilities_match_sklearn(n):
    """The perplexity bisection and the joint P at the JAX call's
    perplexity, min(30, max(2, n/4 − 1)): 1e-6 relative."""
    from sklearn.manifold import _t_sne as sk_tsne
    from sklearn.metrics import pairwise_distances

    from betavae_tpu_torch.eval import tsne

    x = _tsne_points(n)
    perplexity = tsne.default_perplexity(n)
    want = sk_tsne._joint_probabilities(
        pairwise_distances(x, metric="euclidean", squared=True),
        perplexity, 0)
    got = tsne.joint_probabilities(x, perplexity)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_tsne_iterations_match_sklearn_exact():
    """From one initial embedding, the first 10 iterations of the
    exaggerated stage against scikit-learn's ``_gradient_descent`` over its
    exact KL gradient, and the whole run (1000 iterations, both stages, its
    stopping rules) against ``TSNE(method="exact")``: 1e-6 relative of the
    largest coordinate.  (Both sum the gradient row by row in one order, so
    the trajectories stay together; the early iterations of t-SNE amplify
    a difference of one rounding by ~10× an iteration.)"""
    from sklearn.manifold import TSNE
    from sklearn.manifold import _t_sne as sk_tsne

    from betavae_tpu_torch.eval import tsne

    x = _tsne_points()
    n = len(x)
    perplexity = tsne.default_perplexity(n)
    init = 1e-4 * np.random.RandomState(42).standard_normal(
        size=(n, 2)).astype(np.float32)
    p = tsne.joint_probabilities(x, perplexity) * tsne.EARLY_EXAGGERATION
    lr = np.maximum(n / tsne.EARLY_EXAGGERATION / 4, 50)
    want, want_err, _ = sk_tsne._gradient_descent(
        sk_tsne._kl_divergence, init.ravel().copy(), it=0, max_iter=10,
        n_iter_check=50, n_iter_without_progress=250, momentum=0.5,
        learning_rate=lr, min_gain=0.01, min_grad_norm=1e-7, verbose=0,
        args=[p, 1, n, 2], kwargs=dict(skip_num_points=0))
    got, got_err, _ = tsne.gradient_descent(
        init.ravel().copy(), p, 1, 2, it=0, max_iter=10, momentum=0.5,
        learning_rate=lr, n_iter_without_progress=250)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert got_err == pytest.approx(want_err, rel=1e-6)

    sk = TSNE(2, random_state=42, init=init.copy(), learning_rate="auto",
              perplexity=perplexity, method="exact")
    want = sk.fit_transform(x)
    got, kl, last = tsne.tsne(x, init=init.copy())
    assert last == sk.n_iter_
    assert kl == pytest.approx(sk.kl_divergence_, rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_tsne_embedding_matches_the_jax_call_in_distribution():
    """``reduce_latents(method="tsne")`` against the JAX package's (scikit-
    learn's Barnes–Hut t-SNE, random init from the same seed) on 200
    latents: the same shape, the KL divergence of each embedding under
    the exact P within 5 % of each other, and the trustworthiness at 5
    and at 30 neighbours (the perplexity) within 0.02."""
    from betavae_tpu.eval.latent_viz import reduce_latents as jax_reduce
    from sklearn.manifold import trustworthiness

    from betavae_tpu_torch.eval import tsne
    from betavae_tpu_torch.eval.latent_viz import reduce_latents

    x = _tsne_points()
    want = jax_reduce(x, method="tsne", n_components=2)
    got = reduce_latents(x, method="tsne", n_components=2)
    assert got.shape == want.shape == (len(x), 2)
    p = tsne.joint_probabilities(x, tsne.default_perplexity(len(x)))
    kl = {name: tsne.kl_divergence(emb.astype(np.float32).ravel(), p, 1,
                                   2)[0]
          for name, emb in (("port", got), ("jax", want))}
    assert kl["port"] == pytest.approx(kl["jax"], rel=0.05), kl
    for k in (5, 30):
        t_port = trustworthiness(x, got, n_neighbors=k)
        t_jax = trustworthiness(x, want, n_neighbors=k)
        assert abs(t_port - t_jax) <= 0.02, (k, t_port, t_jax)
        assert t_port > 0.9
