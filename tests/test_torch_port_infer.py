"""The port's inference toolchain against the JAX package's, on the CPU.

One checkpoint written by the JAX package (random weights from a seed in
its flat layout, a tiny fp32 config: 32 px, 2 blocks, base 8, latent 8)
is read by both packages.  Held to the JAX functions:

- ``ops/metrics.py`` (MSE, PSNR, SSIM), 1e-5, with a constant image (the
  dynamic range floored at 1) and an exact reconstruction (PSNR 99),
- ``decode``, ``traverse`` and the deterministic ``sample_forward``, 1e-4
  relative (fp32 convolutions summed in another order),
- ``encode_dataset`` / ``write_embeddings``: μ and logσ² 1e-4 relative,
  the CSV's header, paths and labels equal,
- ``edit_tumor_factor`` and ``interpolate``: the PNGs within one level of
  255 per pixel,
- ``build_report``: AUCs, ``kl_mean``, ``mu_var`` and the correlation
  pairs 1e-9 (the same closed forms in float64), the logistic weights
  1e-3·max|coef| (scikit-learn fits float32 latents in float32, the port in
  float64), the orders, top dims and CSV columns equal.

The sampling forward's ε is the Philox stream at ``(seed, offset)``,
bitwise, and a prior sample decodes the stream at ``(seed, 0)``.  Every
CLI raises by default where there is no GPU.
"""

import csv
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.data.dataset import build_datasets as jax_build_datasets
from betavae_tpu.eval.run_evaluation import load_model as jax_load_model
from betavae_tpu.infer import encode as jax_encode
from betavae_tpu.infer import generate as jax_generate
from betavae_tpu.infer import latent_analysis as jax_analysis
from betavae_tpu.io.checkpoint import flatten_pytree
from betavae_tpu.io.checkpoint import save_sharded_checkpoint as jax_save
from betavae_tpu.models.beta_vae import model_from_config as jax_model_from
from betavae_tpu.ops import metrics as jax_metrics

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.data.dataset import build_datasets
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.eval import run_evaluation
from betavae_tpu_torch.eval.run_evaluation import load_model
from betavae_tpu_torch.infer import encode, generate, latent_analysis
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.models.beta_vae import sample_forward
from betavae_tpu_torch.ops import metrics
from betavae_tpu_torch.ops.elbo import philox_normal, reparam_kl_reference

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-5
IMG = 32


def _config(root: Path, name: str = "config.yaml", outputs: str = "outputs",
            **overrides) -> str:
    """A tiny fp32 multiclass config over the demo data under
    ``root/processed`` and the checkpoints under ``root/models``, its other
    outputs under ``root/<outputs>``; ``overrides`` are ``section.key``
    values."""
    cfg = yaml.safe_load(open(ROOT / "configs" / "beta_vae_se_debug.yaml"))
    out = root / outputs
    cfg["paths"].update(
        processed_dir=str(root / "processed"), outputs_dir=str(out),
        models_dir=str(root / "models"), figures_dir=str(out / "figures"),
        tables_dir=str(out / "tables"), run_id="run")
    cfg["data"].update(image_size=IMG, class_mode="multiclass")
    cfg["model"].update(latent_dim=8, base_channels=8, num_blocks=2,
                        se_reduction_ratio=2)
    cfg["training"].update(batch_size=4, mixed_precision=False)
    cfg["loss"].update(use_lpips=False)
    cfg["logging"]["log_to_file"] = False
    cfg["inference"]["tumor_latent_index"] = 1
    for key, val in overrides.items():
        sec, key_ = key.split(".")
        cfg[sec][key_] = val
    root.mkdir(parents=True, exist_ok=True)
    if not (root / "processed").exists():
        generate_demo_data(root / "processed", train_per_class=6,
                           test_per_class=5, size=IMG)
    path = root / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _random_flat(template, seed: int) -> dict:
    """Every leaf of the JAX variables drawn from a seed."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in flatten_pytree(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), template)).items():
        a = rng.normal(0.0, 0.3, np.shape(v)).astype(np.float32)
        if k.endswith("/var") or k.endswith("/scale"):
            a = np.abs(a) + 0.5
        flat[k] = a
    return flat


def write_jax_checkpoint(path: str, tag: str = "best", seed: int = 0) -> None:
    """A checkpoint of the config at ``path`` written by the JAX package."""
    jax_reset_config()
    try:
        cfg = jax_get_config(path)
        flat = _random_flat(jax_model_from(cfg).variables_template(), seed)
        jax_save(os.path.join(cfg.paths.models_dir,
                              f"{cfg.paths.run_id}_{tag}.pt"),
                 {"epoch": 1, "total_steps": 1, "model_state": flat})
    finally:
        jax_reset_config()


def jax_loaded(path: str):
    """The JAX package's ``(model, variables)`` from its ``load_model``,
    the config at ``path`` active."""
    jax_reset_config()
    jax_get_config(path)
    return jax_load_model("best")


def port_loaded(path: str):
    reset_config_cache()
    get_config(path)
    return load_model("best", device="cpu")


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def read_csv(path) -> tuple:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(autouse=True)
def _fresh_port_config():
    reset_config_cache()
    reset_logger()
    yield
    reset_config_cache()
    reset_logger()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One JAX-written checkpoint; the JAX config and the port's write
    their outputs to separate directories."""
    root = tmp_path_factory.mktemp("infer")
    jax_path = _config(root, "jax.yaml", "jax_out")
    write_jax_checkpoint(jax_path)
    return {"root": root, "jax": jax_path,
            "port": _config(root, "port.yaml", "port_out")}


def _image_pairs():
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(3, IMG, IMG, 1)).astype(np.float32)
    recon = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    const = np.full((2, IMG, IMG, 1), 0.4, np.float32)
    return {"noisy": (recon, x), "constant_recon": (const, x[:2]),
            "exact": (x, x.copy())}


@pytest.mark.parametrize("case", ["noisy", "constant_recon", "exact"])
def test_image_metrics_match_jax(case):
    recon, x = _image_pairs()[case]
    want = jax_metrics.batched_image_metrics(recon, x)
    got = metrics.batched_image_metrics(nchw(recon), nchw(x))
    for key in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    if case == "exact":
        assert (got["psnr"].numpy() == 99.0).all()
    for name in ("mse", "psnr"):
        np.testing.assert_allclose(
            float(getattr(metrics, name)(nchw(recon[:1]), nchw(x[:1]))),
            float(getattr(jax_metrics, name)(recon[:1], x[:1])), rtol=1e-5)
    np.testing.assert_allclose(
        float(metrics.ssim(nchw(recon)[0], nchw(x)[0])),
        float(jax_metrics.ssim(recon[0], x[0])), rtol=1e-5, atol=1e-5)


def test_decode_traverse_and_deterministic_forward_match_jax(ckpt):
    jmodel, variables = jax_loaded(ckpt["jax"])
    model = port_loaded(ckpt["port"])
    x = np.random.default_rng(1).uniform(size=(3, IMG, IMG, 1)).astype(
        np.float32)
    z = np.random.default_rng(2).normal(size=(5, 8)).astype(np.float32)
    with torch.no_grad():
        got = nhwc(model.decode(torch.from_numpy(z)))
    np.testing.assert_allclose(got, np.asarray(jmodel.decode(variables, z)),
                               rtol=RTOL, atol=ATOL)

    frames, vals = model.traverse(nchw(x), dim=2, steps=5, span=2.0)
    jframes, jvals = jmodel.traverse(variables, x, dim=2, steps=5, span=2.0)
    assert frames.shape == (3, 5, 1, IMG, IMG)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6)
    np.testing.assert_allclose(frames.permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(jframes), rtol=RTOL, atol=ATOL)

    recon, mu, logvar, z = sample_forward(model, nchw(x), seed=3, offset=1,
                                          deterministic=True)
    jrecon, jmu, jlogvar, jz = jmodel.forward(variables, x,
                                              deterministic=True)
    for a, b in ((nhwc(recon), jrecon), (mu, jmu), (logvar, jlogvar),
                 (z, jz)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_sampling_draws_the_philox_stream(ckpt):
    model = port_loaded(ckpt["port"])
    assert not model.deterministic and not model.training
    x = nchw(np.random.default_rng(1).uniform(size=(3, IMG, IMG, 1)).astype(
        np.float32))
    model.train()
    recon, mu, logvar, z = sample_forward(model, x, seed=7, offset=2)
    assert model.training            # the caller's mode comes back
    eps = philox_normal(mu.shape, 7, 2)
    want, _ = reparam_kl_reference(mu, logvar, eps)
    assert torch.equal(z, want)
    assert not torch.equal(sample_forward(model, x, 7, 3)[3], z)
    with torch.no_grad():
        assert torch.equal(recon, model.eval().decode(z))
        prior = model.decode(philox_normal((4, 8), 11, 0))
    assert torch.equal(model.sample_prior(4, 11), prior)
    # deterministic defaults to the config's deterministic_overfit
    model.deterministic = True
    assert torch.equal(sample_forward(model, x, 7, 2)[3], mu)


def test_encode_dataset_and_embeddings_match_jax(ckpt):
    jmodel, variables = jax_loaded(ckpt["jax"])
    _, jtest = jax_build_datasets()
    jz, jlv, jlabels, jpaths = jax_encode.encode_dataset(jmodel, variables,
                                                         jtest)
    jcsv = jax_encode.write_embeddings(jz, jlv, jlabels, jpaths,
                                       "test_latents")
    model = port_loaded(ckpt["port"])
    _, test = build_datasets()
    z, lv, labels, paths = encode.encode_dataset(model, test)
    path = encode.write_embeddings(z, lv, labels, paths, "test_latents")
    np.testing.assert_allclose(z, jz, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lv, jlv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.load(Path(path).parent / "test_latents_mu.npy"),
                               jz, rtol=RTOL, atol=ATOL)
    (head, rows), (jhead, jrows) = read_csv(path), read_csv(jcsv)
    assert head == jhead == ["path", "label"] + [f"z{i}" for i in range(8)]
    assert [r[:2] for r in rows] == [r[:2] for r in jrows]
    np.testing.assert_allclose(np.array([r[2:] for r in rows], float),
                               np.array([r[2:] for r in jrows], float),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("png", ["edit_dim1.png", "interpolation.png"])
def test_edit_and_interpolation_pngs_match_jax(ckpt, png):
    jmodel, variables = jax_loaded(ckpt["jax"])
    jcfg = jax_get_config()
    _, jtest = jax_build_datasets()
    model = port_loaded(ckpt["port"])
    cfg = get_config()
    _, test = build_datasets()
    # the JAX functions take float images in [0, 1], the port's the
    # packed uint8 ones
    packed = test.images
    imgs = packed.astype(np.float32) / 255.0
    steps, bs = int(cfg.evaluation.traversal_steps), 4
    if png.startswith("edit"):
        jax_generate.edit_tumor_factor(jmodel, variables, imgs[:bs], 1, steps,
                                       3.0, jcfg.paths.figures_dir)
        generate.edit_tumor_factor(model, packed[:bs], 1, steps, 3.0,
                                   cfg.paths.figures_dir)
    else:
        jax_generate.interpolate(jmodel, variables, imgs[:1],
                                 imgs[bs:bs + 1], steps,
                                 jcfg.paths.figures_dir)
        generate.interpolate(model, packed[:1], packed[bs:bs + 1], steps,
                             cfg.paths.figures_dir)
    got = np.asarray(Image.open(Path(cfg.paths.figures_dir) / png), np.int16)
    want = np.asarray(Image.open(Path(jcfg.paths.figures_dir) / png),
                      np.int16)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def _report_inputs(k: int):
    """Seeded latents (float32, as the encoder gives them), per-dim KL and
    labels in which some dims carry the class."""
    rng = np.random.default_rng(10 + k)
    n, d = 40, 8
    y = np.arange(n) % k
    L = rng.normal(size=(n, d)).astype(np.float32)
    L[:, 1] += 1.5 * y
    L[:, 4] -= 0.8 * (y == k - 1)
    logvar = rng.normal(-1.0, 0.5, size=(n, d)).astype(np.float32)
    K = 0.5 * (L ** 2 + np.exp(logvar) - logvar - 1.0)
    return L, K, y.astype(np.int32)


@pytest.mark.parametrize("k", [4, 2])
def test_build_report_matches_jax(tmp_path, k):
    L, K, y = _report_inputs(k)
    names = ({0: "glioma", 1: "meningioma", 2: "notumor", 3: "pituitary"}
             if k == 4 else {0: "healthy", 1: "tumor"})
    jax_reset_config()
    jax_get_config(_config(tmp_path, "jax.yaml", "jax_out"))
    want = jax_analysis.build_report(L, K, y, names)
    get_config(_config(tmp_path, "port.yaml", "port_out"))
    got = latent_analysis.build_report(L, K, y, names)

    for key in ("traversal_order_auc", "traversal_order_kl",
                "best_auc_dim", "best_abs_auc_dim", "class_balance"):
        assert got[key] == want[key], key
    for key in ("best_auc", "best_abs_auc"):
        assert got[key] == pytest.approx(want[key], abs=1e-9)
    assert [p["i"] for p in got["top_corr_pairs"]] == \
        [p["i"] for p in want["top_corr_pairs"]]
    np.testing.assert_allclose([p["corr"] for p in got["top_corr_pairs"]],
                               [p["corr"] for p in want["top_corr_pairs"]],
                               atol=1e-9)
    assert [d["latent_dim"] for d in got["top_logreg_dims"]] == \
        [d["latent_dim"] for d in want["top_logreg_dims"]]

    _, jcoef, jclasses = jax_analysis.logistic_weights(L, y)
    _, coef, classes = latent_analysis.logistic_weights(L, y)
    assert list(classes) == list(jclasses) and coef.shape == jcoef.shape
    np.testing.assert_allclose(coef, jcoef, atol=1e-3 * np.abs(jcoef).max())

    for table in ("per_dimension_auc", "latent_usage", "latent_corr_pairs"):
        head, rows = read_csv(tmp_path / "port_out" / "tables" / f"{table}.csv")
        jhead, jrows = read_csv(tmp_path / "jax_out" / "tables" / f"{table}.csv")
        assert head == jhead, table
        got_v = np.array(rows, float)
        want_v = np.array(jrows, float)
        weights = [i for i, h in enumerate(head) if h.startswith("logreg")]
        exact = [i for i in range(len(head)) if i not in weights]
        np.testing.assert_allclose(got_v[:, exact], want_v[:, exact],
                                   rtol=0, atol=1e-9, err_msg=table)
        np.testing.assert_allclose(got_v[:, weights], want_v[:, weights],
                                   atol=1e-3 * np.abs(jcoef).max())


def test_every_cli_raises_without_a_gpu_by_default(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for mod in (run_evaluation, encode, generate, latent_analysis):
        reset_config_cache()
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(["--config", ckpt["port"]])
