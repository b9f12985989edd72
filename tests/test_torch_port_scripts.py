"""The port's remaining CLIs against the JAX package's, on the CPU.

A tiny fp32 geometry (16 px, 2 blocks, base 4, latent 6, SE ratio 2: the
interop test's), the seeded demo data, and checkpoints the JAX package
writes (``init_variables`` for the reshard; random normal leaves from a
seed for the model CLIs, so that decodes are not flat).  Held to the JAX
scripts or the library functions they call:

- ``preprocess_data``: both layouts (class folders, split 80/20 by the
  seed; ``Training/Testing``, copied through) in both modes; both packages
  read the same raw tree (the split shuffles the directory listing, whose
  order a copy need not keep) and must write the same file lists, the
  same PNG bytes, and ``norm_stats.json`` equal to 1e-12;
- ``reshard_checkpoint``: a JAX-written and a port-written checkpoint
  resharded by the port read back bitwise in the JAX package; a
  reference torch-shard set resharded by each package reads back to the
  same model state, the port's keeping the Adam state; fewer shards raise
  ``would not grow``;
- ``preview_val_batch``: the manifest byte-equal, the grid PNG bitwise;
- ``traverse_image``: every figure the JAX script writes, within one
  level of 255 a pixel (the PNG tolerance of ``test_torch_port_eval.py``:
  fp32 convolutions summed in another order);
- ``diag_overfit``: every key 1e-4 relative under
  ``model.deterministic_overfit``; with sampling on, the ε-free keys 1e-4,
  the others bounded as ``test_diag_overfit_sampling`` states;
- ``diag_overfit`` on ``configs/overfit_capacity.yaml`` over a 128 px
  tree read at its 256 px: the batches it reads are the JAX package's
  bytes (the native decoder's resize), and its JSON is finite;
- ``convert_lpips_weights``: equal keys and bitwise arrays, loaded
  strictly by the port;
- ``generate_demo_data``: the same bytes;
- ``generate_umap_and_grid``: the columns of a traversal figure bitwise
  the JAX script's cut, the GIF's frame count and size, and the grid's
  layout (a row a figure, 7 columns);
- every JAX CLI (``scripts/*.py``, ``bench.py`` and the four evaluation
  and inference modules): each string its parser's ``add_argument`` calls
  take is one of its port counterpart's, the exceptions by design listed
  with their reasons (``NO_COUNTERPART``, ``FLAGS_BY_DESIGN``); and every
  module of ``betavae_tpu`` has its counterpart in ``betavae_tpu_torch``
  but those listed in ``NO_COUNTERPART``.
"""

import ast
import importlib
import json
import os
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.data import preprocess as jax_preprocess
from betavae_tpu.io.checkpoint import flatten_pytree
from betavae_tpu.io.checkpoint import load_sharded_checkpoint as jax_load
from betavae_tpu.io.checkpoint import save_sharded_checkpoint as jax_save
from betavae_tpu.models.beta_vae import model_from_config as jax_model_from
from test_torch_port_infer import _random_flat

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.io.checkpoint import (discover_shards,
                                             load_sharded_checkpoint,
                                             save_sharded_checkpoint,
                                             save_torch_reference_checkpoint)
from betavae_tpu_torch.io.weights import (export_model_state,
                                          reference_param_order)
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.models.beta_vae import model_from_config
from betavae_tpu_torch.ops.lpips import load_lpips_module
from betavae_tpu_torch.scripts import (convert_lpips_weights, diag_overfit,
                                       generate_demo_data as demo_cli,
                                       generate_umap_and_grid,
                                       preprocess_data, preview_val_batch,
                                       reshard_checkpoint, traverse_image)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = str(ROOT / "scripts")
IMG = 16
CLASSES = ("glioma", "meningioma", "notumor", "pituitary")


def _config(root: Path, name: str, outputs: str, **overrides) -> str:
    """The tiny fp32 multiclass config: raw data under ``root/raw``, the
    checkpoints under ``root/models``, the rest under ``root/<outputs>``;
    ``overrides`` are ``section.key`` values."""
    cfg = yaml.safe_load(open(ROOT / "configs" / "beta_vae_se_debug.yaml"))
    out = root / outputs
    cfg["paths"].update(
        raw_dir=str(root / "raw"), processed_dir=str(root / "processed"),
        outputs_dir=str(out), models_dir=str(root / "models"),
        figures_dir=str(out / "figures"), tables_dir=str(out / "tables"),
        run_id="run")
    cfg["data"].update(image_size=IMG, class_mode="multiclass")
    cfg["model"].update(latent_dim=6, base_channels=4, num_blocks=2,
                        se_reduction_ratio=2)
    cfg["training"].update(batch_size=4, mixed_precision=False)
    cfg["loss"].update(use_lpips=False)
    cfg["logging"]["log_to_file"] = False
    for key, val in overrides.items():
        sec, key_ = key.split(".")
        cfg[sec][key_] = val
    root.mkdir(parents=True, exist_ok=True)
    path = root / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(autouse=True)
def _fresh_configs():
    reset_config_cache()
    reset_logger()
    jax_reset_config()
    yield
    reset_config_cache()
    reset_logger()
    jax_reset_config()
    os.environ.pop("CONFIG_PATH", None)


def _jax_script(name: str, argv: list, monkeypatch):
    """Run ``scripts/<name>.py``'s ``main`` with ``argv``."""
    monkeypatch.syspath_prepend(SCRIPTS)
    mod = importlib.import_module(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    jax_reset_config()
    try:
        return mod.main()
    finally:
        os.environ.pop("CONFIG_PATH", None)
        jax_reset_config()


def _files(root) -> dict:
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------------------
# preprocess_data
# ---------------------------------------------------------------------------

def _raw_tree(root: Path, layout: str) -> None:
    """Four classes of 7 images at 24 px (PNG, one JPEG, one RGB PNG) and
    files that are not images; as class folders or as Training/Testing."""
    rng = np.random.default_rng(3)
    for ci, cls in enumerate(CLASSES):
        for i in range(7):
            split = ("Training" if i < 5 else "Testing") \
                if layout == "presplit" else ""
            d = root / split / cls
            d.mkdir(parents=True, exist_ok=True)
            arr = rng.integers(0, 256, (24, 24), np.uint8) // (ci + 1)
            if i == 3:
                Image.fromarray(arr).save(d / f"{cls}_{i}.jpg", quality=90)
            elif i == 4:
                Image.fromarray(np.stack([arr, arr // 2, 255 - arr], -1)).save(
                    d / f"{cls}_{i}.png")
            else:
                Image.fromarray(arr).save(d / f"{cls}_{i}.png")
        (root / ("Training" if layout == "presplit" else "") / cls
         / "notes.txt").write_text("not an image")
    (root / "README.txt").write_text("not a class")


@pytest.mark.parametrize("mode", ["minmax", "global_z"])
@pytest.mark.parametrize("layout", ["class_folders", "presplit"])
def test_preprocess_matches_jax(tmp_path, monkeypatch, layout, mode):
    _raw_tree(tmp_path / "raw", layout)
    out = {}
    for pkg in ("jax", "port"):
        work = tmp_path / pkg
        cfg_path = _config(tmp_path, f"{pkg}.yaml", f"{pkg}_out",
                           **{"paths.processed_dir": str(work / "processed")})
        work.mkdir()
        monkeypatch.chdir(work)         # norm_stats.json is cwd-relative
        if pkg == "jax":
            jax_get_config(cfg_path)
            jax_preprocess.split_from_raw()
            jax_preprocess.preprocess_dataset(
                compute_stats=mode == "global_z", normalization_mode=mode)
            assert jax_preprocess.verify_processed()
        else:
            seconds = preprocess_data.main(["--config", cfg_path,
                                            "--normalization", mode])
            assert set(seconds) == {"split", "preprocess", "verify"}
        out[pkg] = _files(work)
    assert list(out["port"]) == list(out["jax"])
    counts = {cls: sum(f.startswith(f"processed/train/{cls}/")
                       for f in out["port"]) for cls in CLASSES}
    assert counts == {cls: 5 for cls in CLASSES}     # floor(0.8·7), or 5 given
    stats = "data/intermediate/norm_stats.json"
    assert (stats in out["port"]) == (mode == "global_z")
    for name, data in out["port"].items():
        if name == stats:
            got, want = json.loads(data), json.loads(out["jax"][name])
            for k in ("mean", "std"):
                assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12)
        else:
            assert data == out["jax"][name], name
            with Image.open(tmp_path / "port" / name) as im:
                assert im.size == (IMG, IMG) and im.mode == "L"


# ---------------------------------------------------------------------------
# reshard_checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt_cfg(tmp_path):
    return _config(tmp_path, "config.yaml", "outputs")


def _jax_init_checkpoint(cfg_path: str, tag: str = "latest") -> dict:
    jcfg = jax_get_config(cfg_path)
    flat = flatten_pytree(jax_model_from(jcfg).init_variables(
        jax.random.PRNGKey(0)))
    jax_save(os.path.join(jcfg.paths.models_dir, f"run_{tag}.pt"),
             {"epoch": 2, "total_steps": 7, "val_total": 1.5,
              "model_state": flat}, num_shards=2)
    jax_reset_config()
    return flat


def _assert_states_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), k)


def test_reshard_of_a_jax_checkpoint_reads_back_in_jax(ckpt_cfg, tmp_path):
    flat = _jax_init_checkpoint(ckpt_cfg)
    out = str(tmp_path / "out" / "resharded")
    written = reshard_checkpoint.main(["--config", ckpt_cfg, "--checkpoint",
                                       "latest", "--num-shards", "3",
                                       "--output", out])
    assert written == discover_shards(out + ".pt") and len(written) == 3
    back = jax_load(out + ".pt")
    assert (back["epoch"], back["total_steps"], back["val_total"]) == (2, 7, 1.5)
    _assert_states_equal(back["model_state"], flat)


def test_reshard_of_a_port_checkpoint_reads_back_in_jax(ckpt_cfg, tmp_path):
    cfg = get_config(ckpt_cfg)
    state = {k: v.numpy() for k, v in
             model_from_config(cfg, device="cpu").state_dict().items()}
    base = os.path.join(cfg.paths.models_dir, "run_best.pt")
    save_sharded_checkpoint(base, {"epoch": 1, "total_steps": 3,
                                   "model_state": state})
    want = jax_load(base)["model_state"]            # torch names → flax
    reshard_checkpoint.main(["--config", ckpt_cfg, "--checkpoint", "best",
                             "--num-shards", "5"])  # in place
    assert len(discover_shards(base)) == 5
    _assert_states_equal(jax_load(base)["model_state"], want)
    _assert_states_equal(load_sharded_checkpoint(base)["model_state"], state)


def test_reshard_of_reference_torch_shards(ckpt_cfg, tmp_path):
    cfg = get_config(ckpt_cfg)
    state = {k: v.numpy() for k, v in
             model_from_config(cfg, device="cpu").state_dict().items()}
    exported = export_model_state(state)
    rng = np.random.default_rng(2)
    optim = {"state": {i: {"step": torch.tensor(4.0),
                           "exp_avg": torch.from_numpy(rng.normal(
                               size=exported[name].shape).astype(np.float32)),
                           "exp_avg_sq": torch.from_numpy(rng.uniform(
                               size=exported[name].shape).astype(np.float32))}
                       for i, name in enumerate(
                           reference_param_order(exported))},
             "param_groups": [{"lr": 1e-3, "params": []}]}
    src = os.path.join(cfg.paths.models_dir, "run_latest.pt")
    save_torch_reference_checkpoint(src, {"epoch": 3, "total_steps": 9,
                                          "model_state": state},
                                    optim_state=optim)
    original = load_sharded_checkpoint(src)
    port_out, jax_out = (str(tmp_path / f"{p}_out.pt") for p in ("port", "jax"))
    reshard_checkpoint.main(["--config", ckpt_cfg, "--checkpoint", src,
                             "--num-shards", "3", "--output", port_out])
    jax_save(jax_out, jax_load(src, num_shards=2), num_shards=3)
    got, want = jax_load(port_out), jax_load(jax_out)
    assert (got["epoch"], got["total_steps"]) == (want["epoch"],
                                                  want["total_steps"])
    _assert_states_equal(got["model_state"], want["model_state"])
    back = load_sharded_checkpoint(port_out)
    _assert_states_equal(back["reference_optim_state"],
                         original["reference_optim_state"])
    _assert_states_equal(back["model_state"], original["model_state"])


def test_reshard_refuses_to_shrink(ckpt_cfg):
    _write_random_checkpoint(ckpt_cfg, "latest")
    for n in ("2", "1"):
        with pytest.raises(ValueError, match="would not grow"):
            reshard_checkpoint.main(["--config", ckpt_cfg, "--num-shards", n])
    with pytest.raises(FileNotFoundError):
        reshard_checkpoint.main(["--config", ckpt_cfg, "--checkpoint",
                                 "best", "--num-shards", "4"])


# ---------------------------------------------------------------------------
# the CLIs over data and a model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scripts")
    generate_demo_data(root / "processed", train_per_class=6,
                       test_per_class=3, size=IMG)
    return root


def test_preview_val_batch_matches_jax(data_root, monkeypatch):
    paths = {p: _config(data_root, f"preview_{p}.yaml", f"preview_{p}")
             for p in ("jax", "port")}
    _jax_script("preview_val_batch", ["--config", paths["jax"]], monkeypatch)
    grid, manifest = preview_val_batch.main(["--config", paths["port"]])
    want = data_root / "preview_jax" / "figures"
    assert manifest.read_bytes() == (want / manifest.name).read_bytes()
    assert manifest.name == "val_preview_seed42_paths.txt"
    assert len(manifest.read_text().splitlines()) == 4
    with Image.open(grid) as a, Image.open(want / grid.name) as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _write_random_checkpoint(cfg_path: str, tag: str, seed: int = 0,
                             logvar_bias: float | None = None) -> None:
    """Random normal leaves from a seed, written by the JAX package; with
    ``logvar_bias``, ``fc_logvar`` is that constant (σ = exp(bias / 2))."""
    jcfg = jax_get_config(cfg_path)
    flat = _random_flat(jax_model_from(jcfg).variables_template(), seed)
    if logvar_bias is not None:
        flat["params/fc_logvar/kernel"][:] = 0.0
        flat["params/fc_logvar/bias"][:] = logvar_bias
    jax_save(os.path.join(jcfg.paths.models_dir, f"run_{tag}.pt"),
             {"epoch": 1, "total_steps": 1, "model_state": flat})
    jax_reset_config()


def test_traverse_image_matches_jax(data_root, monkeypatch):
    paths = {p: _config(data_root, f"trav_{p}.yaml", f"trav_{p}",
                        **{"paths.models_dir": str(data_root / "trav_models")})
             for p in ("jax", "port")}
    _write_random_checkpoint(paths["jax"], "best", seed=1)
    # the same class directions for both (the fresh-probe fallback is held
    # to scikit-learn in test_torch_port_eval.py)
    for p in ("jax", "port"):
        tables = data_root / f"trav_{p}" / "tables"
        tables.mkdir(parents=True)
        with open(tables / "latent_usage.csv", "w") as f:
            f.write("dim,kl_mean," + ",".join(
                f"logreg_weight_{c}" for c in CLASSES)
                + ",logreg_weight_maxabs\n")
            for d, w in enumerate(np.random.default_rng(7).normal(
                    size=(6, 4))):
                f.write(f"{d},0.5," + ",".join(repr(float(v)) for v in w)
                        + f",{float(abs(w).max())!r}\n")
    image = str(sorted((data_root / "processed" / "test" / "glioma").iterdir())[0])
    argv = ["--image", image, "--indices", "0,2", "--steps", "3",
            "--span", "2.5"]
    _jax_script("traverse_image", ["--config", paths["jax"], *argv],
                monkeypatch)
    traverse_image.main(["--config", paths["port"], *argv, "--device", "cpu"])
    want_dir = data_root / "trav_jax" / "figures"
    names = sorted(os.listdir(want_dir))
    assert names == ["traversal_dim0.png", "traversal_dim2.png",
                     "traversal_tumor_glioma.png",
                     "traversal_tumor_meningioma.png",
                     "traversal_tumor_pituitary.png"]
    assert sorted(os.listdir(data_root / "trav_port" / "figures")) == names
    for name in names:
        with Image.open(want_dir / name) as a, \
                Image.open(data_root / "trav_port" / "figures" / name) as b:
            want, got = np.asarray(a, np.int16), np.asarray(b, np.int16)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, name
        assert want.std() > 1.0, name       # the decodes are not flat


def _diag(data_root, monkeypatch, capsys, name: str, **overrides) -> tuple:
    paths = {p: _config(data_root, f"{name}_{p}.yaml", f"{name}_{p}",
                        **{"paths.models_dir": str(data_root / f"{name}_m"),
                           **overrides})
             for p in ("jax", "port")}
    _write_random_checkpoint(paths["jax"], "latest", seed=2, logvar_bias=-10.0)
    capsys.readouterr()
    _jax_script("diag_overfit", ["--config", paths["jax"]], monkeypatch)
    want = json.loads(capsys.readouterr().out)
    got = diag_overfit.main(["--config", paths["port"], "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert list(got) == list(want)
    return got, want


EPS_FREE = ("mu_mean", "mu_std", "logvar_mean", "logvar_std", "x_min", "x_max")


def test_diag_overfit_deterministic(data_root, monkeypatch, capsys):
    got, want = _diag(data_root, monkeypatch, capsys, "diag_det",
                      **{"model.deterministic_overfit": True})
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    assert got["z_mean"] == got["mu_mean"] and got["z_std"] == got["mu_std"]


def test_diag_overfit_sampling(data_root, monkeypatch, capsys):
    """z = μ + σ·ε with σ = exp(−10 / 2) = 0.00674 for every entry (the
    checkpoint's ``fc_logvar`` is the constant −10, the clamp's floor), and
    the two packages draw independent ε.  Over the 4 × 6 entries of the
    statistics batch, |Δ mean z| ≤ σ·(|mean ε₁| + |mean ε₂|) and |Δ std z|
    ≤ σ·rms(ε₁ − ε₂) (std is 1-Lipschitz in rms); both stay under 3σ =
    0.0202 but with odds below 1e-9.  A shift of z by ~σ moves the
    decodes' MSE and range by far less than 1 %: bounded at 1e-2
    relative."""
    got, want = _diag(data_root, monkeypatch, capsys, "diag_sto")
    det, _ = _diag(data_root, monkeypatch, capsys, "diag_det2",
                   **{"model.deterministic_overfit": True})
    for k in EPS_FREE:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    sigma = float(np.exp(-10.0 / 2))
    for k in ("z_mean", "z_std"):
        assert abs(got[k] - want[k]) <= 3 * sigma, k
    for k in ("train_mse_mean", "val_mse_mean", "r_min", "r_max"):
        assert got[k] == pytest.approx(want[k], rel=1e-2), k
    assert got["z_mean"] != det["z_mean"]          # ε was drawn


# ---------------------------------------------------------------------------
# convert_lpips_weights, generate_demo_data
# ---------------------------------------------------------------------------

_ALEX_SHAPES = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                (256, 384, 3, 3), (256, 256, 3, 3)]


@pytest.mark.parametrize("lin_index", [1, 0])
def test_convert_lpips_weights_matches_jax(tmp_path, monkeypatch, lin_index):
    rng = np.random.default_rng(0)
    feats = {}
    for ti, shape in zip((0, 3, 6, 8, 10), _ALEX_SHAPES):
        feats[f"features.{ti}.weight"] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))
        feats[f"features.{ti}.bias"] = torch.from_numpy(
            rng.normal(size=shape[0]).astype(np.float32))
    lins = {f"lin{i}.model.{lin_index}.weight": torch.from_numpy(np.abs(
        rng.normal(size=(1, s[0], 1, 1))).astype(np.float32))
        for i, s in enumerate(_ALEX_SHAPES)}
    torch.save(feats, tmp_path / "alexnet.pth")
    torch.save(lins, tmp_path / "alex.pth")
    monkeypatch.syspath_prepend(SCRIPTS)
    jax_conv = importlib.import_module("convert_lpips_weights")
    want = jax_conv.convert(str(tmp_path / "alexnet.pth"),
                            str(tmp_path / "alex.pth"),
                            str(tmp_path / "jax" / "lpips.npz"))
    got = convert_lpips_weights.main([
        "--alexnet", str(tmp_path / "alexnet.pth"),
        "--linear", str(tmp_path / "alex.pth"),
        "--out", str(tmp_path / "port" / "lpips.npz")])
    with np.load(want) as a, np.load(got) as b:
        assert sorted(b.files) == sorted(a.files)
        for k in a.files:
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k], k)
    with warnings.catch_warnings():
        warnings.simplefilter("error")              # no random-init fallback
        module = load_lpips_module(got)
    np.testing.assert_array_equal(
        module.net.convs[1].weight.numpy(), feats["features.3.weight"].numpy())


def test_generate_demo_data_cli_matches_jax(tmp_path, monkeypatch):
    paths = {p: _config(tmp_path, f"{p}.yaml", f"{p}_out",
                        **{"paths.processed_dir": str(tmp_path / p)})
             for p in ("jax", "port")}
    argv = ["--train-per-class", "2", "--test-per-class", "1"]
    _jax_script("generate_demo_data", ["--config", paths["jax"], *argv],
                monkeypatch)
    demo_cli.main(["--config", paths["port"], *argv])
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(got) == 12 and got == want


# ---------------------------------------------------------------------------
# diag_overfit on the overfit config, generate_umap_and_grid
# ---------------------------------------------------------------------------

def test_diag_overfit_on_the_overfit_config_reads_the_jax_bytes(
        tmp_path, capsys):
    """``configs/overfit_capacity.yaml`` as it is (binary, base 32, SE 16,
    ``deterministic_overfit``, batch 8, its debug limits of 8 and 8) over a
    tree stored at 128 px, so that every image is resized to its 256 px:
    the batches ``diag_overfit`` reads (``build_datasets`` with those
    limits) are the JAX package's bytes, taken by the native decoder on
    both sides, and the port's JSON on a checkpoint of seeded weights is
    finite, with the input range of the first batch."""
    from betavae_tpu.data.dataset import build_datasets as jax_build

    from betavae_tpu_torch.data.dataset import build_datasets, decode_pil

    cfg = yaml.safe_load(open(ROOT / "configs" / "overfit_capacity.yaml"))
    cfg["paths"].update(processed_dir=str(tmp_path / "processed"),
                        outputs_dir=str(tmp_path / "outputs"),
                        models_dir=str(tmp_path / "models"),
                        figures_dir=str(tmp_path / "outputs" / "figures"),
                        tables_dir=str(tmp_path / "outputs" / "tables"))
    path = tmp_path / "overfit.yaml"
    path.write_text(yaml.safe_dump(cfg))
    generate_demo_data(tmp_path / "processed", train_per_class=3,
                       test_per_class=3, size=128)
    jax_get_config(str(path))
    want = jax_build(train_limit=8, test_limit=8)
    get_config(str(path))
    got = build_datasets(train_limit=8, test_limit=8)
    for g, w in zip(got, want):
        assert g.images.shape == (8, 256, 256, 1) and g.decoder == "native"
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
    assert not np.array_equal(got[0].images,
                              decode_pil(got[0].paths, 256, True))

    model = model_from_config(get_config(str(path)), device="cpu")
    torch.manual_seed(0)
    save_sharded_checkpoint(
        str(tmp_path / "models" / "overfit_capacity_latest.pt"),
        {"epoch": 1, "total_steps": 1, "model_state": {
            k: v.numpy() for k, v in model.state_dict().items()}})
    capsys.readouterr()
    stats = diag_overfit.main(["--config", str(path), "--device", "cpu"])
    assert all(np.isfinite(v) for v in stats.values())
    x = got[0].images[:8].astype(np.float32) / 255.0
    assert stats["x_min"] == float(x.min()) and \
        stats["x_max"] == float(x.max())
    assert stats["z_mean"] == stats["mu_mean"]     # deterministic_overfit


@pytest.mark.parametrize("width,cols", [(7, 7), (50, 7), (129, 7), (448, 3)])
def test_split_image_into_columns_is_the_jax_cut(monkeypatch, width, cols):
    monkeypatch.syspath_prepend(SCRIPTS)
    jax_script = importlib.import_module("generate_umap_and_grid")
    arr = np.random.default_rng(width).integers(0, 256, (20, width, 3),
                                                 np.uint8)
    img = Image.fromarray(arr)
    got = generate_umap_and_grid.split_image_into_columns(img, cols)
    want = jax_script.split_image_into_columns(img, cols)
    assert len(got) == len(want) == cols
    for g, w in zip(got, want):
        assert g.size == w.size
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_generate_umap_and_grid_writes_the_gif_and_the_grid(data_root):
    """On the CPU, with the JAX script's flags: the GIF has ``--frames``
    frames (60 by default) of the JAX figure's 600 × 500 pixels; the grid
    a row a ``traversal_*.png`` (two here) and 7 columns, its cells the
    figures' columns; ``--skip-gif`` and ``--skip-grid`` skip each."""
    path = _config(data_root, "umap.yaml", "umap",
                   **{"paths.models_dir": str(data_root / "umap_models")})
    _write_random_checkpoint(path, "best", seed=3)
    figures = data_root / "umap" / "figures"
    figures.mkdir(parents=True)
    strip = np.random.default_rng(0).integers(0, 256, (16, 7 * 16), np.uint8)
    for name in ("traversal_dim0.png", "traversal_dim1.png"):
        Image.fromarray(strip).save(figures / name)
    out = generate_umap_and_grid.main(["--config", path, "--device", "cpu"])
    with Image.open(out["gif"]) as gif:
        assert (gif.n_frames, gif.size) == (60, (600, 500))
    cell = generate_umap_and_grid.CELL
    with Image.open(out["grid"]) as grid:
        assert grid.size == (180 + 7 * cell, 36 + 24 + 2 * cell)
        arr = np.asarray(grid.convert("L"))
    # each cell's centre holds its column of the strip, enlarged
    for c in range(7):
        centre = arr[60 + cell // 2, 180 + cell * c + cell // 2]
        column = strip[:, 16 * c:16 * (c + 1)]
        assert column.min() <= centre <= column.max()

    out = generate_umap_and_grid.main(["--config", path, "--device", "cpu",
                                       "--frames", "5", "--skip-grid"])
    assert list(out) == ["gif"]
    with Image.open(out["gif"]) as gif:
        assert gif.n_frames == 5
    assert list(generate_umap_and_grid.main(
        ["--config", path, "--skip-gif"])) == ["grid"]


# ---------------------------------------------------------------------------
# every JAX CLI's flags have a counterpart in the port
# ---------------------------------------------------------------------------

# the JAX scripts that call a module's ``main`` (their ``MODULE``): the
# flags are that module's
JAX_WRAPPED = {"run_evaluation": "betavae_tpu/eval/run_evaluation.py",
               "encode": "betavae_tpu/infer/encode.py",
               "generate": "betavae_tpu/infer/generate.py",
               "latent_analysis": "betavae_tpu/infer/latent_analysis.py"}
# the port's counterpart of each JAX CLI that is not at the same path in
# ``betavae_tpu_torch`` or at ``betavae_tpu_torch/scripts/<name>.py``
PORT_CLI = {"scripts/train.py": "betavae_tpu_torch/train/__main__.py",
            "scripts/profile_step.py":
                "betavae_tpu_torch/utils/profile_step.py",
            "scripts/export_torch_checkpoint.py":
                "betavae_tpu_torch/io/export_torch_checkpoint.py",
            "bench.py": "betavae_tpu_torch/bench.py",
            **{f"scripts/{name}.py": path.replace("betavae_tpu/",
                                                  "betavae_tpu_torch/")
               for name, path in JAX_WRAPPED.items()}}
# by design, each with its reason
NO_COUNTERPART = {
    "scripts/xla_flag_sweep.py": "it times the JAX step under sets of "
                                 "LIBTPU_INIT_ARGS, the TPU runtime's XLA "
                                 "flags; the port runs no XLA",
    "betavae_tpu/utils/compile_cache.py": "JAX's persistent compilation "
                                          "cache; the port compiles only "
                                          "its CUDA sources, once, into "
                                          "build/kernels/"}
# the JAX package's modules whose port counterpart has another name
RENAMED = {"betavae_tpu/io/torch_compat.py": "betavae_tpu_torch/io/weights.py",
           "betavae_tpu/native/__init__.py":
               "betavae_tpu_torch/data/native.py",
           **{f"betavae_tpu/ops/pallas_{k}.py": f"betavae_tpu_torch/ops/{k}.py"
              for k in ("elbo", "gn", "head")}}
JAX_MODULES = sorted(str(p.relative_to(ROOT))
                     for p in (ROOT / "betavae_tpu").rglob("*.py"))
FLAGS_BY_DESIGN = {
    ("bench.py", "--scan-chunk"): "it sets K, the train steps a lax.scan "
                                  "dispatch runs; the port launches each "
                                  "step from the host"}
# the JAX scripts that take positional arguments from sys.argv, as the
# port's counterparts do
POSITIONAL_ONLY = {"scripts/fix_steps.py"}
JAX_CLIS = sorted(str(p.relative_to(ROOT)) for p in
                  (ROOT / "scripts").glob("*.py")
                  if p.name != "_bootstrap.py") + [
    "bench.py", *JAX_WRAPPED.values()]


def _argument_strings(path: Path) -> set:
    """The string arguments of every ``add_argument`` call in ``path``:
    option strings and positional names, also through an alias such as
    ``flag = parser.add_argument``."""
    tree = ast.parse(path.read_text(), str(path))
    aliases = {target.id for node in ast.walk(tree)
               if isinstance(node, ast.Assign)
               and isinstance(node.value, ast.Attribute)
               and node.value.attr == "add_argument"
               for target in node.targets if isinstance(target, ast.Name)}
    found = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if (isinstance(func, ast.Attribute) and func.attr == "add_argument") \
                or (isinstance(func, ast.Name) and func.id in aliases):
            found |= {arg.value for arg in node.args
                      if isinstance(arg, ast.Constant)
                      and isinstance(arg.value, str)}
    return found


def _jax_module(cli: str) -> str:
    """The file whose parser a JAX CLI runs: a wrapper's module, else the
    CLI itself."""
    source = (ROOT / cli).read_text()
    for name, path in JAX_WRAPPED.items():
        if cli == f"scripts/{name}.py":
            assert f'MODULE = "{name}"' in source, cli
            return path
    return cli


@pytest.mark.parametrize("cli", JAX_CLIS)
def test_every_jax_cli_flag_has_a_port_counterpart(cli):
    if cli in NO_COUNTERPART:
        name = Path(cli).stem
        assert not list((ROOT / "betavae_tpu_torch").rglob(f"{name}.py"))
        return
    port = PORT_CLI.get(cli)
    if port is None:
        same_path = cli.replace("betavae_tpu/", "betavae_tpu_torch/")
        port = same_path if cli.startswith("betavae_tpu/") else \
            f"betavae_tpu_torch/scripts/{Path(cli).name}"
    assert (ROOT / port).is_file(), f"{cli}: no {port}"
    want = _argument_strings(ROOT / _jax_module(cli))
    if not want:
        assert cli in POSITIONAL_ONLY, f"{cli}: no add_argument found"
    exempt = {flag for (path, flag) in FLAGS_BY_DESIGN if path == cli}
    assert exempt <= want, f"{cli}: a listed exception it does not have"
    missing = want - exempt - _argument_strings(ROOT / port)
    assert not missing, f"{port} lacks {sorted(missing)} of {cli}"


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_module_has_a_port_counterpart(module):
    """Each module of ``betavae_tpu`` has its counterpart at the same path
    in ``betavae_tpu_torch`` (or the one ``RENAMED`` names), but those
    without one by design (``NO_COUNTERPART``)."""
    if module in NO_COUNTERPART:
        name = Path(module).name
        assert not list((ROOT / "betavae_tpu_torch").rglob(name))
        return
    port = RENAMED.get(module, module.replace("betavae_tpu/",
                                              "betavae_tpu_torch/", 1))
    assert (ROOT / port).is_file(), f"{module}: no {port}"
