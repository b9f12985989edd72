"""The port's epoch trainer ``train()`` against the JAX package's, on the CPU.

One JAX ``train()`` run (module fixture) and the port's on the same tiny
demo config must emit the same ``METRICS`` phases in the same order, the
same number of lines and the same keys per phase, and the port's log file
must parse with the JAX package's own ``eval.logs.parse_metrics``.  The
port's run replays exactly across a resume (augmentation on), stops early
with a final save, and writes no best checkpoint without validation.
"""

import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import yaml

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.eval.logs import iter_metrics, parse_metrics
from betavae_tpu.eval.probes import compute_probe_metrics as jax_probes
from betavae_tpu.logging_utils import reset_logger as jax_reset_logger
from betavae_tpu.train.loop import train as jax_train

from betavae_tpu_torch.config import reset_config_cache
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.eval.probes import compute_probe_metrics
from betavae_tpu_torch.io.checkpoint import discover_shards, read_checkpoint_meta
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.ops.elbo import fused_reparam_kl
from betavae_tpu_torch.ops.head import head_forward, head_m
from betavae_tpu_torch.train.__main__ import main
from betavae_tpu_torch.train.callbacks import CheckpointManager, EarlyStopping
from betavae_tpu_torch.train.loop import train

ROOT = Path(__file__).resolve().parent.parent


def _config(root: Path, **overrides) -> str:
    """A tiny debug config (16 px, 2 blocks, 3 train and 2 val batches of 4
    an epoch, 2 epochs) with its outputs under ``root`` and the demo data
    under ``root/processed``; ``overrides`` are ``section.key`` values."""
    cfg = yaml.safe_load(open(ROOT / "configs" / "beta_vae_se_debug.yaml"))
    cfg["paths"].update(
        processed_dir=str(root / "processed"),
        outputs_dir=str(root / "outputs"),
        models_dir=str(root / "outputs" / "models"),
        figures_dir=str(root / "outputs" / "figures"),
        tables_dir=str(root / "outputs" / "tables"), run_id="run")
    cfg["data"]["image_size"] = 16
    cfg["model"].update(latent_dim=4, base_channels=4, num_blocks=2)
    cfg["training"].update(batch_size=4, mixed_precision=False)
    cfg["loss"].update(use_lpips=False)
    cfg["logging"]["log_to_file"] = True
    for key, val in overrides.items():
        sec, name = key.split(".")
        cfg[sec][name] = val
    root.mkdir(parents=True, exist_ok=True)
    if not (root / "processed").exists():
        generate_demo_data(root / "processed", train_per_class=3,
                           test_per_class=2, size=16)
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _port_train(path, **kw):
    reset_config_cache()
    reset_logger()
    try:
        return train(path, device="cpu", **kw)
    finally:
        reset_logger()
        reset_config_cache()


def _log(path) -> list:
    cfg = yaml.safe_load(open(path))
    return list(iter_metrics(os.path.join(cfg["paths"]["outputs_dir"], "logs",
                                          "run.log")))


@pytest.fixture(scope="module")
def jax_lines(tmp_path_factory):
    path = _config(tmp_path_factory.mktemp("jax"))
    jax_reset_config()
    jax_reset_logger()
    try:
        jax_get_config(path)
        jax_train()
    finally:
        jax_reset_logger()
        jax_reset_config()
    return _log(path)


def test_train_lines_match_jax_train(jax_lines, tmp_path):
    path = _config(tmp_path, **{"training.fused_head": True})
    for wrapper in (fused_reparam_kl, head_forward, head_m):
        wrapper.launches = 0
    out = _port_train(path)
    port_lines = _log(path)
    assert [m["phase"] for m in port_lines] == [m["phase"]
                                                for m in jax_lines]
    assert [m["step"] for m in port_lines] == [m["step"] for m in jax_lines]
    for phase in ("train", "val", "epoch_end"):
        keys = {tuple(m) for m in port_lines if m["phase"] == phase}
        assert keys == {tuple(m) for m in jax_lines if m["phase"] == phase}
    assert out["epoch"] == 2 and out["total_steps"] == 6
    for m in port_lines:
        if m["phase"] != "epoch_end":
            assert all(math.isfinite(v) for v in m.values()
                       if isinstance(v, float)), m
    df = parse_metrics(os.path.join(tmp_path, "outputs", "logs", "run.log"))
    assert list(df["phase"]) == [m["phase"] for m in jax_lines]
    # CPU tensors: every kernel's plain version, no launch
    assert (fused_reparam_kl.launches, head_forward.launches,
            head_m.launches) == (0, 0, 0)
    figures = set(os.listdir(tmp_path / "outputs" / "figures"))
    assert {"recon_epoch2.png", "recon_epoch2_diff.png",
            "recon_epoch2_stats.json"} <= figures
    for tag in ("latest", "best"):
        assert len(discover_shards(str(tmp_path / "outputs" / "models" /
                                       f"run_{tag}.pt"))) == 2


def _model_state(out) -> dict:
    return {k: v.detach().clone() for k, v in out["model"].state_dict().items()}


def test_resume_replays_the_uninterrupted_run(tmp_path, capsys):
    """Two epochs in one run equal one epoch, ``--resume latest`` and one
    more, with augmentation on: bitwise on the CPU (the checkpoint holds
    every fp32 value exactly, and each step's draws are functions of
    (seed, step))."""
    common = {"optimization.scheduler": "none", "training.fused_head": True,
              "augmentation.use_augmentations": True}
    whole = _model_state(_port_train(_config(tmp_path / "whole", **common,
                                             **{"debug.epochs": 2})))
    first = _config(tmp_path / "parts", **common, **{"debug.epochs": 1})
    _port_train(first)
    second = _config(tmp_path / "parts", **common, **{"debug.epochs": 2})
    reset_config_cache()
    reset_logger()
    try:
        main(["--config", second, "--device", "cpu", "--resume", "latest"])
    finally:
        reset_logger()
        reset_config_cache()
    assert "restarting at epoch 2" in capsys.readouterr().out
    resumed = [m for m in _log(second) if m["phase"] == "train"]
    assert [(m["epoch"], m["step"]) for m in resumed][-3:] == [
        (2, 4), (2, 5), (2, 6)]
    meta = read_checkpoint_meta(str(tmp_path / "parts" / "outputs" /
                                    "models" / "run_latest.pt"))
    assert (meta["epoch"], meta["total_steps"]) == (2, 6)

    reset_config_cache()
    from betavae_tpu_torch.config import get_config
    from betavae_tpu_torch.io.checkpoint import load_sharded_checkpoint
    parts = load_sharded_checkpoint(os.path.join(
        get_config(second).paths.models_dir, "run_latest.pt"))["model_state"]
    reset_config_cache()
    assert set(parts) == set(whole)
    for name, value in whole.items():
        np.testing.assert_array_equal(parts[name], value.numpy(), name)


def test_early_stopping_stops_and_saves(tmp_path):
    """β jumps from 0 to 1000 after epoch 1, so the validation total rises
    and patience 1 stops the run at epoch 2, which the cadence (every 3
    epochs) would not have saved: the stop saves it."""
    path = _config(tmp_path, **{
        "debug.epochs": 4, "training.early_stopping_patience": 1,
        "training.checkpoint_every_epochs": 3,
        "beta_schedule.type": "linear", "beta_schedule.start_beta": 0.0,
        "beta_schedule.end_beta": 1000.0, "beta_schedule.warmup_epochs": 1})
    out = _port_train(path)
    assert out["epoch"] == 2
    vals = [m for m in _log(path) if m["phase"] == "val"]
    assert [m["epoch"] for m in vals] == [1, 2]
    assert vals[1]["val_total_loss"] > vals[0]["val_total_loss"]
    models = tmp_path / "outputs" / "models"
    assert read_checkpoint_meta(str(models / "run_latest.pt"))["epoch"] == 2
    assert read_checkpoint_meta(str(models / "run_best.pt"))["epoch"] == 1


def test_no_validation_batches_write_no_best_checkpoint(tmp_path, capsys):
    path = _config(tmp_path, **{"debug.max_val_batches": 0})
    _port_train(path)
    models = tmp_path / "outputs" / "models"
    assert discover_shards(str(models / "run_best.pt")) == []
    assert len(discover_shards(str(models / "run_latest.pt"))) == 2
    vals = [m for m in _log(path) if m["phase"] == "val"]
    assert len(vals) == 2 and all(math.isnan(m["latent_probe_auc"])
                                  for m in vals)
    assert "no validation batches" in capsys.readouterr().out


def test_early_stopping_and_save_best_are_nan_proof(demo_config_factory):
    early = EarlyStopping(patience=2)
    early.update(float("nan"))
    assert early.best is None and early.num_bad == 1
    early.update(1.0)
    assert early.best == 1.0 and early.num_bad == 0
    early.update(float("nan"))
    early.update(0.5)
    early.update(0.7)
    early.update(float("inf"))
    assert early.best == 0.5 and early.should_stop

    reset_config_cache()
    from betavae_tpu_torch.config import get_config
    get_config(demo_config_factory())
    try:
        manager = CheckpointManager()
        assert manager.save_best(None, None, 1, 1, {},
                                 monitor_value=float("nan")) is None
        assert manager.best_value is None
    finally:
        reset_config_cache()


@pytest.mark.parametrize("n,d,k", [(40, 8, 4), (30, 5, 2), (24, 64, 4)])
def test_probe_metrics_match_jax(n, d, k):
    """The scipy logistic probe against scikit-learn's (the JAX package's)
    and the closed-form per-dimension statistics: 1e-6."""
    rng = np.random.default_rng(n)
    y = rng.integers(0, k, n)
    x = (rng.normal(size=(n, d)) + 0.5 * y[:, None]).astype(np.float32)
    got, want = compute_probe_metrics(x, y), jax_probes(x, y)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-6), key
    assert all(math.isnan(v) for v in compute_probe_metrics(x, [0] * n).values())


def test_config_line_notes_synchronous_checkpoints(tmp_path):
    path = _config(tmp_path, **{"training.async_checkpoint": True,
                                "debug.epochs": 1})
    _port_train(path)
    line = next(ln for ln in open(tmp_path / "outputs" / "logs" / "run.log")
                if "| CONFIG " in ln)
    cfg = json.loads(line.split("| CONFIG ", 1)[1])
    assert "synchronous" in cfg["async_checkpoint"]
