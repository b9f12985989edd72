"""The port's epoch trainer ``train()`` against the JAX package's, on the CPU.

One JAX ``train()`` run (module fixture) and the port's on the same tiny
demo config must emit the same ``METRICS`` phases in the same order, the
same number of lines and the same keys per phase, and the port's log file
must parse with the JAX package's own ``eval.logs.parse_metrics``.  The
port's run replays exactly across a resume (augmentation on), stops early
with a final save, and writes no best checkpoint without validation.  The
debug config's LPIPS (random-init, allowed) trains and is logged, refused
without ``lpips_allow_random`` as the JAX package refuses it.  Resumed from
the reference's torch-pickle shards (written by the JAX package), the
port's ``train()`` matches the JAX ``train()`` resumed from the same shards;
a split fed from the host trains bitwise as a resident one, however many
batches are staged ahead; ``logging.profile_steps`` writes traces that
``utils/trace.py`` parses, and the parser holds to a hand-written trace.
"""

import gzip
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.data.pipeline import \
    host_feed_chunk_limit as jax_chunk_limit
from betavae_tpu.eval.logs import iter_metrics, parse_metrics
from betavae_tpu.eval.probes import compute_probe_metrics as jax_probes
from betavae_tpu.io.checkpoint import flatten_pytree
from betavae_tpu.io.torch_compat import (export_adam_optim_state,
                                         save_torch_reference_checkpoint)
from betavae_tpu.logging_utils import reset_logger as jax_reset_logger
from betavae_tpu.models.beta_vae import model_from_config as jax_model_from
from betavae_tpu.train.loop import init_state
from betavae_tpu.train.loop import train as jax_train
from betavae_tpu.train.optim import build_optimizer as jax_build_optimizer

from betavae_tpu_torch.config import reset_config_cache
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.data.pipeline import host_feed_chunk_limit
from betavae_tpu_torch.eval.probes import compute_probe_metrics
from betavae_tpu_torch.io.checkpoint import discover_shards, read_checkpoint_meta
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.ops.elbo import fused_reparam_kl
from betavae_tpu_torch.ops.head import head_forward, head_m
from betavae_tpu_torch.train.__main__ import main
from betavae_tpu_torch.train.callbacks import CheckpointManager, EarlyStopping
from betavae_tpu_torch.io.weights import params_from_jax
from betavae_tpu_torch.train.loop import train
from betavae_tpu_torch.utils import profile_step
from betavae_tpu_torch.utils.trace import find_traces, parse_trace

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
    """``training.async_checkpoint: true`` runs the background writer: the
    CONFIG line carries the config's own value and no "not ported" note,
    and ``train()`` returns only after the writer has landed whole
    ``latest`` and ``best`` checkpoints of the last epoch."""
    path = _config(tmp_path, **{"training.async_checkpoint": True,
                                "debug.epochs": 1})
    _port_train(path)
    line = next(ln for ln in open(tmp_path / "outputs" / "logs" / "run.log")
                if "| CONFIG " in ln)
    cfg = json.loads(line.split("| CONFIG ", 1)[1])
    assert cfg["training"]["async_checkpoint"] is True
    assert "async_checkpoint" not in cfg
    models = tmp_path / "outputs" / "models"
    for tag in ("latest", "best"):
        assert len(discover_shards(str(models / f"run_{tag}.pt"))) == 2
        assert read_checkpoint_meta(str(models / f"run_{tag}.pt"))["epoch"] == 1


def _config_line(path) -> dict:
    cfg = yaml.safe_load(open(path))
    log = os.path.join(cfg["paths"]["outputs_dir"], "logs", "run.log")
    line = next(ln for ln in open(log) if "| CONFIG " in ln)
    return json.loads(line.split("| CONFIG ", 1)[1])


def test_debug_config_trains_with_random_init_lpips(tmp_path, monkeypatch):
    """The debug config's loss section as it is (LPIPS at weight 20 with
    ``lpips_allow_random: true``, FFL, free bits, l1), at 32 px, the least
    size AlexNet's pools take: the CONFIG line names ``random-init``, and
    every train and val line carries a finite LPIPS term above 0."""
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    debug = yaml.safe_load(open(ROOT / "configs" / "beta_vae_se_debug.yaml"))
    path = _config(tmp_path, **{"data.image_size": 32, **{
        f"loss.{k}": v for k, v in debug["loss"].items()}})
    assert yaml.safe_load(open(path))["loss"] == debug["loss"]
    out = _port_train(path)
    assert out["epoch"] == 2
    assert _config_line(path)["lpips_weights"] == "random-init"
    lines = _log(path)
    for phase, key in (("train", "train_recon_lpips"),
                       ("val", "val_recon_lpips")):
        values = [m[key] for m in lines if m["phase"] == phase]
        assert values and all(math.isfinite(v) and v > 0 for v in values), (
            phase, values)


def _raises_in_both_trainers(path, error, match) -> None:
    from betavae_tpu_torch.train.loop import train_steps

    for run in (lambda: train(path, device="cpu"),
                lambda: train_steps(path, 1, device="cpu")):
        reset_config_cache()
        reset_logger()
        try:
            with pytest.raises(error, match=match):
                run()
        finally:
            reset_logger()
            reset_config_cache()


def test_random_init_lpips_without_opt_in_raises(tmp_path, monkeypatch):
    """The JAX package's gate: no weights and no ``lpips_allow_random``
    refuses to train, with its message, in both trainers."""
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    path = _config(tmp_path, **{"data.image_size": 32,
                                "loss.use_lpips": True,
                                "loss.lpips_allow_random": False})
    _raises_in_both_trainers(path, RuntimeError, "use_lpips is ON but no "
                             "pretrained weights were found")


def _config_lines(path) -> list:
    cfg = yaml.safe_load(open(path))
    with open(os.path.join(cfg["paths"]["outputs_dir"], "logs",
                           "run.log")) as f:
        return [json.loads(line.split("| CONFIG ", 1)[1])
                for line in f if "| CONFIG " in line]


@pytest.mark.parametrize("overrides,key", [
    ({"training.max_device_dataset_mb": 0}, "training.max_device_dataset_mb"),
    ({"training.max_device_dataset_mb": 0, "training.host_feed_chunk_mb": 8},
     "training.host_feed_chunk_mb"),
    ({"logging.profile_steps": 3}, "logging.profile_steps")])
def test_unported_keys_are_refused_by_name(tmp_path, capsys, overrides, key):
    """The keys once refused by name now train, in both trainers, and are
    logged: each in both trainers' CONFIG lines; a split over
    ``training.max_device_dataset_mb`` is fed from the host, staged
    ``host_feed_chunk_limit`` batches of ``training.host_feed_chunk_mb``
    ahead, as a ``[DATA]`` line says; ``logging.profile_steps`` writes one
    trace per trainer."""
    from betavae_tpu_torch.train.loop import train_steps

    path = _config(tmp_path, **overrides)
    whole = _port_train(path)
    reset_config_cache()
    reset_logger()
    try:
        few = train_steps(path, 3, device="cpu")
    finally:
        reset_logger()
        reset_config_cache()
    assert whole["total_steps"] == 6 and few["steps"] == 3
    sec, name = key.split(".")
    lines = _config_lines(path)
    assert len(lines) == 2
    assert all(line[sec][name] == overrides[key] for line in lines)
    out = capsys.readouterr().out
    if sec == "training":
        depth = host_feed_chunk_limit(4, (16, 16, 1), float(
            overrides.get("training.host_feed_chunk_mb", 8.0)))
        for split, runs in (("train", 2), ("test", 1)):
            assert out.count(f"[DATA] the {split} split") == runs
        assert f"up to {depth} batch(es) ahead" in out
        assert whole["traces"] == few["traces"] == []
    else:
        profile = tmp_path / "outputs" / "profile"
        assert whole["traces"] == few["traces"] == [
            str(profile / "steps_1-3.trace.json")]
        assert os.path.exists(whole["traces"][0])


# ---------------------------------------------------------------------------
# resume from the reference's shards
# ---------------------------------------------------------------------------

def _reference_shards(path, steps: int) -> None:
    """``<run_id>_latest_shard{0,1}.pt`` of epoch 1 after ``steps`` steps,
    written by the JAX package's reference exporter: seeded weights moved
    by ``steps`` Adam updates with seeded gradients, and that Adam state."""
    jax_reset_config()
    try:
        jcfg = jax_get_config(path)
        tx = jax_build_optimizer(jcfg)
        state = init_state(jax_model_from(jcfg), tx, jax.random.PRNGKey(2))
        rng = np.random.default_rng(6)
        params, opt_state = state.params, state.opt_state
        for _ in range(steps):
            grads = jax.tree_util.tree_map(
                lambda p: rng.normal(size=p.shape).astype(np.float32), params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, params,
                                            updates)
        state = state.replace(params=params, opt_state=opt_state)
        model_flat = flatten_pytree(state.model_variables())
        models = jcfg.paths.models_dir
        os.makedirs(models, exist_ok=True)
        save_torch_reference_checkpoint(
            os.path.join(models, "run_latest.pt"),
            {"epoch": 1, "total_steps": steps, "val_total": 1e9,
             "model_state": model_flat},
            optim_state=export_adam_optim_state(
                flatten_pytree(state.opt_state), model_flat, lr=1e-3))
    finally:
        jax_reset_config()


def test_resume_from_reference_shards_matches_jax_train(tmp_path, capsys):
    """The same reference shards (epoch 1, 3 steps, Adam state) resumed by
    the JAX ``train()`` and the port's for one more epoch, z = μ
    (``deterministic_overfit``) and augmentation off, so both take the same
    steps: every logged loss within 1e-4 relative and the final params
    within 1e-4 relative plus 2e-6, the three-step parity test's
    tolerances."""
    common = {"model.deterministic_overfit": True,
              "augmentation.use_augmentations": False,
              "optimization.scheduler": "none"}
    jax_path = _config(tmp_path / "jax", **common)
    port_path = _config(tmp_path / "port", **common, **{
        "paths.processed_dir": str(tmp_path / "jax" / "processed")})
    for path in (jax_path, port_path):
        _reference_shards(path, steps=3)
    jax_reset_config()
    jax_reset_logger()
    try:
        jax_get_config(jax_path)
        state = jax_train(resume="latest")
    finally:
        jax_reset_logger()
        jax_reset_config()
    out = _port_train(port_path, resume="latest")
    printed = capsys.readouterr().out
    assert printed.count("imported torch Adam moments (step count 3)") == 2
    assert out["epoch"] == 2 and out["total_steps"] == 6

    jax_log, port_log = _log(jax_path), _log(port_path)
    assert [(m["phase"], m["step"]) for m in port_log] == \
        [(m["phase"], m["step"]) for m in jax_log] and port_log
    for want, got in zip(jax_log, port_log):
        for key in ("train_total_loss", "train_recon_loss", "val_total_loss",
                    "val_recon_loss"):
            if key in want:
                assert got[key] == pytest.approx(want[key], rel=1e-4,
                                                 abs=1e-6), (want["step"], key)
    final = params_from_jax(flatten_pytree(state.model_variables()))
    ours = out["model"].state_dict()
    for key, value in final.items():
        np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=key)


# ---------------------------------------------------------------------------
# host feed
# ---------------------------------------------------------------------------

_TIMES = {"epoch_seconds", "train_steps_per_sec", "train_images_per_sec"}


def _numbers(path) -> list:
    """The METRICS lines but their wall times (epoch_end lines are all
    times)."""
    return [{k: v for k, v in m.items() if k not in _TIMES}
            for m in _log(path) if m["phase"] != "epoch_end"]


@pytest.fixture(scope="module")
def device_fed(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_fed")
    path = _config(root, **{"training.fused_head": True,
                            "augmentation.use_augmentations": True})
    out = _port_train(path)
    return root, _model_state(out), _numbers(path)


@pytest.mark.parametrize("chunk_mb", [8.0, 1e-9], ids=["staged", "one-batch"])
def test_host_feed_equals_device_feed_bitwise(device_fed, tmp_path, chunk_mb):
    """Both splits fed from the host (``max_device_dataset_mb: 0``), with
    every batch of an epoch staged ahead (8 MB) or one (``host_feed_chunk_mb``
    under one batch): every logged number and every final weight bitwise
    those of the resident splits, as the JAX package's host feed is
    (``tests/test_host_feed.py``)."""
    root, state, numbers = device_fed
    assert host_feed_chunk_limit(4, (16, 16, 1), chunk_mb) == (
        1 if chunk_mb < 1 else 8192)
    path = _config(tmp_path, **{
        "training.fused_head": True, "augmentation.use_augmentations": True,
        "training.max_device_dataset_mb": 0,
        "training.host_feed_chunk_mb": chunk_mb,
        "paths.processed_dir": str(root / "processed")})
    out = _port_train(path)
    assert _numbers(path) == numbers
    got = _model_state(out)
    assert set(got) == set(state)
    for name, value in state.items():
        assert torch.equal(got[name], value), name


@pytest.mark.parametrize("batch,shape,budget_mb", [
    (32, (128, 128, 1), 8.0), (32, (128, 128, 1), 0.001),
    (8, (8, 8, 1), 8.0), (4, (16, 16, 1), 1e-9)])
def test_host_feed_chunk_limit_matches_jax(batch, shape, budget_mb):
    """The JAX package's values (16 batches of the flagship in 8 MB, at
    least 1, else bounded by the budget alone)."""
    assert host_feed_chunk_limit(batch, shape, budget_mb) == \
        jax_chunk_limit(batch, shape, budget_mb)


# ---------------------------------------------------------------------------
# logging.profile_steps and the trace tools
# ---------------------------------------------------------------------------

def test_profile_steps_write_traces_the_parser_reads(tmp_path):
    """``logging.profile_steps: 2`` traces steps 1-2 of ``train()``; over
    two epochs of 3 steps, 5 in ``train_steps`` give one window an epoch
    (steps 1-3 and 4-5), as the JAX profiler restarts at an epoch.  Each
    trace is a Chrome trace the parser reads; on the CPU it holds no device
    kernel."""
    from betavae_tpu_torch.train.loop import train_steps

    path = _config(tmp_path, **{"logging.profile_steps": 2})
    out = _port_train(path)
    profile = tmp_path / "outputs" / "profile"
    assert out["traces"] == [str(profile / "steps_1-2.trace.json")]
    with open(out["traces"][0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    summary = parse_trace(out["traces"][0], steps=2)
    assert summary.rows == [] and summary.device_total_us == 0
    assert "TOTAL" in summary.table()

    path = _config(tmp_path / "few", **{"logging.profile_steps": 5})
    reset_config_cache()
    reset_logger()
    try:
        few = train_steps(path, 6, device="cpu")
    finally:
        reset_logger()
        reset_config_cache()
    profile = tmp_path / "few" / "outputs" / "profile"
    assert few["traces"] == [str(profile / "steps_1-3.trace.json"),
                             str(profile / "steps_4-5.trace.json")]
    assert sorted(find_traces(str(profile))) == few["traces"]


def _chrome_trace(path, gz=False) -> None:
    """Two kernels (one launched twice), a copy, a CPU operator, an
    annotation on the device's track and an instant event: only the three
    kernel launches count."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "reparam_kl_kernel", "dur": 1.5,
         "ts": 0, "pid": 0, "tid": 7, "args": {"grid": [1, 1, 1],
                                              "block": [256, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "reparam_kl_kernel", "dur": 2.5,
         "ts": 10, "pid": 0, "tid": 7, "args": {}},
        {"ph": "X", "cat": "kernel",
         "name": "void at::native::upsample_bilinear2d_out_frame<float>()",
         "dur": 100.0, "ts": 20, "pid": 0, "tid": 7, "args": {}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable)",
         "dur": 50.0, "ts": 0, "pid": 0, "tid": 8},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 999.0,
         "ts": 0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step",
         "dur": 500.0, "ts": 0, "pid": 0, "tid": 7},
        {"ph": "i", "cat": "kernel", "name": "reparam_kl_kernel", "ts": 3,
         "pid": 0, "tid": 7},
    ]
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_trace_parser_counts_device_kernels_only(tmp_path, capsys, gz):
    """A hand-written Chrome trace: rows by kernel name with µs and
    launches, per step over the declared steps, the name filter, the table
    and its total, and ``profile_step --parse-only`` on its directory."""
    path = str(tmp_path / ("t.trace.json.gz" if gz else "t.trace.json"))
    _chrome_trace(path, gz=gz)
    s = parse_trace(path, steps=2)
    assert [(r.name, r.total_us, r.count) for r in s.rows] == [
        ("void at::native::upsample_bilinear2d_out_frame<float>()", 100.0, 1),
        ("reparam_kl_kernel", 4.0, 2)]
    assert s.rows[1].example == "grid [1, 1, 1] block [256, 1, 1]"
    assert s.device_total_us == 104.0
    assert {n: (us, k) for n, us, k in s.per_step()}[
        "reparam_kl_kernel"] == (2.0, 1.0)
    table = s.table(top=1)
    assert "upsample" in table and "reparam" not in table
    assert table.splitlines()[-1].split()[0] == "52.0"
    only = parse_trace(path, steps=1, name_filter="reparam")
    assert [r.name for r in only.rows] == ["reparam_kl_kernel"]
    assert only.device_total_us == 4.0
    assert find_traces(str(tmp_path)) == [path]
    summary = profile_step.main(["--parse-only", str(tmp_path),
                                 "--steps", "2"])
    assert summary.device_total_us == 104.0 and summary.steps == 2
    assert f"trace: {path}" in capsys.readouterr().out


def test_profile_step_cli_traces_the_step_on_the_cpu(tmp_path, capsys):
    """``python -m betavae_tpu_torch.utils.profile_step --device cpu``
    times the step, writes its trace under ``--logdir`` and prints the
    table; without ``--device`` it needs a GPU."""
    path = _config(tmp_path)
    reset_config_cache()
    try:
        summary = profile_step.main(["--config", path, "--steps", "2",
                                     "--device", "cpu", "--logdir",
                                     str(tmp_path / "trace")])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                profile_step.main(["--config", path, "--steps", "1"])
    finally:
        reset_config_cache()
    out = capsys.readouterr().out
    assert "step time (warm, host-observed)" in out and "TOTAL" in out
    assert summary.steps == 2
    assert os.path.exists(tmp_path / "trace" / "profile_step_2.trace.json")


# ---------------------------------------------------------------------------
# the trainer's runs under cuDNN's deterministic algorithms
# ---------------------------------------------------------------------------

# set before each run, each the other way from what a run must see
_CUDNN_BEFORE = {"deterministic": False, "benchmark": True}


def _cudnn_flags() -> tuple:
    cudnn = torch.backends.cudnn
    return cudnn.deterministic, cudnn.benchmark, cudnn.enabled


def _recording_steps(monkeypatch, module, raises: bool) -> list:
    """Patch ``module.make_train_step`` so that each step call records the
    cuDNN flags it runs under (and then raises, with ``raises``)."""
    seen = []
    make = module.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(*step_args, **step_kwargs):
            seen.append(_cudnn_flags())
            if raises:
                raise RuntimeError("step failed on purpose")
            return step(*step_args, **step_kwargs)
        return wrapped

    monkeypatch.setattr(module, "make_train_step", recording)
    return seen


def _bench_steady(path) -> None:
    """The bench's steady loop over a tiny model, one warm-up and 3 × 1
    timed steps."""
    from types import SimpleNamespace

    from betavae_tpu_torch.bench import _steady_state
    from betavae_tpu_torch.models.beta_vae import BetaVAEModule

    model = BetaVAEModule(image_size=16, in_channels=1, latent_dim=4,
                          base_channels=4, num_blocks=2)
    _steady_state(model, SimpleNamespace(batch_size=4, image_size=16,
                                         steps=1, warmup=1),
                  torch.device("cpu"))


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("entry", ["train_steps", "train", "bench_steady"])
def test_trainer_runs_under_deterministic_cudnn_and_restores_the_flags(
        tmp_path, monkeypatch, entry, raises):
    """Every step of ``train_steps``, ``train`` and the bench's steady loop
    runs with ``cudnn.deterministic`` True and ``benchmark`` False (fp32
    backwards replay on the card only so); each puts both back as it found
    them, also when the run raises, and leaves ``cudnn.enabled`` alone."""
    from betavae_tpu_torch import bench
    from betavae_tpu_torch.train import loop

    cudnn = torch.backends.cudnn
    for name, value in _CUDNN_BEFORE.items():
        monkeypatch.setattr(cudnn, name, value)
    before = _cudnn_flags()
    seen = _recording_steps(monkeypatch,
                            bench if entry == "bench_steady" else loop,
                            raises)
    path = _config(tmp_path)
    run = {"train_steps": lambda: loop.train_steps(path, 2, device="cpu"),
           "train": lambda: loop.train(path, device="cpu"),
           "bench_steady": lambda: _bench_steady(path)}[entry]
    reset_config_cache()
    reset_logger()
    try:
        if raises:
            with pytest.raises(RuntimeError, match="on purpose"):
                run()
        else:
            run()
    finally:
        reset_logger()
        reset_config_cache()
    assert seen and all(flags == (True, False, before[2]) for flags in seen)
    assert len(seen) == 1 if raises else len(seen) > 1
    assert _cudnn_flags() == before
