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
Epoch rotation is bitwise the unrotated run (every line, every checkpoint
written, the returned state) and an early stop under it restores the
epoch-N state; the background panel writer's files land before
``train()`` returns and its failures surface as the JAX loop's do; host-fed
chunks of ``host_feed_chunk_limit`` steps are bitwise the device-fed run;
and the dispatch table says which paths replay a CUDA graph.  On the path
of one of several ranks (graphs launched from the host, each dispatch a
job of the run's dispatcher thread; a stand-in graph held at a gate) each
dispatch returns before its launches and the run is bitwise the eager
one, a failed job is raised from ``train()``, the snapshot's restore and
the eager collectives wait for the queued launches, and a job runs under
its caller's grad mode and autocast.
"""

import gzip
import json
import math
import os
import threading
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
from betavae_tpu_torch.io.checkpoint import (discover_shards,
                                             load_sharded_checkpoint,
                                             read_checkpoint_meta)
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.ops.elbo import fused_reparam_kl
from betavae_tpu_torch.ops.head import head_forward, head_m
from betavae_tpu_torch.train.__main__ import main
from betavae_tpu_torch.train.callbacks import CheckpointManager, EarlyStopping
from betavae_tpu_torch.train.chunks import chunk_plan
from betavae_tpu_torch.io.weights import optim_state_tensors, params_from_jax
from betavae_tpu_torch.train import loop
from betavae_tpu_torch.train.loop import dispatch_way, dispatch_note, train
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
    """The run's METRICS lines but the port's ``spans`` lines, which the
    JAX package does not log (``tests/test_torch_port_spans.py`` reads
    them)."""
    cfg = yaml.safe_load(open(path))
    return [m for m in iter_metrics(os.path.join(
        cfg["paths"]["outputs_dir"], "logs", "run.log"))
        if m["phase"] != "spans"]


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
    # epoch rotation (on by default in both): epoch 1 dispatches epoch 2's
    # first chunk from its tail, the last epoch has none to dispatch
    rotated = [[m["rotated"] for m in lines if m["phase"] == "epoch_end"]
               for lines in (port_lines, jax_lines)]
    assert rotated[0] == rotated[1] == [True, False]
    assert out["epoch"] == 2 and out["total_steps"] == 6
    for m in port_lines:
        if m["phase"] != "epoch_end":
            assert all(math.isfinite(v) for v in m.values()
                       if isinstance(v, float)), m
    df = parse_metrics(os.path.join(tmp_path, "outputs", "logs", "run.log"))
    assert [p for p in df["phase"] if p != "spans"] == \
        [m["phase"] for m in jax_lines]
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
    """The bench's steady loop over a tiny model, one warm-up chunk and
    3 × 1 timed chunks of 2 steps."""
    from types import SimpleNamespace

    from betavae_tpu_torch.bench import _steady_state
    from betavae_tpu_torch.models.beta_vae import BetaVAEModule

    model = BetaVAEModule(image_size=16, in_channels=1, latent_dim=4,
                          base_channels=4, num_blocks=2)
    _steady_state(model, SimpleNamespace(batch_size=4, image_size=16,
                                         steps=1, warmup=1, scan_chunk=2),
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


# ---------------------------------------------------------------------------
# training.scan_chunk_steps: K steps a dispatch
# ---------------------------------------------------------------------------

# 6 steps an epoch (12 train images in batches of 2), 2 validation batches,
# a line every step, augmentation on
_CHUNK_CFG = {"training.batch_size": 2, "debug.max_train_batches": 6,
              "augmentation.use_augmentations": True,
              "logging.log_every_n_steps": 1}


def _steps_lines(path, max_steps: int) -> tuple:
    from betavae_tpu_torch.train.loop import train_steps

    reset_config_cache()
    reset_logger()
    try:
        out = train_steps(path, max_steps, device="cpu")
    finally:
        reset_logger()
        reset_config_cache()
    return out, _numbers(path)


@pytest.fixture(scope="module")
def eager_chunks(tmp_path_factory):
    """``train()`` (2 epochs with validation) and ``train_steps`` (10 steps
    over 2 epochs) at ``scan_chunk_steps: 1``."""
    root = tmp_path_factory.mktemp("eager_chunks")
    path = _config(root / "train", **_CHUNK_CFG,
                   **{"training.scan_chunk_steps": 1})
    out = _port_train(path)
    few_path = _config(root / "steps", **_CHUNK_CFG, **{
        "training.scan_chunk_steps": 1,
        "paths.processed_dir": str(root / "train" / "processed")})
    few, few_lines = _steps_lines(few_path, 10)
    return root, _model_state(out), _numbers(path), few["totals"], few_lines


@pytest.mark.parametrize("k", [3, 4, 192])
def test_scan_chunks_give_the_eager_lines_bitwise(eager_chunks, tmp_path, k):
    """``train()`` and ``train_steps`` at ``scan_chunk_steps`` 3 (two
    chunks an epoch), 4 (a chunk and two single steps, the remainder) and
    192 (K lowered to the epoch's 6 steps) against 1: the same METRICS
    lines, steps and keys, with every number but the wall times bitwise,
    the same per-step totals and final weights; the CONFIG line is the
    JAX package's (no ``step_dispatch`` note: the CPU's eager steps are
    by design)."""
    root, state, lines, totals, few_lines = eager_chunks
    data = {"paths.processed_dir": str(root / "train" / "processed")}
    path = _config(tmp_path / "train", **_CHUNK_CFG, **data,
                   **{"training.scan_chunk_steps": k})
    out = _port_train(path)
    assert _numbers(path) == lines
    assert [m["phase"] for m in lines].count("train") == 12
    got = _model_state(out)
    for name, value in state.items():
        assert torch.equal(got[name], value), name
    assert "step_dispatch" not in _config_line(path)

    few_path = _config(tmp_path / "steps", **_CHUNK_CFG, **data,
                       **{"training.scan_chunk_steps": k})
    few, got_lines = _steps_lines(few_path, 10)
    assert few["steps"] == 10 and few["totals"] == totals
    assert got_lines == few_lines
    assert (few["dispatch"], few["launches_per_replay"]) == ("eager: cpu",
                                                             None)


def _count_plain_calls(mp) -> None:
    """Make each train-path kernel wrapper count a call of its plain
    version on the CPU as a launch (the upsample's on the vector path, the
    GN forward's on the generic path and the GN backward's on the path
    ``gn_path`` names for x), as it counts a kernel's launch on the card."""
    from betavae_tpu_torch.ops import elbo, gn, kernel_wrappers, upsample

    wrappers = kernel_wrappers()

    def counting(module, attr, name):
        plain = getattr(module, attr)
        wrapper = wrappers[name]

        def call(*args, **kwargs):
            wrapper.launches += 1
            if name == "gn_forward":
                wrapper.launches_by_path["generic"] += 1
            elif name == "gn_backward":
                x = args[0]
                wrapper.launches_by_path[gn.gn_path(x.shape, x.dtype)[0]] += 1
            elif hasattr(wrapper, "launches_by_path"):
                wrapper.launches_by_path["vector"] += 1
            return plain(*args, **kwargs)

        mp.setattr(module, attr, call)

    counting(elbo, "reparam_kl_reference", "fused_reparam_kl")
    counting(elbo, "reparam_kl_backward_reference", "reparam_kl_backward")
    counting(upsample, "upsample2x_reference", "upsample_forward")
    counting(upsample, "upsample2x_backward_reference", "upsample_backward")
    counting(gn, "gn_forward_reference", "gn_forward")
    counting(gn, "gn_backward_reference", "gn_backward")


def _zeroed_counts() -> dict:
    from betavae_tpu_torch.ops import kernel_wrappers

    for w in kernel_wrappers().values():
        w.launches = 0
        for path in getattr(w, "launches_by_path", {}):
            w.launches_by_path[path] = 0
    return kernel_wrappers()


def _stub_graphs(mp, gate=None, log=None) -> list:
    """Run the trainers' CUDA-graph path on the CPU: ``dispatch_way`` says
    ``cuda_graph``, and a stand-in takes the place of
    ``chunks.CudaGraphs``.  Its capture runs the body once, as a capture
    runs its Python (the trainer puts back what it changes, as it does
    after its warm-up); a launch runs it again with the kernel counts put
    back, as a launch runs no Python.  With ``gate`` (a
    ``threading.Event``) a launch first waits for it, as a launch into a
    full launch queue waits for room (60 s at most, then it raises); each
    launch appends ``"launch"`` to ``log`` when one is given.  Returns the
    list of the chunks and validation parts run, in order, each ``(kind,
    slots, launches)``."""
    from betavae_tpu_torch.train import chunks

    runs = []

    class Graph:
        launches = 0

        def __init__(self, body):
            self.body = body

        def replay(self):
            if gate is not None and not gate.wait(60):
                raise RuntimeError("a stand-in launch was never let through")
            Graph.launches += 1
            if log is not None:
                log.append("launch")
            before = chunks._counts()
            self.body()
            chunks._set_counts(before)

    class StubGraphs:
        def __init__(self, device):
            pass

        def warm_up(self, run):
            run()

        def capture(self, body):
            body()
            return Graph(body)

        def synchronize(self):
            pass

    run = chunks._Chunked._run

    def recorded(self, images, n):
        before = Graph.launches
        run(self, images, n)
        runs.append((type(self).__name__, n, Graph.launches - before))

    mp.setattr(chunks._Chunked, "_run", recorded)
    mp.setattr(loop, "dispatch_way", lambda *args, **kwargs: "cuda_graph")
    mp.setattr(chunks, "CudaGraphs", StubGraphs)
    return runs


@pytest.fixture(scope="module")
def counted_eager(eager_chunks):
    """The ``eager_chunks`` runs' ``train()`` again, each kernel wrapper
    counting its plain version's calls: (lines, state, counts)."""
    root = eager_chunks[0]
    path = _config(root / "counted", **_CHUNK_CFG, **{
        "training.scan_chunk_steps": 1,
        "paths.processed_dir": str(root / "train" / "processed")})
    with pytest.MonkeyPatch.context() as mp:
        _count_plain_calls(mp)
        wrappers = _zeroed_counts()
        out = _port_train(path)
        counts = {name: w.launches for name, w in wrappers.items()}
    return _numbers(path), _model_state(out), counts


@pytest.mark.parametrize("k,profile,train_chunks", [
    (3, 0, [3, 3, 3, 3]),
    (4, 0, [4, 1, 1, 4, 1, 1]),
    (4, 2, [2, 2, 1, 1, 4, 1, 1])],
    ids=["k3", "k4-remainder", "k4-profiler-cut"])
def test_graph_chunk_is_n_launches_of_the_captured_step(
        counted_eager, eager_chunks, tmp_path, monkeypatch, k, profile,
        train_chunks):
    """The CUDA-graph path with a stand-in graph on the CPU, ``train()``
    over 2 epochs of 6 steps and 2 validation batches (rotation on): a
    chunk of n steps is n launches of the captured step (K, the remainder
    one step a chunk, a chunk the profiler window cuts at steps 1-2), a
    validation pass 2 launches of the captured batch; every METRICS number
    but the wall times and the final weights bitwise the eager run's, and
    each kernel wrapper's count the eager run's plus the capture's warm-up
    (CAPTURE_WARMUP train steps and validation batches).  ``train_steps``
    (10 steps: 6, then 4) launches the same way, its totals the eager
    ones, a launch's kernel launches one step's."""
    from betavae_tpu_torch.train.chunks import CAPTURE_WARMUP

    lines, state, eager = counted_eager
    data = {"paths.processed_dir": str(eager_chunks[0] / "train" /
                                       "processed")}
    _count_plain_calls(monkeypatch)
    runs = _stub_graphs(monkeypatch)
    path = _config(tmp_path / "train", **_CHUNK_CFG, **data, **{
        "training.scan_chunk_steps": k, "logging.profile_steps": profile})
    wrappers = _zeroed_counts()
    out = _port_train(path)
    counts = {name: w.launches for name, w in wrappers.items()}
    assert all(n == launches for _, n, launches in runs), runs
    train = [n for kind, n, _ in runs if kind == "TrainChunks"]
    val = [n for kind, n, _ in runs if kind == "EvalChunks"]
    assert (train, val) == (train_chunks, [2, 2])
    assert _numbers(path) == lines
    got = _model_state(out)
    for name, value in state.items():
        assert torch.equal(got[name], value), name
    blocks = eager["upsample_backward"] // 12
    assert blocks > 0
    # a forward runs the GN kernels in each encoder and decoder block
    assert eager["gn_backward"] == 12 * 2 * blocks
    warm = {"fused_reparam_kl": 2 * CAPTURE_WARMUP,
            "reparam_kl_backward": CAPTURE_WARMUP,
            "upsample_forward": 2 * CAPTURE_WARMUP * blocks,
            "upsample_backward": CAPTURE_WARMUP * blocks,
            "gn_forward": 2 * CAPTURE_WARMUP * 2 * blocks,
            "gn_backward": CAPTURE_WARMUP * 2 * blocks}
    assert counts == {name: n + warm.get(name, 0)
                      for name, n in eager.items()}

    runs.clear()
    few_path = _config(tmp_path / "steps", **_CHUNK_CFG, **data,
                       **{"training.scan_chunk_steps": k})
    few, _ = _steps_lines(few_path, 10)
    assert few["dispatch"] == "cuda_graph" and few["chunk_k"] == k
    assert few["totals"] == eager_chunks[3]
    assert [(n, launches) for _, n, launches in runs] == [
        (n, n) for n in {3: [3, 3, 3, 1], 4: [4, 1, 1, 4]}[k]]
    assert few["launches_per_replay"]["fused_reparam_kl"] == 1


def test_only_one_of_several_ranks_launches_from_the_host(monkeypatch):
    """``chunks._several_ranks``, which sends a captured graph's launches
    to the host (a rank's step holds NCCL's kernels between the ranks,
    which a graph instantiated for device launch refuses): false with no
    process group and with a one-rank group, true with four ranks."""
    import torch.distributed as dist

    from betavae_tpu_torch.train import chunks

    assert not chunks._several_ranks()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    assert not chunks._several_ranks()
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    assert chunks._several_ranks()


@pytest.mark.parametrize("n_steps,k_cfg,k,sizes", [
    (6, 192, 6, [6]), (6, 3, 3, [3, 3]), (6, 4, 4, [4, 1, 1]),
    (182, 192, 182, [182]), (182, 16, 16, [16] * 11 + [1] * 6),
    (5, 1, 1, [1] * 5), (1, 192, 1, [1]), (0, 192, 1, [])])
def test_chunk_plan_is_the_jax_loops(n_steps, k_cfg, k, sizes):
    """K = max(1, min(K_cfg, n_steps)) chunks of K, the remainder one step
    a chunk (the JAX loop's single-step program): every step once, in
    order."""
    assert chunk_plan(n_steps, k_cfg) == (k, sizes)
    assert sum(sizes) == n_steps


@pytest.mark.parametrize("k", [1, 3, 192])
def test_scan_chunks_match_jax_train_at_the_same_k(tmp_path, capsys, k):
    """The reference shards (epoch 1, 3 Adam steps) resumed by the JAX
    ``train()`` and the port's for one more epoch of 6 steps at
    ``scan_chunk_steps`` K (the JAX loop scans K steps a dispatch; the port
    runs K-step chunks), z = μ and augmentation off so both take the same
    steps: every logged loss within 1e-4 relative (atol 1e-6), the
    tolerance of the resume test above."""
    common = {"model.deterministic_overfit": True,
              "augmentation.use_augmentations": False,
              "optimization.scheduler": "none", "training.batch_size": 2,
              "debug.max_train_batches": 6,
              "training.scan_chunk_steps": k}
    jax_path = _config(tmp_path / "jax", **common)
    port_path = _config(tmp_path / "port", **common, **{
        "paths.processed_dir": str(tmp_path / "jax" / "processed")})
    for path in (jax_path, port_path):
        _reference_shards(path, steps=3)
    jax_reset_config()
    jax_reset_logger()
    try:
        jax_get_config(jax_path)
        jax_train(resume="latest")
    finally:
        jax_reset_logger()
        jax_reset_config()
    out = _port_train(port_path, resume="latest")
    assert out["total_steps"] == 9
    jax_log, port_log = _log(jax_path), _log(port_path)
    assert [(m["phase"], m["step"]) for m in port_log] == \
        [(m["phase"], m["step"]) for m in jax_log]
    assert [m["phase"] for m in port_log].count("train") == 6
    for want, got in zip(jax_log, port_log):
        for key in ("train_total_loss", "train_recon_loss", "val_total_loss",
                    "val_recon_loss", "train_kl_mean", "mu_mean_batch"):
            if key in want:
                assert got[key] == pytest.approx(want[key], rel=1e-4,
                                                 abs=1e-6), (want["step"], key)


# ---------------------------------------------------------------------------
# the rest of the JAX loop's dispatch: epoch rotation, the background panel
# writer, host-fed chunks, the dispatch table
# ---------------------------------------------------------------------------

# the JAX rotation test's shape (tests/test_epoch_rotation.py): 5 train
# batches an epoch in chunks of K = 2 (2, 2, 1), 2 validation batches,
# 3 epochs
_ROTATION_CFG = {"debug.max_train_batches": 5, "debug.epochs": 3,
                 "training.scan_chunk_steps": 2,
                 "optimization.scheduler": "none",
                 "logging.log_every_n_steps": 1}
# the epoch_end keys that are host times and stamps
_TAIL_TIMES = {"val_seconds", "val_dispatch_seconds",
               "rotate_dispatch_seconds", "probe_seconds", "ckpt_seconds",
               "panel_seconds", "tail_seconds", "epoch_wall_seconds",
               "t_mono", "t_drain_mono"}


def _rotation_config(root: Path, data: Path | None = None,
                     **overrides) -> str:
    """:data:`_ROTATION_CFG` over 20 train and 8 test images at 16 px
    (under ``data``, made there when missing, else under ``root``)."""
    data = data or root / "processed"
    if not data.exists():
        generate_demo_data(data, train_per_class=5, test_per_class=2,
                           size=16)
    return _config(root, **{**_ROTATION_CFG, "paths.processed_dir":
                            str(data), **overrides})


def _lines_but_times(path) -> list:
    """Every METRICS line but its wall times and ``rotated``."""
    return [{k: v for k, v in m.items()
             if k not in _TIMES | _TAIL_TIMES | {"rotated"}}
            for m in _log(path)]


def _rotated(path) -> list:
    return [m["rotated"] for m in _log(path) if m["phase"] == "epoch_end"]


def _checkpoint(path, tag: str) -> dict:
    cfg = yaml.safe_load(open(path))
    return load_sharded_checkpoint(os.path.join(cfg["paths"]["models_dir"],
                                                f"run_{tag}.pt"))


def _state(out) -> dict:
    """The returned model's and optimizer's tensors, by checkpoint key."""
    return {"model_state": _model_state(out),
            "optim_state": {k: v.detach().clone() for k, v in
                            optim_state_tensors(out["optimizer"].optimizer)
                            .items()}}


def _assert_checkpoints_equal(a: dict, b: dict) -> None:
    for key in ("epoch", "total_steps", "val_total"):
        assert a[key] == b[key], key
    for sec in ("model_state", "optim_state"):
        assert sorted(a[sec]) == sorted(b[sec]), sec
        for k in a[sec]:
            assert np.array_equal(a[sec][k], b[sec][k]), f"{sec}/{k}"


def _train_saving(path) -> tuple:
    """``train()`` of ``path`` → (its output, every checkpoint it wrote, in
    order: ``(file name, payload)``)."""
    from unittest import mock

    from betavae_tpu_torch.train import callbacks

    saves = []
    real = callbacks.save_sharded_checkpoint

    def recording(ckpt_path, payload, num_shards=2):
        saves.append((os.path.basename(ckpt_path), {
            k: ({n: np.array(a) for n, a in v.items()}
                if isinstance(v, dict) else v) for k, v in payload.items()}))
        return real(ckpt_path, payload, num_shards=num_shards)

    with mock.patch.object(callbacks, "save_sharded_checkpoint", recording):
        out = _port_train(path)
    return out, saves


def _assert_saves_equal(got: list, want: list) -> None:
    assert [(name, p["epoch"]) for name, p in got] == \
        [(name, p["epoch"]) for name, p in want]
    for (_, a), (_, b) in zip(got, want):
        _assert_checkpoints_equal(a, b)


@pytest.fixture(scope="module")
def unrotated(tmp_path_factory):
    """:data:`_ROTATION_CFG`'s ``train()`` with ``epoch_rotation: false``:
    ``(data dir, its lines but times, every checkpoint it wrote, its
    state)``."""
    root = tmp_path_factory.mktemp("unrotated")
    path = _rotation_config(root, **{"training.epoch_rotation": False})
    out, saves = _train_saving(path)
    assert _rotated(path) == [False] * 3
    return root / "processed", _lines_but_times(path), saves, _state(out)


def test_epoch_rotation_is_bitwise_the_unrotated_run(unrotated, tmp_path):
    """``epoch_rotation: true`` dispatches the next epoch's first chunk
    from the tail of epochs 1 and 2 (``rotated``), before the validation
    metrics are read; every METRICS line but the wall times, both
    checkpoints and the returned model and optimizer are bitwise the
    unrotated run's, and so is every checkpoint written on the way (each
    epoch's ``latest`` and each ``best``).  On the CPU the rotated chunk
    runs at once, so a save that read the live tensors would hold epoch
    N+1's first steps.  Every panel's files are there when ``train()``
    returns (the background writer is joined)."""
    data, lines, saves, state = unrotated
    path = _rotation_config(tmp_path, data, **{"training.epoch_rotation":
                                               True})
    out, got_saves = _train_saving(path)
    assert _rotated(path) == [True, True, False]
    assert _lines_but_times(path) == lines
    assert [m["phase"] for m in _log(path)].count("train") == 15
    _assert_saves_equal(got_saves, saves)
    assert [name for name, _ in saves].count("run_latest.pt") == 3
    got = _state(out)
    for sec, part in state.items():
        assert sorted(got[sec]) == sorted(part)
        for k, v in part.items():
            assert torch.equal(got[sec][k], v), f"{sec}/{k}"
    figures = sorted(os.listdir(tmp_path / "outputs" / "figures"))
    assert figures == sorted(f"recon_epoch{e}{suffix}" for e in (1, 2, 3)
                             for suffix in (".png", "_diff.png",
                                            "_stats.json"))


def test_early_stop_discards_the_rotated_epoch(unrotated, tmp_path,
                                               monkeypatch):
    """An early stop at epoch 2 of 6 with rotation on (the counterpart of
    ``tests/test_epoch_rotation.py::test_early_stop_discards_inflight_
    epoch``): epoch 3's first chunk, dispatched from epoch 2's tail, is
    discarded; ``latest`` says epoch 2 and holds bitwise the returned
    model's and optimizer's tensors, which are those after epoch 2 of the
    unrotated run's lines."""

    class StopAfterTwo:
        def __init__(self, *args, **kwargs):
            self.calls = 0
            self.should_stop = False

        def update(self, value):
            self.calls += 1
            self.should_stop = self.calls >= 2

    data, lines, _, _ = unrotated
    monkeypatch.setattr(loop, "EarlyStopping", StopAfterTwo)
    path = _rotation_config(tmp_path, data, **{"debug.epochs": 6})
    out = _port_train(path)
    assert (out["epoch"], out["total_steps"]) == (2, 10)
    assert _rotated(path) == [True, True]
    latest = _checkpoint(path, "latest")
    assert (latest["epoch"], latest["total_steps"]) == (2, 10)
    got = _state(out)
    for sec in ("model_state", "optim_state"):
        assert sorted(got[sec]) == sorted(latest[sec])
        for k, v in got[sec].items():
            assert np.array_equal(v.numpy(), latest[sec][k]), f"{sec}/{k}"
    # epochs 1 and 2 as the unrotated run logged them, nothing of epoch 3
    assert _lines_but_times(path) == [m for m in lines if m["epoch"] <= 2]


def test_panel_writer_failure_is_raised_from_train(tmp_path, monkeypatch):
    """A failure of the background panel writer is raised from ``train()``
    (at the next join, here the trainer's exit), as the JAX loop's is
    (``tests/test_panel_writer.py``)."""

    def boom(*args, **kwargs):
        raise RuntimeError("panel writer exploded")

    monkeypatch.setattr(loop, "sample_reconstructions", boom)
    path = _config(tmp_path, **{"debug.epochs": 1})
    with pytest.raises(RuntimeError, match="panel writer exploded"):
        _port_train(path)


def test_panel_writer_failure_does_not_mask_a_loop_error(tmp_path,
                                                         monkeypatch, capsys):
    """Epoch 1's panel fails on its thread, then epoch 2's probes raise:
    ``train()`` raises the loop's error, prints the writer's, and the
    checkpoints still land."""
    def boom(*args, **kwargs):
        raise RuntimeError("panel writer exploded")

    calls = []
    probes = loop.compute_probe_metrics

    def failing_probes(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("probe failure in epoch 2")
        return probes(*args, **kwargs)

    monkeypatch.setattr(loop, "sample_reconstructions", boom)
    monkeypatch.setattr(loop, "compute_probe_metrics", failing_probes)
    path = _config(tmp_path)
    with pytest.raises(ValueError, match="probe failure in epoch 2"):
        _port_train(path)
    out = capsys.readouterr().out
    assert "[PANEL] background writer also failed" in out
    assert "panel writer exploded" in out
    assert read_checkpoint_meta(str(tmp_path / "outputs" / "models" /
                                    "run_latest.pt"))["epoch"] == 1


@pytest.mark.parametrize("chunk_mb,k,train_uploads,val_uploads", [
    (1e-9, 1, [1] * 5, [1, 1]), (0.002, 2, [2, 2, 1], [2])],
    ids=["one-batch", "two-batches"])
def test_host_fed_chunks_are_the_device_fed_run(unrotated, tmp_path,
                                                monkeypatch, chunk_mb, k,
                                                train_uploads, val_uploads):
    """Both splits fed from the host at ``scan_chunk_steps: 4``: K =
    min(4, 5 steps, ``host_feed_chunk_limit``) = 1 (one batch in the
    budget) or 2, each chunk's batches one upload (the train epoch in 5 or
    3 uploads, the validation pass in 2 or 1), with rotation on; every
    METRICS line but the wall times, the checkpoints and the returned
    state bitwise the device-fed run's."""
    from betavae_tpu_torch.data.pipeline import DeviceData

    data, lines, saves, state = unrotated
    assert host_feed_chunk_limit(4, (16, 16, 1), chunk_mb) == k
    uploads, chunk_k = [], []
    stage = DeviceData.stage

    def recording_stage(self, idx):
        uploads.append(len(idx))
        return stage(self, idx)

    class RecordingChunks(loop.TrainChunks):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            chunk_k.append(self.k)

    monkeypatch.setattr(DeviceData, "stage", recording_stage)
    monkeypatch.setattr(loop, "TrainChunks", RecordingChunks)
    path = _rotation_config(tmp_path, data, **{
        "training.scan_chunk_steps": 4,
        "training.max_device_dataset_mb": 0,
        "training.host_feed_chunk_mb": chunk_mb})
    out, got_saves = _train_saving(path)
    assert chunk_k == [k]
    assert uploads == (train_uploads + val_uploads) * 3
    assert _lines_but_times(path) == lines
    _assert_saves_equal(got_saves, saves)
    got = _state(out)
    for sec, part in state.items():
        for key, v in part.items():
            assert torch.equal(got[sec][key], v), f"{sec}/{key}"


class _Mesh:
    """A stand-in for a mesh: only its backend is read."""

    def __init__(self, backend):
        self.backend = backend


@pytest.mark.parametrize("k,device,mesh,way", [
    (192, "cuda", None, "cuda_graph"),
    (192, "cuda", "nccl", "cuda_graph"),
    (192, "cuda", "gloo", "eager: gloo"),
    (1, "cuda", "nccl", "eager: scan_chunk_steps 1"),
    (192, "cpu", "gloo", "eager: cpu"),
    (192, "cpu", None, "eager: cpu")],
    ids=["one-process", "nccl", "gloo", "k1", "cpu-gloo", "cpu"])
def test_dispatch_way_replays_all_but_gloo_on_the_card(k, device, mesh, way):
    """The trainers' dispatch: on the card the steps replay a CUDA graph in
    one process, resident or fed from the host (the split plays no part),
    and over an NCCL mesh; a gloo mesh steps eagerly, and the CONFIG line
    says so by ``step_dispatch``; ``scan_chunk_steps: 1`` and the CPU step
    eagerly by design, with the JAX package's CONFIG line."""
    dev = torch.device(device)
    got = dispatch_way(k, dev, None if mesh is None else _Mesh(mesh))
    assert got == way
    assert dispatch_note(got, dev) == (
        {"step_dispatch": "eager: gloo"} if way == "eager: gloo" else {})


# ---------------------------------------------------------------------------
# one of several NCCL ranks: graphs launched from the host, each dispatch a
# job of the run's queue of device work, run on a dispatcher thread
# ---------------------------------------------------------------------------

def _dispatcher_path(mp, log=None) -> tuple:
    """The path of one of several NCCL ranks, on the CPU:
    ``chunks._several_ranks`` patched true, so that the run's queue of
    device work runs on a dispatcher thread, and the graph stand-in of
    :func:`_stub_graphs` behind a gate that opens only while the training
    thread waits for the queue (a fence, a read of a job's rows), as if the
    device ran nothing meanwhile: whatever the training thread does between
    two waits runs ahead of every launch queued before it.  Returns
    ``(runs, jobs)``: ``_stub_graphs``' runs, and each job submitted with
    whether it had run when its submit returned."""
    from betavae_tpu_torch.device import DeviceQueue
    from betavae_tpu_torch.train import chunks

    gate = threading.Event()
    wait, submit = DeviceQueue._wait, DeviceQueue.submit
    jobs = []

    def waiting(self, ready):
        gate.set()
        try:
            wait(self, ready)
        finally:
            gate.clear()

    def submitted(self, fn, meta=None):
        job = submit(self, fn, meta)
        jobs.append((job, job.done))
        return job

    mp.setattr(DeviceQueue, "_wait", waiting)
    mp.setattr(DeviceQueue, "submit", submitted)
    mp.setattr(chunks, "_several_ranks", lambda: True)
    return _stub_graphs(mp, gate, log), jobs


class _StopAfterTwo:
    """An early stop after the second epoch."""

    def __init__(self, *args, **kwargs):
        self.calls = 0
        self.should_stop = False

    def update(self, value):
        self.calls += 1
        self.should_stop = self.calls >= 2


@pytest.mark.parametrize("case,jobs_run", [
    ("rotated", 9 + 3), ("early-stop", 6 + 1 + 2), ("host-fed", 9 + 3)])
def test_host_launched_dispatch_returns_at_once_and_trains_bitwise(
        unrotated, tmp_path, monkeypatch, case, jobs_run):
    """One of several ranks on the CPU (:func:`_dispatcher_path`), the
    :data:`_ROTATION_CFG` run (3 chunks of 2, 2 and 1 steps an epoch, a
    validation pass of 2 batches): every job, each train chunk's and each
    validation pass's, has not run when its dispatch returns, its launches
    still blocked, and the run is bitwise the eager unrotated run's.
    ``rotated``: rotation on, every METRICS line but the wall times,
    every checkpoint written and the returned state.  ``early-stop``: the
    early stop at epoch 2 discards the rotated epoch-3 chunk; ``latest``
    says epoch 2 and holds the returned state, the lines are epochs 1-2's,
    and the snapshot's restore ran after every launch queued.
    ``host-fed``: both splits fed from the host, 2 batches an upload."""
    from betavae_tpu_torch.train.callbacks import StateSnapshot

    data, lines, saves, state = unrotated
    log = []
    runs, jobs = _dispatcher_path(monkeypatch, log)
    restored = []
    restore = StateSnapshot.restore

    def recording(self):
        restore(self)
        restored.append(len(log))

    monkeypatch.setattr(StateSnapshot, "restore", recording)
    if case == "early-stop":
        monkeypatch.setattr(loop, "EarlyStopping", _StopAfterTwo)
        path = _rotation_config(tmp_path, data, **{"debug.epochs": 6})
        out = _port_train(path)
        assert (out["epoch"], out["total_steps"]) == (2, 10)
        assert _rotated(path) == [True, True]
        latest = _checkpoint(path, "latest")
        assert (latest["epoch"], latest["total_steps"]) == (2, 10)
        got = _state(out)
        for sec in ("model_state", "optim_state"):
            assert sorted(got[sec]) == sorted(latest[sec])
            for k, v in got[sec].items():
                assert np.array_equal(v.numpy(), latest[sec][k]), f"{sec}/{k}"
        assert _lines_but_times(path) == [m for m in lines if m["epoch"] <= 2]
        # the capture's restore, then the early stop's, after every launch
        assert restored == [0, len(log)] and len(log) == 10 + 2 + 2 * 2
    else:
        overrides = {"training.epoch_rotation": True}
        if case == "host-fed":
            overrides.update({"training.scan_chunk_steps": 4,
                              "training.max_device_dataset_mb": 0,
                              "training.host_feed_chunk_mb": 0.002})
        path = _rotation_config(tmp_path, data, **overrides)
        out, got_saves = _train_saving(path)
        assert _rotated(path) == [True, True, False]
        assert _lines_but_times(path) == lines
        _assert_saves_equal(got_saves, saves)
        got = _state(out)
        for sec, part in state.items():
            for key, v in part.items():
                assert torch.equal(got[sec][key], v), f"{sec}/{key}"
    assert all(n == launches for _, n, launches in runs), runs
    assert [done for _, done in jobs] == [False] * jobs_run


@pytest.mark.parametrize("kind,runs_before", [("TrainChunks", 1),
                                              ("EvalChunks", 3 + 1 + 3)])
def test_a_failed_job_on_the_dispatcher_is_raised_from_train(
        unrotated, tmp_path, monkeypatch, kind, runs_before):
    """A launch that fails in a job on the dispatcher thread (the second
    train chunk's; the second validation pass's) is kept and raised from
    ``train()``, and no job runs after it: the jobs queued behind it (the
    next chunk; the rotated chunk) launch nothing."""
    from betavae_tpu_torch.train import chunks

    runs, _ = _dispatcher_path(monkeypatch)
    run = chunks._Chunked._run
    calls = []

    def failing(self, images, n):
        calls.append(type(self).__name__)
        if calls.count(kind) == 2 and type(self).__name__ == kind:
            raise RuntimeError(f"a launch of {kind} failed")
        run(self, images, n)

    monkeypatch.setattr(chunks._Chunked, "_run", failing)
    path = _rotation_config(tmp_path, unrotated[0])
    with pytest.raises(RuntimeError, match=f"a launch of {kind} failed"):
        _port_train(path)
    # the failed launch is the last one made
    assert len(calls) == runs_before + 1 and calls[-1] == kind
    assert len(runs) == runs_before


@pytest.mark.parametrize("collective", ["gather_rows", "global_sum",
                                        "mean_over_ranks_"])
def test_an_eager_collective_waits_for_the_queued_launches(monkeypatch,
                                                           collective):
    """An eager collective of ``parallel/reduce.py`` (through a stand-in
    for ``torch.distributed``) called on the thread that submitted a job
    runs only after the job's launch, blocked until then at the gate: the
    queue is fenced first, as NCCL needs every rank's collectives in one
    order.  The same collective inside the job, on the dispatcher thread,
    does not wait for its own job."""
    from betavae_tpu_torch.device import DeviceQueue
    from betavae_tpu_torch.parallel import reduce

    gate, order = threading.Event(), []
    wait = DeviceQueue._wait

    def waiting(self, ready):
        gate.set()
        try:
            wait(self, ready)
        finally:
            gate.clear()

    def all_gather(parts, t, group=None):
        order.append("collective")
        for p in parts:
            p.copy_(t)

    def all_reduce(t, op=None, group=None):
        order.append("collective")

    def call():
        t = torch.ones(2)
        if collective == "gather_rows":
            return reduce.gather_rows(t, group="mesh")
        if collective == "global_sum":
            return reduce.global_sum(t, group="mesh")
        return reduce.mean_over_ranks_(t, group="mesh")

    def job():
        if not gate.wait(60):
            raise RuntimeError("the launch was never let through")
        order.append("launch")
        return call()

    monkeypatch.setattr(DeviceQueue, "_wait", waiting)
    monkeypatch.setattr(reduce.dist, "all_gather", all_gather)
    monkeypatch.setattr(reduce.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(reduce.dist, "get_world_size", lambda group=None: 2)
    queue = DeviceQueue(torch.device("cpu"), threaded=True)
    try:
        queued = queue.submit(job)
        eager = call()
        assert torch.equal(eager, queued.result())
    finally:
        queue.close()
    assert order == ["launch", "collective", "collective"]


@pytest.mark.parametrize("grad,autocast", [(False, False), (True, True)])
@pytest.mark.parametrize("threaded", [False, True],
                         ids=["inline", "dispatcher"])
def test_a_job_runs_under_the_callers_grad_mode_and_autocast(threaded, grad,
                                                             autocast):
    """Grad mode and autocast are per thread in PyTorch: a job runs under
    the caller's, as they were at its submit, on the dispatcher thread
    (``threaded``) or at once on the caller's."""
    from betavae_tpu_torch.device import DeviceQueue

    queue = DeviceQueue(torch.device("cpu"), threaded=threaded)

    def state():
        return (threading.current_thread().name, torch.is_grad_enabled(),
                torch.is_autocast_enabled("cpu"),
                torch.get_autocast_dtype("cpu"))

    try:
        with torch.set_grad_enabled(grad), torch.autocast(
                "cpu", dtype=torch.bfloat16, enabled=autocast):
            job = queue.submit(state)
        got = job.result()
    finally:
        queue.close()
    name = ("betavae-dispatch" if threaded
            else threading.current_thread().name)
    assert got == (name, grad, autocast, torch.bfloat16)


@pytest.mark.parametrize("graphs,several,threaded", [
    (True, True, True), (True, False, False), (False, True, False),
    (False, False, False)])
def test_the_dispatcher_thread_runs_only_where_graphs_launch_from_the_host(
        monkeypatch, graphs, several, threaded):
    """A run's queue of device work is threaded only where its captured
    graphs launch from the host (one of several ranks); one process, and
    the eager steps (a gloo mesh, the CPU, ``scan_chunk_steps: 1``), run
    each job at once on the caller's thread.  No config key or
    environment variable selects it."""
    from betavae_tpu_torch.train import chunks

    monkeypatch.setattr(chunks, "_several_ranks", lambda: several)
    assert chunks.device_queue(torch.device("cpu"), graphs).threaded is \
        threaded


def test_device_queues_keep_their_order_under_thread_switches():
    """Sixteen threaded queues, each fed by its own thread (more threads
    than cores), with a switch interval of 1 µs: each queue runs its 300
    jobs in the order submitted; a job's result, once read, has every
    earlier job run; ``fence_device_queues`` on a feeding thread has every
    job its thread submitted run.  Bounded: each feeder joined within 60
    s."""
    import sys

    from betavae_tpu_torch.device import DeviceQueue, fence_device_queues

    errors = []

    def feed() -> None:
        queue = DeviceQueue(torch.device("cpu"), threaded=True)
        seen = []
        try:
            for n in range(300):
                job = queue.submit(lambda n=n: seen.append(n) or n)
                if n % 37 == 0 and (job.result() != n
                                    or seen[:n + 1] != list(range(n + 1))):
                    errors.append(("result", n, list(seen)))
                if n % 50 == 49:
                    fence_device_queues()
                    if seen != list(range(n + 1)):
                        errors.append(("fence", n, list(seen)))
        finally:
            queue.close()
        if seen != list(range(300)):
            errors.append(("order", list(seen)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feeders = [threading.Thread(target=feed) for _ in range(16)]
        for t in feeders:
            t.start()
        for t in feeders:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in feeders)
    assert errors == []
