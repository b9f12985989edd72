"""The port's background checkpoint writer and SIGTERM drain, on the CPU.

Modelled on ``tests/test_async_checkpoint.py`` and
``tests/test_graceful_shutdown.py``: the writer's files equal a synchronous
save's, queued snapshots coalesce (latest wins) without blocking the
caller, ``best`` is written before ``latest``, a snapshot holds the state
at save time, a failed write is raised at the next save and at ``drain()``,
``train()`` with ``training.async_checkpoint`` resumes bitwise like the
synchronous run, and SIGTERM mid-run leaves a whole, loadable ``latest``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.io.checkpoint import load_sharded_checkpoint
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.models.beta_vae import BetaVAEModule, init_weights
from betavae_tpu_torch.train import callbacks as cb
from betavae_tpu_torch.train.callbacks import CheckpointManager
from betavae_tpu_torch.train.loop import train
from betavae_tpu_torch.train.optim import build_optimizer

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def port_config(demo_config_factory):
    """The tiny demo config loaded into the port's config singleton."""
    reset_config_cache()
    cfg = get_config(demo_config_factory())
    yield cfg
    reset_config_cache()


def _trained(steps: int = 1):
    """A tiny model and its Adam optimizer after ``steps`` updates, so the
    optimizer has state to save."""
    model = BetaVAEModule(image_size=16, in_channels=1, latent_dim=4,
                          base_channels=8, num_blocks=2, se_reduction=4)
    init_weights(model, torch.Generator().manual_seed(0))
    optimizer = build_optimizer(model.parameters())
    x = torch.rand(2, 1, 16, 16, generator=torch.Generator().manual_seed(1))
    for _ in range(steps):
        optimizer.zero_grad()
        model(x, deterministic=True)[0].mean().backward()
        optimizer.step(1e-3)
    return model, optimizer


def _latest(cfg) -> dict:
    return load_sharded_checkpoint(
        os.path.join(cfg.paths.models_dir, f"{cfg.paths.run_id}_latest.pt"))


def _assert_same_payload(a: dict, b: dict) -> None:
    for key in ("epoch", "total_steps", "val_total"):
        assert a[key] == b[key], key
    for sec in ("model_state", "optim_state"):
        assert sorted(a[sec]) == sorted(b[sec])
        for k in a[sec]:
            np.testing.assert_array_equal(a[sec][k], b[sec][k], f"{sec}/{k}")


def _slow_save(monkeypatch, seconds: float, calls: list | None = None):
    real = cb.save_sharded_checkpoint

    def slow(path, payload, num_shards=2):
        if calls is not None:
            calls.append((os.path.basename(path), payload["epoch"]))
        time.sleep(seconds)
        return real(path, payload, num_shards=num_shards)

    monkeypatch.setattr(cb, "save_sharded_checkpoint", slow)


def test_async_save_matches_sync(port_config):
    model, optimizer = _trained()
    sync = CheckpointManager(async_io=False)
    sync.save_latest(model, optimizer, 3, 11, {"val_total": 1.5})
    want = _latest(port_config)
    asy = CheckpointManager(async_io=True)
    asy.save_latest(model, optimizer, 3, 11, {"val_total": 1.5})
    asy.drain()
    assert (sync.writes, asy.writes) == (1, 1)
    _assert_same_payload(_latest(port_config), want)
    assert any(k.endswith("/exp_avg") for k in want["optim_state"])


def test_async_saves_coalesce_latest_wins(port_config, monkeypatch):
    """Eight saves while each write takes 0.3 s: queued snapshots are
    replaced, the saves do not wait for the writes, and the file holds the
    last one after ``drain()``."""
    _slow_save(monkeypatch, 0.3)
    model, optimizer = _trained()
    m = CheckpointManager(async_io=True)
    t0 = time.perf_counter()
    for epoch in range(1, 9):
        m.save_latest(model, optimizer, epoch, epoch * 10, {})
    enqueue_seconds = time.perf_counter() - t0
    m.drain()
    assert m.coalesced >= 1 and m.writes <= 4
    assert m.writes + m.coalesced == 8
    assert enqueue_seconds < 0.3 * 4
    payload = _latest(port_config)
    assert (payload["epoch"], payload["total_steps"]) == (8, 80)


def test_best_is_written_before_latest(port_config, monkeypatch):
    """With the writer busy, a queued ``latest`` and a later ``best``: the
    writer takes ``best`` first."""
    calls = []
    release = threading.Event()
    real = cb.save_sharded_checkpoint

    def gated(path, payload, num_shards=2):
        calls.append((os.path.basename(path), payload["epoch"]))
        release.wait(timeout=30)
        return real(path, payload, num_shards=num_shards)

    monkeypatch.setattr(cb, "save_sharded_checkpoint", gated)
    model, optimizer = _trained()
    m = CheckpointManager(async_io=True)
    m.save_latest(model, optimizer, 1, 1, {})
    deadline = time.time() + 30
    while not calls and time.time() < deadline:   # the writer takes epoch 1
        time.sleep(0.01)
    assert calls, "the writer never started"
    m.save_latest(model, optimizer, 2, 2, {})
    m.save_best(model, optimizer, 2, 2, {"val_total": 1.0},
                monitor_value=1.0)
    release.set()
    m.drain()
    assert calls == [("testrun_latest.pt", 1), ("testrun_best.pt", 2),
                     ("testrun_latest.pt", 2)]


def test_snapshot_holds_the_state_at_save_time(port_config, monkeypatch):
    """Parameters and optimizer state changed in place after the save (as
    the next step changes them) do not reach the queued snapshot."""
    _slow_save(monkeypatch, 0.3)
    model, optimizer = _trained()
    want_model = {k: v.detach().clone() for k, v in model.state_dict().items()}
    m = CheckpointManager(async_io=True)
    m.save_best(model, optimizer, 1, 1, {"val_total": 2.0}, monitor_value=2.0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(100.0)
    for state in optimizer.optimizer.state.values():
        state["exp_avg"].add_(100.0)
    m.drain()
    payload = load_sharded_checkpoint(os.path.join(
        port_config.paths.models_dir, "testrun_best.pt"))
    for k, v in want_model.items():
        np.testing.assert_array_equal(payload["model_state"][k], v.numpy())
    exp_avg = [v for k, v in payload["optim_state"].items()
               if k.endswith("/exp_avg")]
    assert exp_avg and all(np.abs(v).max() < 50.0 for v in exp_avg)


def _failing_save(monkeypatch):
    def fail(path, payload, num_shards=2):
        raise OSError("disk full")

    monkeypatch.setattr(cb, "save_sharded_checkpoint", fail)


def test_failed_write_is_raised_at_the_next_save(port_config, monkeypatch):
    _failing_save(monkeypatch)
    model, optimizer = _trained()
    m = CheckpointManager(async_io=True)
    m.save_latest(model, optimizer, 1, 1, {})
    for _ in range(200):                  # let the writer meet the error
        with m._lock:
            if m._pending_error is not None:
                break
        time.sleep(0.01)
    with pytest.raises(OSError, match="disk full"):
        m.save_latest(model, optimizer, 2, 2, {})
    m.drain()                             # consumed at the save
    assert m.writes == 0


def test_failed_write_is_raised_at_drain(port_config, monkeypatch):
    _failing_save(monkeypatch)
    model, optimizer = _trained()
    m = CheckpointManager(async_io=True)
    m.save_latest(model, optimizer, 1, 1, {})
    with pytest.raises(OSError, match="disk full"):
        m.drain()
    m.drain()                             # consumed; the manager goes on
    monkeypatch.undo()
    m.save_latest(model, optimizer, 2, 2, {})
    m.drain()
    assert m.writes == 1 and _latest(port_config)["epoch"] == 2


def _train_config(root: Path, **overrides) -> str:
    """The debug config at 16 px with 2 blocks (3 train and 2 val batches
    of 4 an epoch), augmentation on, outputs and demo data under
    ``root``."""
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
    cfg["optimization"]["scheduler"] = "none"
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


def test_async_train_resumes_like_the_synchronous_run(tmp_path):
    """One epoch, ``resume latest`` and one more, with the background
    writer, equal two synchronous epochs in one run bitwise: the final
    weights and the ``latest`` checkpoint's every array."""
    whole = _port_train(_train_config(
        tmp_path / "sync", **{"debug.epochs": 2,
                              "training.async_checkpoint": False}))
    first = _train_config(tmp_path / "async", **{
        "debug.epochs": 1, "training.async_checkpoint": True})
    _port_train(first)
    second = _train_config(tmp_path / "async", **{
        "debug.epochs": 2, "training.async_checkpoint": True})
    parts = _port_train(second, resume="latest")
    assert parts["total_steps"] == whole["total_steps"] == 6
    for name, value in whole["model"].state_dict().items():
        assert torch.equal(parts["model"].state_dict()[name], value), name
    latest = [load_sharded_checkpoint(str(tmp_path / run / "outputs" /
                                          "models" / "run_latest.pt"))
              for run in ("sync", "async")]
    _assert_same_payload(*latest)


_RUNNER = """
import sys
sys.path.insert(0, {repo!r})
from betavae_tpu_torch.train.loop import train
train({cfg!r}, device="cpu")
"""


def test_sigterm_drains_and_leaves_a_loadable_latest(tmp_path):
    """SIGTERM after a few epochs: the run unwinds (non-zero exit), says
    how to resume, and ``latest`` is whole: both shards from one epoch,
    loadable."""
    cfg_path = _train_config(tmp_path / "run", **{
        "debug.epochs": 500, "debug.max_train_batches": 2,
        "debug.max_val_batches": 1, "training.async_checkpoint": True,
        "logging.log_to_file": True})
    log_path = tmp_path / "run" / "outputs" / "logs" / "run.log"
    runner = tmp_path / "runner.py"
    runner.write_text(_RUNNER.format(repo=str(ROOT), cfg=cfg_path))
    proc = subprocess.Popen([sys.executable, str(runner)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if log_path.exists() and sum(
                    1 for line in open(log_path)
                    if '"phase": "val"' in line) >= 3:
                break
            if proc.poll() is not None:
                pytest.fail(f"training exited early:\n{proc.stdout.read()}")
            time.sleep(0.2)
        else:
            pytest.fail("training never reached epoch 3")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode != 0
    assert "[SHUTDOWN] interrupted" in out and "--resume latest" in out
    base = tmp_path / "run" / "outputs" / "models" / "run_latest.pt"
    epochs = []
    for i in range(2):
        with zipfile.ZipFile(str(base).replace(".pt", f"_shard{i}.pt")) as zf:
            epochs.append(json.loads(zf.read("__meta__.json"))["epoch"])
    assert epochs[0] == epochs[1] >= 1
    payload = load_sharded_checkpoint(str(base))
    assert payload["epoch"] == epochs[0] and payload["model_state"]
