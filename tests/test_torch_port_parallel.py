"""Data parallelism in the port (``betavae_tpu_torch/parallel/``), on the CPU.

Each data-parallel run here is two gloo ranks, each a process spawned by
``parallel/launch.py`` and joined through a ``FileStore`` in a fresh
directory under ``$TMPDIR`` (no TCP port to collide between test
workers), with a share of the cores each.  The rank functions live in the
port (``parallel/launch.py::train_rank``) or in ``torch_port_dp_ranks.py``
beside this file, which imports the port alone, so a rank imports no JAX.  The geometries are tiny (16 px,
or 32 px with LPIPS, 2 blocks, a global batch of 4: 2 rows a rank).

- Against the JAX package: the port's ``train(mesh=…)`` on two ranks and
  the JAX ``train(mesh=data_parallel_mesh(2))`` (two of the test
  session's virtual CPU devices), resumed from the same reference shards,
  z = μ and augmentation off, so both take the same steps: the final
  parameters within ``tests/test_mesh_train.py``'s bounds (rtol 5e-4,
  atol 2e-4).
- Against the port's single process, augmentation on: one step from the
  same weights, in capacity mode with FFL, in β mode with free bits, with
  ``encoder_norm: batch`` and with LPIPS, and a padded last batch whose
  second half (rank 1's rows) is all padding: the loss and every metric
  within 1e-5 relative, every gradient within 1e-5 of its tensor's
  largest value (the BatchNorm running statistics too); the ranks' ε and
  augmented rows together bitwise the single process's.  After 3 steps
  the replicas are bitwise equal.  On a one-rank gloo mesh in this
  process the mesh's step (the gradients as views of one flat buffer,
  averaged by one all-reduce) is bitwise the single process's.
- The JAX mesh tests' other cases: the divisibility error, the device
  count over what is visible, remat with host feed, a resume, rank 0 as
  the one writer, SIGTERM to a ``--data-parallel 2`` launch draining rank
  0's writer, the bench's ``--data-parallel`` line, the dry run and the
  analytic scaling model.

Every two-rank run but the failing one, the interrupted one, the bench's
and the dry run's goes through two launches of one module fixture (``dp_runs``), so that
the ranks' start-up is paid twice rather than once a run.
"""

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest
import torch
import yaml

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.io.checkpoint import flatten_pytree
from betavae_tpu.logging_utils import reset_logger as jax_reset_logger
from betavae_tpu.parallel.mesh import data_parallel_mesh as jax_mesh
from betavae_tpu.train.loop import train as jax_train
from betavae_tpu.utils.flops import data_parallel_scaling as jax_scaling

from betavae_tpu_torch import bench
from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.models.beta_vae import model_from_config
from betavae_tpu_torch.io.checkpoint import load_sharded_checkpoint
from betavae_tpu_torch.io.weights import params_from_jax
from betavae_tpu_torch.parallel import dryrun as dryrun_module
from betavae_tpu_torch.parallel.dryrun import Case
from betavae_tpu_torch.parallel.launch import launch, train_rank
from betavae_tpu_torch.parallel.mesh import (DataParallelMesh,
                                             data_parallel_mesh, mesh_devices)
from betavae_tpu_torch.utils.flops import data_parallel_scaling

from test_torch_port_train import (ROOT, _config, _log, _port_train,
                                   _reference_shards)
from torch_port_dp_ranks import record_and_train, record_steps

TWO_CPU_RANKS = ["cpu", "cpu"]
B = 4
JAX_COMMON = {"model.deterministic_overfit": True,
              "augmentation.use_augmentations": False,
              "optimization.scheduler": "none"}


def _latest_state(path) -> dict:
    cfg = yaml.safe_load(open(path))
    payload = load_sharded_checkpoint(
        os.path.join(cfg["paths"]["models_dir"], "run_latest.pt"))
    return {k: np.asarray(v) for k, v in payload["model_state"].items()}


def _models_dir(path) -> str:
    return yaml.safe_load(open(path))["paths"]["models_dir"]


def _case_config(root, name, **overrides) -> str:
    """The debug config cut to 16 px, 2 blocks, latent 4, base 4, fp32,
    with ``overrides`` (``section.key``); no data (a case brings its
    images)."""
    cfg = yaml.safe_load(open(ROOT / "configs" / "beta_vae_se_debug.yaml"))
    cfg["data"]["image_size"] = 16
    cfg["model"].update(latent_dim=4, base_channels=4, num_blocks=2)
    cfg["training"].update(batch_size=B, mixed_precision=False)
    cfg["loss"].update(use_lpips=False)
    for key, val in overrides.items():
        sec, key_ = key.split(".")
        cfg[sec][key_] = val
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


CAPACITY = {"loss.capacity_weight": 1.0,
            "loss.capacity_schedule": {"enabled": True, "C_start": 5.0,
                                       "C_end": 25.0, "warmup_epochs": 30,
                                       "total_epochs": 50},
            "loss.use_ffl": True, "loss.ffl_weight": 0.5}
SCHED_CAPACITY = {"beta": 1.0, "capacity": 5.0, "capacity_weight": 1.0,
                  "free_bits": 0.0, "lr": 1e-3}
SCHED_FREE_BITS = {"beta": 1.3, "capacity": 0.0, "capacity_weight": 1.0,
                   "free_bits": 0.5, "lr": 1e-3}


def _cases(root) -> dict:
    """One-step cases from the same weights (and a three-step one)."""
    rng = np.random.default_rng(11)
    images16 = rng.integers(0, 256, (12, 16, 16, 1), dtype=np.uint8)
    images32 = rng.integers(0, 256, (12, 32, 32, 1), dtype=np.uint8)
    full = (np.array([7, 2, 9, 4], np.int32), np.ones(B, np.float32))
    cap = _case_config(root, "capacity", **CAPACITY)
    return {
        "capacity_ffl": Case(images16, [full], [SCHED_CAPACITY], config=cap),
        "free_bits": Case(images16, [full], [SCHED_FREE_BITS], config=(
            _case_config(root, "free_bits", **{"loss.free_bits": 0.5}))),
        "batch_norm": Case(images16, [full], [SCHED_CAPACITY], config=(
            _case_config(root, "batch_norm", **CAPACITY,
                         **{"model.encoder_norm": "batch"}))),
        "lpips": Case(images32, [full], [SCHED_CAPACITY], config=(
            _case_config(root, "lpips", **CAPACITY, **{
                "data.image_size": 32, "loss.use_lpips": True,
                "loss.lpips_weight": 20.0}))),
        # the last batch of an epoch: two real rows, then padding that
        # repeats them, which is all of rank 1's share
        "masked": Case(images16, [(np.array([3, 5, 3, 5], np.int32),
                                   np.array([1, 1, 0, 0], np.float32))],
                       [SCHED_CAPACITY], config=cap),
        "three_steps": Case(images16, [
            (rng.permutation(12)[:B].astype(np.int32),
             np.ones(B, np.float32)) for _ in range(3)],
            [SCHED_CAPACITY] * 3, config=cap),
    }


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The two-rank runs of this file, in two launches, and the single
    process's counterparts: ``{"cases": {name: (ranks' records, single
    record)}, "paths": {...}, "trains": {name: ranks' results},
    "single_resume": state}``."""
    root = tmp_path_factory.mktemp("dp")
    cases = _cases(root)
    # the JAX comparison: reference shards written once, copied for the port
    jax_path = _config(root / "jax", **JAX_COMMON)
    _reference_shards(jax_path, steps=3)
    port_path = _config(root / "port", **JAX_COMMON, **{
        "paths.processed_dir": str(root / "jax" / "processed")})
    shutil.copytree(_models_dir(jax_path), _models_dir(port_path))
    shared = {"paths.processed_dir": str(root / "plain" / "processed")}
    paths = {
        "jax": jax_path, "port": port_path,
        "plain": _config(root / "plain"),
        "remat_host": _config(root / "remat_host", **shared, **{
            "training.remat": True, "training.max_device_dataset_mb": 0}),
        "resume": _config(root / "resume", **shared, **{"debug.epochs": 1}),
        "host_launched": _config(root / "host_launched", **shared),
    }
    trains = ("port", "plain", "remat_host", "resume", "host_launched")
    first = launch(record_and_train, TWO_CPU_RANKS, (list(cases.values()), [
        (paths[name], "latest" if name == "port" else "none",
         name == "host_launched") for name in trains]))
    # the resume: the epoch-1 checkpoint the ranks wrote, copied for the
    # single process, then one more epoch on the ranks
    snap = str(root / "resume_snap")
    shutil.copytree(_models_dir(paths["resume"]), snap)
    raw = yaml.safe_load(open(paths["resume"]))
    raw["debug"]["epochs"] = 2
    paths["resume2"] = str(root / "resume" / "config2.yaml")
    yaml.safe_dump(raw, open(paths["resume2"], "w"))
    resumed = launch(train_rank, TWO_CPU_RANKS,
                     (paths["resume2"], "latest", "cpu"))
    mesh_resumed = _latest_state(paths["resume2"])
    shutil.rmtree(_models_dir(paths["resume2"]))
    shutil.copytree(snap, _models_dir(paths["resume2"]))
    single = _port_train(paths["resume2"], resume="latest")
    return {
        "cases": {name: ([r[0][i] for r in first], record_steps(None, case))
                  for i, (name, case) in enumerate(cases.items())},
        "paths": paths,
        "trains": {**{name: [r[1][i] for r in first]
                      for i, name in enumerate(trains)},
                   "resume2": resumed},
        "mesh_resumed": mesh_resumed,
        "single_resumed": (single["epoch"], {
            k: v.numpy() for k, v in single["model"].state_dict().items()}),
    }


# ---------------------------------------------------------------------------
# against the JAX package's mesh
# ---------------------------------------------------------------------------

def test_train_on_two_ranks_matches_jax_train_on_a_two_device_mesh(dp_runs):
    """The same reference shards (epoch 1 after 3 steps, Adam state)
    resumed for one more epoch by the JAX ``train(mesh=data_parallel_mesh(
    2))`` and by the port's ``train(mesh=…)`` on two ranks, z = μ
    (``model.deterministic_overfit``, under which ``fc_logvar`` gets no
    gradient: its view of the flat gradient buffer stays zero) and
    augmentation off: final parameters at ``test_mesh_train.py``'s
    bounds."""
    jax_reset_config()
    jax_reset_logger()
    try:
        jax_get_config(dp_runs["paths"]["jax"])
        state = jax_train(resume="latest", mesh=jax_mesh(2))
    finally:
        jax_reset_logger()
        jax_reset_config()
    ranks = dp_runs["trains"]["port"]
    assert [(r["epoch"], r["total_steps"]) for r in ranks] == [(2, 6)] * 2
    want = params_from_jax(flatten_pytree(state.model_variables()))
    got = _latest_state(dp_runs["paths"]["port"])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value.numpy(), rtol=5e-4,
                                   atol=2e-4, err_msg=key)


# ---------------------------------------------------------------------------
# one step against the port's single process
# ---------------------------------------------------------------------------

ONE_STEP_CASES = ("capacity_ffl", "free_bits", "batch_norm", "lpips",
                  "masked")


@pytest.mark.parametrize("name", ONE_STEP_CASES)
def test_one_step_on_two_ranks_equals_one_process(dp_runs, name):
    """Loss and metrics 1e-5 relative (atol 1e-6); each gradient, after
    the ranks' mean and before the clip, within 1e-5 relative plus 1e-5 of
    its tensor's largest value (under BatchNorm, the conv biases before it,
    whose gradient is rounding noise, within 1e-5 of the largest gradient
    anywhere), and the same on both ranks, bitwise; the BatchNorm running
    statistics 1e-5 relative (atol 1e-6); the ranks' ε and augmented
    rows, concatenated, bitwise the single process's."""
    ranks, single = dp_runs["cases"][name]
    assert ranks[0]["totals"] == ranks[1]["totals"]
    assert ranks[0]["totals"][0] == pytest.approx(single["totals"][0],
                                                  rel=1e-5)
    for key, want in single["metrics"].items():
        assert ranks[0]["metrics"][key] == pytest.approx(
            want, rel=1e-5, abs=1e-6), key
    if name == "lpips":
        assert ranks[0]["metrics"]["recon_lpips"] > 0
    assert set(ranks[0]["grads"]) == set(single["grads"])
    largest = max(np.abs(g).max() for g in single["grads"].values())
    for key, want in single["grads"].items():
        got = ranks[0]["grads"][key]
        assert np.array_equal(got, ranks[1]["grads"][key]), key
        if name == "batch_norm" and key.endswith((".0.conv.bias",
                                                  ".1.conv.bias",
                                                  "up.1.bias")):
            # a conv bias right before train-mode BatchNorm has a gradient
            # of exactly zero in exact arithmetic (ROADMAP C4): both sides
            # hold rounding noise, bounded against the largest gradient
            assert np.abs(got).max() <= 1e-5 * largest, key
            assert np.abs(want).max() <= 1e-5 * largest, key
            continue
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)
    for key, want in single["state"].items():
        if "running" in key:
            np.testing.assert_allclose(ranks[0]["state"][key], want,
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    for part in ("x", "eps"):
        assert np.array_equal(np.concatenate([r[part] for r in ranks]),
                              single[part]), part


def test_replicas_are_bitwise_equal_after_three_steps(dp_runs):
    """Three steps (capacity, FFL, augmentation): both ranks hold the same
    parameters and buffers, bit for bit, and their losses stay within 1e-4
    relative of the single process's (Adam carries the first steps'
    rounding on)."""
    ranks, single = dp_runs["cases"]["three_steps"]
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    for key, value in ranks[0]["state"].items():
        assert np.array_equal(value, ranks[1]["state"][key]), key
    np.testing.assert_allclose(ranks[0]["totals"], single["totals"],
                               rtol=1e-4)


@pytest.mark.parametrize("overfit", [False, True],
                         ids=["capacity_ffl", "deterministic_overfit"])
def test_one_rank_mesh_step_is_the_single_process_step_bitwise(tmp_path,
                                                              overfit):
    """The mesh's step (global sums, the gradients as views of one flat
    buffer averaged by one all-reduce) on a one-rank gloo mesh in this
    process: the first total, every gradient after the sync and the
    parameters and buffers after the update bitwise the single process's.
    Under ``model.deterministic_overfit`` ``fc_logvar`` gets no gradient
    (its view stays zero where the single process holds none) and the
    update moves it as the single process's does."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (12, 16, 16, 1), dtype=np.uint8)
    case = Case(images, [(np.array([7, 2, 9, 4], np.int32),
                          np.ones(B, np.float32))], [SCHED_CAPACITY],
                config=_case_config(tmp_path, "case", **CAPACITY, **{
                    "model.deterministic_overfit": overfit}))
    single = record_steps(None, case)
    mesh = data_parallel_mesh(devices=["cpu"])
    try:
        one = record_steps(mesh, case)
    finally:
        mesh.close()
    assert one["totals"] == single["totals"]
    unused = set(one["grads"]) - set(single["grads"])
    assert unused == ({"fc_logvar.weight", "fc_logvar.bias"} if overfit
                      else set())
    for key in unused:
        assert not one["grads"][key].any(), key
    for key, want in single["grads"].items():
        assert np.array_equal(one["grads"][key], want), key
    assert set(one["state"]) == set(single["state"])
    for key, want in single["state"].items():
        assert np.array_equal(one["state"][key], want), key


# ---------------------------------------------------------------------------
# the rest of the JAX mesh tests' cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,error,match", [
    (dict(n_devices=2), ValueError, "visible"),
    (dict(devices=["cuda:0", "cuda:0"]), ValueError, "backend='gloo'"),
    (dict(devices=["cpu", "cpu"], backend="nccl"), ValueError,
     "one CUDA device a rank"),
    (dict(devices=["cpu", "cuda:0"], backend="gloo"), ValueError,
     "CUDA devices or on the CPU"),
])
def test_mesh_refuses_what_it_cannot_run(kwargs, error, match):
    """Never truncated, never moved to the CPU, NCCL never shares a card
    (``mesh.py:33-42`` of the JAX package raises on the device count
    too); this machine's CUDA devices are fewer than 2 where it runs."""
    if torch.cuda.device_count() >= 2 and "n_devices" in kwargs:
        pytest.skip("two CUDA devices are visible")
    with pytest.raises(error, match=match):
        data_parallel_mesh(**kwargs)


def test_mesh_rows_split_the_batch_as_the_data_axis_does():
    """Rank r of W holds rows [r·B/W, (r+1)·B/W); a batch that does not
    divide raises, and two ranks are never joined from one process."""
    meshes = [DataParallelMesh(rank=r, world=4, device=torch.device("cpu"),
                               backend="gloo", group=None)
              for r in range(4)]
    assert [m.rows(8) for m in meshes] == [slice(0, 2), slice(2, 4),
                                           slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="divide evenly"):
        meshes[1].rows(6)
    with pytest.raises(RuntimeError, match="own process"):
        data_parallel_mesh(devices=TWO_CPU_RANKS)
    assert mesh_devices(3, "cpu") == ["cpu"] * 3
    if torch.cuda.device_count() < 3:
        with pytest.raises(ValueError, match="visible"):
            mesh_devices(3, "cuda")


def test_train_refuses_a_batch_that_does_not_divide(tmp_path):
    """``training.batch_size`` 5 over two ranks: every rank raises the JAX
    message (``test_mesh_train.py:43``) and the launch fails."""
    path = _config(tmp_path, **{"training.batch_size": 5})
    with pytest.raises(RuntimeError, match="divide evenly"):
        launch(train_rank, TWO_CPU_RANKS, (path, "none", "cpu"))


def test_remat_and_host_feed_on_two_ranks_equal_the_resident_run(dp_runs):
    """``training.remat: true`` with both splits fed from the host
    (``max_device_dataset_mb: 0``, each rank staging its rows only) trains
    what the device-fed run without remat trains (``test_mesh_train.py:
    57``): the same METRICS lines (within 1e-6 relative) and final
    parameters (1e-6 relative, atol 1e-7: remat recomputes the same
    forward).  Rank 0 alone writes: the other rank's checkpoint count is
    0, and each line is in the log once."""
    paths = dp_runs["paths"]
    for name in ("plain", "remat_host", "resume", "resume2"):
        ranks = dp_runs["trains"][name]
        assert ranks[0]["checkpoint_writes"] > 0, name
        assert ranks[1]["checkpoint_writes"] == 0, name
    a, b = _log(paths["plain"]), _log(paths["remat_host"])
    assert [(m["phase"], m["step"]) for m in a] == \
        [(m["phase"], m["step"]) for m in b]
    assert len(a) == len({(m["phase"], m["step"]) for m in a})
    for x, y in zip(a, b):
        for key, value in x.items():
            if key.endswith(("_seconds", "_mono", "_per_sec")) or \
                    not isinstance(value, float):
                continue
            assert y[key] == pytest.approx(value, rel=1e-6, abs=1e-9), key
    got, want = _latest_state(paths["remat_host"]), _latest_state(
        paths["plain"])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_two_ranks_on_the_dispatcher_thread_train_the_eager_run_bitwise(
        dp_runs):
    """The path of one of several NCCL ranks on two gloo CPU ranks
    (``torch_port_dp_ranks.host_launched``: a stand-in graph whose launch
    runs the step, its collectives inside; the validation pass's
    all-gather in its job), every launch on each rank's dispatcher thread
    and none on the training thread: every METRICS line but the wall
    times, the final parameters of both ranks and ``latest`` bitwise the
    eager run's of the same config (``plain``), epoch rotation on."""
    paths, trains = dp_runs["paths"], dp_runs["trains"]
    assert [r["launch_threads"] for r in trains["host_launched"]] == \
        [["betavae-dispatch"]] * 2
    assert [r["launch_threads"] for r in trains["plain"]] == [[], []]
    assert {r["checksum"] for r in trains["host_launched"]} == \
        {r["checksum"] for r in trains["plain"]}

    def numbers(path) -> list:
        return [{k: v for k, v in m.items()
                 if not k.endswith(("_seconds", "_mono", "_per_sec"))}
                for m in _log(path)]

    assert numbers(paths["host_launched"]) == numbers(paths["plain"])
    assert any(m.get("rotated") for m in _log(paths["host_launched"]))
    got, want = (_latest_state(paths["host_launched"]),
                 _latest_state(paths["plain"]))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.array_equal(got[key], value), key


def test_resume_on_two_ranks_equals_a_single_process_resume(dp_runs):
    """An epoch on two ranks, resumed on two ranks for a second epoch,
    against the single process resumed from a copy of the same checkpoint
    (``test_mesh_train.py:80``): final parameters at that test's bound
    (atol 2e-4).  The checkpoint the ranks wrote loads in the single
    process."""
    assert [r["epoch"] for r in dp_runs["trains"]["resume2"]] == [2, 2]
    epoch, single = dp_runs["single_resumed"]
    assert epoch == 2
    mesh_state = dp_runs["mesh_resumed"]
    assert set(mesh_state) == set(single)
    for key, value in single.items():
        np.testing.assert_allclose(mesh_state[key], value, atol=2e-4,
                                   err_msg=key)


def test_sigterm_to_a_data_parallel_launch_drains_rank_0s_writer(tmp_path):
    """SIGTERM to ``python -m betavae_tpu_torch.train --data-parallel 2
    --device cpu`` after a few epochs (the background writer on): the
    launcher passes it to the ranks and exits non-zero, rank 0 unwinds
    through its trainer and says how to resume, and its ``latest`` is
    whole (both shards from one epoch) and loads into the single-process
    model."""
    path = _config(tmp_path, **{
        "debug.epochs": 500, "debug.max_train_batches": 2,
        "debug.max_val_batches": 1, "training.async_checkpoint": True})
    log_path = tmp_path / "outputs" / "logs" / "run.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "betavae_tpu_torch.train", "--config", path,
         "--data-parallel", "2", "--device", "cpu"], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 240
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
        out, _ = proc.communicate(timeout=100)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode != 0
    assert out.count("[SHUTDOWN] interrupted") >= 1 and "--resume latest" in out
    base = tmp_path / "outputs" / "models" / "run_latest.pt"
    epochs = []
    for i in range(2):
        with zipfile.ZipFile(str(base).replace(".pt", f"_shard{i}.pt")) as zf:
            epochs.append(json.loads(zf.read("__meta__.json"))["epoch"])
    assert epochs[0] == epochs[1] >= 2
    payload = load_sharded_checkpoint(str(base))
    assert payload["epoch"] == epochs[0]
    reset_config_cache()
    try:
        model = model_from_config(get_config(path), device="cpu")
    finally:
        reset_config_cache()
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in payload["model_state"].items()})


def test_bench_data_parallel_prints_the_dp_line(capsys):
    """``--data-parallel 2 --device cpu``: one JSON line under the JAX
    bench's mesh metric name, with ``mesh_devices``."""
    line = bench.main(["--device", "cpu", "--image-size", "16",
                       "--batch-size", "4", "--data-parallel", "2"])
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line["metric"] == "train_images_per_sec_dp2_16px_bs4"
    assert line["mesh_devices"] == 2 and line["backend"] == "gloo"
    assert math.isfinite(line["value"]) and line["value"] > 0


def test_dryrun_on_two_ranks(capsys):
    """The dry run's command line on two CPU ranks (the flagship at 16 px):
    replicas bitwise equal, the loss within 2e-3 of the single process's."""
    line = dryrun_module.main(["2", "--device", "cpu", "--image-size", "16"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        line
    assert line["replicas_bitwise_equal"] and line["loss_rel"] < 2e-3
    assert line["global_batch"] == 4 and line["devices"] == TWO_CPU_RANKS


@pytest.mark.parametrize("step_ms,params,n,gbps", [
    (25.0, 9_500_000, 8, 450.0), (7.6, 5_100_000, 8, 200.0),
    (3.0, 23_000_000, 4, 50.0), (10.0, 1000, 1, 100.0)])
def test_data_parallel_scaling_matches_jax(step_ms, params, n, gbps):
    """The port's analytic model is the JAX package's at the same link
    rate (``link_gb_per_s`` there is ``ici_gb_per_s`` here)."""
    assert data_parallel_scaling(step_ms, params, n, link_gb_per_s=gbps) == \
        jax_scaling(step_ms, params, n, ici_gb_per_s=gbps)
