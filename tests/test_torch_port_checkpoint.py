"""Checkpoints across the two packages, and the port's checkpoint format.

A checkpoint written by the port loads through the JAX package's
``load_sharded_checkpoint`` (its torch-payload conversion gives the flax
params and Adam moments), and one written by the JAX package's
``CheckpointManager`` resumes in the port with the same params and Adam
state.  Both directions are checked against the JAX package's own
converters (``export_model_state``, ``export_adam_optim_state``), exactly:
the mappings only transpose and permute.  The reference's torch-pickle
shards, as the JAX package's ``save_torch_reference_checkpoint`` writes
them, resume in the port with their Adam moments; the port's exporter
writes shards the JAX package reads back exactly, under the reference's
module names; an optimizer state that does not fit warns and starts fresh;
and a pickle that ``torch.load(weights_only=True)`` refuses is never
loaded.
"""

import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.io.checkpoint import (flatten_pytree,
                                       load_sharded_checkpoint as jax_load)
from betavae_tpu.io.torch_compat import (export_adam_optim_state,
                                         export_model_state)
from betavae_tpu.io.torch_compat import \
    save_torch_reference_checkpoint as jax_save_reference
from betavae_tpu.models.beta_vae import model_from_config as jax_model_from
from betavae_tpu.train.callbacks import CheckpointManager as JaxManager
from betavae_tpu.train.loop import init_state
from betavae_tpu.train.optim import build_optimizer as jax_build_optimizer
from betavae_tpu.train.optim import graft_adam_moments

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.io import export_torch_checkpoint
from betavae_tpu_torch.io.checkpoint import (discover_shards,
                                             load_sharded_checkpoint,
                                             read_checkpoint_meta,
                                             save_sharded_checkpoint,
                                             save_torch_reference_checkpoint)
from betavae_tpu_torch.io.weights import params_from_jax
from betavae_tpu_torch.models.beta_vae import BetaVAEModule, model_from_config
from betavae_tpu_torch.train.callbacks import (CheckpointManager,
                                               restore_training_state)
from betavae_tpu_torch.train.optim import build_optimizer

STEPS = 2
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
SCRIPTS_DIR = os.path.join(os.path.dirname(TESTS_DIR), "scripts")


@pytest.fixture(autouse=True)
def _fresh_port_config():
    reset_config_cache()
    yield
    reset_config_cache()


@pytest.fixture(params=["layer", "batch"])
def cfg_path(request, demo_config_factory):
    return demo_config_factory(image_size=16, latent_dim=4, base_channels=4,
                               **{"model.encoder_norm": request.param,
                                  "model.se_reduction_ratio": 2})


def _port_trained(path):
    """The port's model and Adam after STEPS updates with seeded gradients."""
    cfg = get_config(path)
    model = model_from_config(cfg, device="cpu")
    opt = build_optimizer(model.parameters(), cfg)
    g = torch.Generator().manual_seed(3)
    for _ in range(STEPS):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step(1e-3)
    for name, buf in model.named_buffers():
        if buf.is_floating_point():   # BN statistics carry information too
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model, opt


def test_port_checkpoint_loads_in_the_jax_package(cfg_path):
    model, opt = _port_trained(cfg_path)
    paths = CheckpointManager().save_latest(model, opt, 1, STEPS,
                                            {"val_total": 1.5})
    assert len(paths) == 2

    payload = jax_load(os.path.join(get_config().paths.models_dir,
                                    "testrun_latest.pt"))
    assert (payload["epoch"], payload["total_steps"]) == (1, STEPS)
    assert payload["val_total"] == 1.5
    ours = model.state_dict()
    back = export_model_state(payload["model_state"])   # flax → torch names
    for name, arr in back.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(arr, ours[name].numpy(), name)

    moments = payload["torch_adam_moments"]             # convert_adam_moments
    assert moments is not None and moments["count"] == STEPS
    state = opt.optimizer.state_dict()["state"]
    names = [n for n, _ in model.named_parameters()]
    for field, tree in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        swapped = dict(payload["model_state"])
        swapped.update({f"params/{k}": v for k, v in moments[tree].items()})
        got = export_model_state(swapped)
        for i, name in enumerate(names):
            np.testing.assert_array_equal(got[name],
                                          state[i][field].numpy(), name)

    # and the JAX trainer's resume grafts them onto its optax state
    jcfg = jax_get_config(cfg_path)
    tx = jax_build_optimizer(jcfg)
    fresh = init_state(jax_model_from(jcfg), tx, jax.random.PRNGKey(0))
    grafted = flatten_pytree(graft_adam_moments(fresh.opt_state, moments))
    assert int(grafted["inner_state/1/count"]) == STEPS


def _jax_trained(cfg_path):
    """A JAX train state after STEPS Adam updates with seeded gradients."""
    jcfg = jax_get_config(cfg_path)
    tx = jax_build_optimizer(jcfg)
    state = init_state(jax_model_from(jcfg), tx, jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    params = state.params
    opt_state = state.opt_state
    for _ in range(STEPS):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    return state.replace(params=params, opt_state=opt_state)


def test_jax_checkpoint_resumes_in_the_port(cfg_path):
    state = _jax_trained(cfg_path)
    JaxManager(num_shards=2).save_latest(state, 3, STEPS, {"val_total": 2.0})

    cfg = get_config(cfg_path)
    model = model_from_config(cfg, device="cpu")
    opt = build_optimizer(model.parameters(), cfg)
    payload = load_sharded_checkpoint(os.path.join(cfg.paths.models_dir,
                                                   "testrun_latest.pt"))
    assert (payload["epoch"], payload["total_steps"]) == (3, STEPS)
    restore_training_state(payload, model, opt)

    model_flat = flatten_pytree(state.model_variables())
    want = export_model_state(model_flat)
    ours = model.state_dict()
    assert set(ours) == set(want)
    for name, arr in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(ours[name].numpy(), arr, name)
    want_opt = export_adam_optim_state(flatten_pytree(state.opt_state),
                                       model_flat, lr=1e-3)["state"]
    got_opt = opt.optimizer.state_dict()["state"]
    assert set(got_opt) == set(want_opt)
    for i, fields in want_opt.items():
        assert float(got_opt[i]["step"]) == float(fields["step"]) == STEPS
        for field in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got_opt[i][field], fields[field],
                                       rtol=0, atol=0)


def _payload(epoch=1, moments=None):
    rng = np.random.default_rng(epoch)
    out = {"epoch": epoch, "total_steps": 10 * epoch, "val_total": 0.5,
           "model_state": {f"w{i}": rng.normal(size=(3, i + 1))
                           for i in range(5)},
           "optim_state": {f"{i}/exp_avg": rng.normal(size=2)
                           for i in range(3)}}
    if moments is not None:
        out["torch_adam_moments"] = moments
    return out


def test_a_bracketed_run_id_saves_cleans_stale_shards_and_reloads(tmp_path):
    base = str(tmp_path / "run[1]*_latest.pt")
    save_sharded_checkpoint(base, _payload(epoch=1), num_shards=4)
    assert len(discover_shards(base)) == 4
    # a decoy that an unescaped glob would match, and must not touch
    decoy = tmp_path / "run1x_latest_shard0.pt"
    decoy.write_bytes(b"not ours")
    save_sharded_checkpoint(base, _payload(epoch=2), num_shards=2)
    assert [os.path.basename(p) for p in discover_shards(base)] == [
        "run[1]*_latest_shard0.pt", "run[1]*_latest_shard1.pt"]
    assert decoy.exists()
    got = load_sharded_checkpoint(base)
    want = _payload(epoch=2)
    assert got["epoch"] == 2 and got["total_steps"] == 20
    for sec in ("model_state", "optim_state"):
        assert set(got[sec]) == set(want[sec])
        for k in want[sec]:
            np.testing.assert_array_equal(got[sec][k], want[sec][k])


@pytest.mark.parametrize("moments", [None, {}, {"count": 7, "mu": {},
                                                "nu": {}}])
def test_no_moment_count_leaks_without_moments(tmp_path, moments):
    base = str(tmp_path / "m.pt")
    save_sharded_checkpoint(base, _payload(moments=moments))
    assert "torch_adam_moments_count" not in read_checkpoint_meta(base)
    got = load_sharded_checkpoint(base)
    assert "torch_adam_moments_count" not in got
    assert "torch_adam_moments" not in got


def test_moments_round_trip_with_their_count(tmp_path):
    base = str(tmp_path / "m.pt")
    moments = {"count": 7, "mu": {"a/b": np.ones(3)}, "nu": {"a/b": np.zeros(3)}}
    save_sharded_checkpoint(base, _payload(moments=moments))
    got = load_sharded_checkpoint(base)
    assert "torch_adam_moments_count" not in got
    assert got["torch_adam_moments"]["count"] == 7
    np.testing.assert_array_equal(got["torch_adam_moments"]["mu"]["a/b"],
                                  np.ones(3))
    # the JAX package reads the same section back
    assert jax_load(base)["torch_adam_moments"]["count"] == 7


def test_a_torn_or_corrupt_shard_set_is_refused(tmp_path):
    base = str(tmp_path / "t.pt")
    save_sharded_checkpoint(base, _payload(epoch=1))
    keep = (tmp_path / "t_shard0.pt").read_bytes()
    save_sharded_checkpoint(base, _payload(epoch=2))
    (tmp_path / "t_shard0.pt").write_bytes(keep)
    with pytest.raises(ValueError, match="torn"):
        load_sharded_checkpoint(base)
    (tmp_path / "t_shard0.pt").write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="corrupt"):
        load_sharded_checkpoint(base)
    with pytest.raises(FileNotFoundError):
        load_sharded_checkpoint(str(tmp_path / "absent.pt"))


# ---------------------------------------------------------------------------
# the reference's torch-pickle checkpoints
# ---------------------------------------------------------------------------

def _torch_shards(base: str) -> dict:
    """The merged payload of a reference shard set, as ``torch.load`` (the
    reference's own loader) sees it: model states merged, the rest from
    shard 0."""
    shards = [torch.load(p, map_location="cpu", weights_only=True)
              for p in discover_shards(base)]
    merged = {k: v for k, v in shards[0].items() if k != "model_state"}
    merged["model_state"] = {k: v for sh in shards
                             for k, v in sh["model_state"].items()}
    return merged


def test_reference_shards_from_jax_resume_in_the_port(cfg_path):
    """Shards written by the JAX package's ``save_torch_reference_checkpoint``
    with ``export_adam_optim_state``'s Adam state: the port's weights equal
    ``params_from_jax`` of that state bitwise, and each Adam moment lands on
    the parameter of its index, with the one step count."""
    state = _jax_trained(cfg_path)
    model_flat = flatten_pytree(state.model_variables())
    optim = export_adam_optim_state(flatten_pytree(state.opt_state),
                                    model_flat, lr=1e-3)
    cfg = get_config(cfg_path)
    os.makedirs(cfg.paths.models_dir, exist_ok=True)
    base = os.path.join(cfg.paths.models_dir, "testrun_latest.pt")
    jax_save_reference(base, {"epoch": 3, "total_steps": STEPS,
                              "val_total": 2.0, "model_state": model_flat},
                       optim_state=optim)
    assert read_checkpoint_meta(base)["epoch"] == 3   # a torch pickle, whole

    model = model_from_config(cfg, device="cpu")
    opt = build_optimizer(model.parameters(), cfg)
    payload = load_sharded_checkpoint(base)
    assert (payload["epoch"], payload["total_steps"]) == (3, STEPS)
    restore_training_state(payload, model, opt)
    want = params_from_jax(model_flat)
    ours = model.state_dict()
    assert set(ours) == set(want)
    for name, value in want.items():
        assert torch.equal(ours[name], value.reshape(ours[name].shape)), name
    got_opt = opt.optimizer.state_dict()["state"]
    assert set(got_opt) == set(optim["state"])
    for i, fields in optim["state"].items():
        assert float(got_opt[i]["step"]) == STEPS
        for field in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got_opt[i][field], fields[field]), (i, field)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_port_export_reads_back_in_the_jax_package(cfg_path, source):
    """The port's exporter (``--include-optimizer``) on a checkpoint of
    either package: the JAX package's loader reads its shards back with the
    params exact, and the exported Adam state equals the JAX package's
    ``export_adam_optim_state`` of the same state, lr included (the JAX
    CLI's ``_lr_at_save``)."""
    cfg = get_config(cfg_path)
    models = cfg.paths.models_dir
    if source == "jax":
        state = _jax_trained(cfg_path)
        JaxManager(num_shards=2).save_latest(state, 3, STEPS,
                                             {"val_total": 2.0})
        model_flat = flatten_pytree(state.model_variables())
        want_opt = flatten_pytree(state.opt_state)
    else:
        model, opt = _port_trained(cfg_path)
        CheckpointManager().save_latest(model, opt, 3, STEPS,
                                        {"val_total": 2.0})
        model_flat = jax_load(os.path.join(models, "testrun_latest.pt"))[
            "model_state"]
        want_opt = None
    out = os.path.join(models, "exported", "ref_latest.pt")
    paths = export_torch_checkpoint.main(
        ["--config", cfg_path, "--checkpoint", "latest", "--output", out,
         "--include-optimizer"])
    assert paths == discover_shards(out) and len(paths) == 2

    back = jax_load(out)
    assert (back["epoch"], back["total_steps"]) == (3, STEPS)
    assert back["val_total"] == 2.0
    assert set(back["model_state"]) == set(model_flat)
    for key, value in model_flat.items():
        np.testing.assert_array_equal(back["model_state"][key], value, key)
    assert back["torch_adam_moments"]["count"] == STEPS

    sys.path.insert(0, SCRIPTS_DIR)
    try:
        from export_torch_checkpoint import _lr_at_save
    finally:
        sys.path.remove(SCRIPTS_DIR)
    lr = _lr_at_save(jax_get_config(cfg_path), 3, STEPS)
    assert export_torch_checkpoint.lr_at_save(cfg, 3, STEPS) == lr
    got = _torch_shards(out)
    assert got["exported_by"] == "betavae_tpu_torch"
    if want_opt is None:            # the port's: its moments through JAX
        want_opt = {f"{t}/{k}": v for t in ("mu", "nu")
                    for k, v in back["torch_adam_moments"][t].items()}
        want_opt["count"] = np.asarray(STEPS)
    want = export_adam_optim_state(want_opt, model_flat, lr=lr)
    assert got["optim_state"]["param_groups"] == want["param_groups"]
    assert set(got["optim_state"]["state"]) == set(want["state"])
    for i, fields in want["state"].items():
        for field, value in fields.items():
            assert torch.equal(got["optim_state"]["state"][i][field],
                               value), (i, field)


def test_exported_model_state_has_the_reference_names(tmp_path):
    """The export of the interop test's geometry (16 px, 2 blocks, base 4,
    latent 6, SE r=2, GroupNorm) holds exactly the names and shapes of the
    reference's ``state_dict()`` as ``tests/test_torch_interop.py`` builds
    it, and loads ``strict=True`` into the port's model."""
    sys.path.insert(0, TESTS_DIR)
    try:
        from test_torch_interop import _build_torch_state
    finally:
        sys.path.remove(TESTS_DIR)
    model = BetaVAEModule(image_size=16, in_channels=1, latent_dim=6,
                          base_channels=4, num_blocks=2, se_reduction=2)
    base = str(tmp_path / "ref.pt")
    save_torch_reference_checkpoint(base, {"epoch": 1, "model_state": {
        k: v.numpy() for k, v in model.state_dict().items()}})
    got = _torch_shards(base)["model_state"]
    want = _build_torch_state(np.random.default_rng(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    fresh = BetaVAEModule(image_size=16, in_channels=1, latent_dim=6,
                          base_channels=4, num_blocks=2, se_reduction=2)
    fresh.load_state_dict(got, strict=True)
    for name, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name


def test_reference_names_map_by_name_with_the_jax_exceptions(tmp_path):
    """A reference state with the decoder conv spelt ``up``, its loss
    modules' entries and BatchNorm counters: ``lpips_loss.*``/``ffl_loss.*``
    are dropped, ``up`` becomes ``up.1``, each ``num_batches_tracked`` is
    0, and every weight is the saved one."""
    model = BetaVAEModule(image_size=16, in_channels=1, latent_dim=6,
                          base_channels=4, num_blocks=2, se_reduction=2,
                          norm_type="batch")
    g = torch.Generator().manual_seed(0)
    saved = {k: (torch.full_like(v, 7) if k.endswith("num_batches_tracked")
                 else torch.randn(v.shape, generator=g))
             for k, v in model.state_dict().items()}
    ref = {k.replace(".up.1.", ".up."): v for k, v in saved.items()}
    ref["lpips_loss.net.0.weight"] = torch.ones(2)
    ref["ffl_loss.alpha"] = torch.ones(())
    torch.save({"model_state": ref, "epoch": 4}, tmp_path / "run_best.pt")
    payload = load_sharded_checkpoint(str(tmp_path / "run_best.pt"))
    assert payload["epoch"] == 4
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in payload["model_state"].items()},
                          strict=True)
    for name, value in saved.items():
        want = (torch.zeros_like(value) if name.endswith("num_batches_tracked")
                else value)
        assert torch.equal(model.state_dict()[name], want), name


def test_a_mismatched_optimizer_state_warns_and_starts_fresh(cfg_path):
    """One parameter's moments missing from the reference's Adam state: a
    warning, the weights loaded, and a fresh optimizer (the JAX package's
    ``convert_adam_moments`` bails the same way)."""
    model, opt = _port_trained(cfg_path)
    optim = opt.optimizer.state_dict()
    del optim["state"][len(optim["state"]) - 1]
    cfg = get_config()
    base = os.path.join(cfg.paths.models_dir, "testrun_latest.pt")
    save_torch_reference_checkpoint(base, {
        "epoch": 1, "total_steps": STEPS,
        "model_state": {k: v.numpy() for k, v in model.state_dict().items()}},
        optim_state=optim)
    fresh = model_from_config(cfg, device="cpu")
    fresh_opt = build_optimizer(fresh.parameters(), cfg)
    with pytest.warns(UserWarning, match="param count mismatch.*FRESH"):
        restore_training_state(load_sharded_checkpoint(base), fresh,
                               fresh_opt)
    assert fresh_opt.optimizer.state_dict()["state"] == {}
    for name, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name


LOADED = []


def _mark_loaded():
    LOADED.append(True)
    return {}


class _RunsCode:
    """Unpickling this runs ``_mark_loaded``: what a weights-only load must
    refuse to do."""

    def __reduce__(self):
        return (_mark_loaded, ())


def test_a_pickle_that_is_not_weights_only_raises_unloaded(tmp_path):
    path = tmp_path / "run_best.pt"
    torch.save({"model_state": {"fc_mu.weight": torch.ones(2)},
                "extra": _RunsCode()}, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="run_best.pt.*weights_only"):
            load_sharded_checkpoint(str(path))
    assert LOADED == []
