"""Checkpoints across the two packages, and the port's checkpoint format.

A checkpoint written by the port loads through the JAX package's
``load_sharded_checkpoint`` (its torch-payload conversion gives the flax
params and Adam moments), and one written by the JAX package's
``CheckpointManager`` resumes in the port with the same params and Adam
state.  Both directions are checked against the JAX package's own
converters (``export_model_state``, ``export_adam_optim_state``), exactly:
the mappings only transpose and permute.
"""

import os

import jax
import numpy as np
import pytest
import torch

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.io.checkpoint import (flatten_pytree,
                                       load_sharded_checkpoint as jax_load)
from betavae_tpu.io.torch_compat import (export_adam_optim_state,
                                         export_model_state)
from betavae_tpu.models.beta_vae import model_from_config as jax_model_from
from betavae_tpu.train.callbacks import CheckpointManager as JaxManager
from betavae_tpu.train.loop import init_state
from betavae_tpu.train.optim import build_optimizer as jax_build_optimizer
from betavae_tpu.train.optim import graft_adam_moments

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.io.checkpoint import (discover_shards,
                                             load_sharded_checkpoint,
                                             read_checkpoint_meta,
                                             save_sharded_checkpoint)
from betavae_tpu_torch.models.beta_vae import model_from_config
from betavae_tpu_torch.train.callbacks import (CheckpointManager,
                                               restore_training_state)
from betavae_tpu_torch.train.optim import build_optimizer

STEPS = 2


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


def test_jax_checkpoint_resumes_in_the_port(cfg_path):
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
    state = state.replace(params=params, opt_state=opt_state)
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
