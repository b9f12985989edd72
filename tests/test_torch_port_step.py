"""The port's training step and its parts against the JAX package, on CPU.

Schedules, augmentation ops fed the same draws, the optax clip and update
rules, and three fp32 steps of the whole step (augmentation off; also with
LPIPS on) against JAX ``make_train_step`` with the same weights, batches,
LPIPS parameters and noise: ε is the
JAX step's own, ``jax.random.normal(rkey, (B, L))`` after
``akey, rkey = jax.random.split(key)``.  Each test states its tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from betavae_tpu.config import Frozen as JaxFrozen
from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.data.augment import (random_brightness, random_hflip,
                                      rotate_exact)
from betavae_tpu.io.checkpoint import flatten_pytree
from betavae_tpu.models.beta_vae import model_from_config as jax_model_from
from betavae_tpu.models.losses import loss_spec_from_config as jax_spec_from
from betavae_tpu.ops.lpips import _load_or_init_params
from betavae_tpu.ops.lpips import build_lpips_fn as jax_build_lpips_fn
from betavae_tpu.train import schedules as jax_sched
from betavae_tpu.train.loop import init_state, make_train_step as jax_step
from betavae_tpu.train.optim import build_optimizer as jax_build_optimizer

from betavae_tpu_torch.config import Frozen, get_config, reset_config_cache
from betavae_tpu_torch.data import augment
from betavae_tpu_torch.data.pipeline import gather_batch
from betavae_tpu_torch.io.weights import params_from_jax
from betavae_tpu_torch.models.beta_vae import model_from_config
from betavae_tpu_torch.models.losses import loss_spec_from_config
from betavae_tpu_torch.ops.elbo import reparam_kl_reference
from betavae_tpu_torch.ops.lpips import build_lpips_fn
from betavae_tpu_torch.train import schedules, step as step_module
from betavae_tpu_torch.train.optim import (build_optimizer,
                                           clip_by_global_norm_)
from betavae_tpu_torch.train.step import make_train_step


@pytest.fixture(autouse=True)
def _fresh_port_config():
    reset_config_cache()
    yield
    reset_config_cache()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


# --------------------------------------------------------------------------
# schedules: exact (the same float arithmetic)
# --------------------------------------------------------------------------

BETA_CFGS = [
    {"beta_schedule": {"type": "constant", "start_beta": 0.2, "end_beta": 0.9}},
    {"beta_schedule": {"type": "linear", "start": 0.1, "end": 1.0,
                       "warmup": 3}},
    {"beta_schedule": {"type": "cosine", "start_beta": 0.0, "end_beta": 2.0}},
    {"beta_schedule": {"type": "cyclical", "start_beta": 0.0,
                       "end_beta": 1.0, "cycle_length": 4}},
    {"model": {"beta": 0.3}},
]
CAP_CFGS = [
    {"loss": {"capacity_schedule": {"enabled": True, "C_start": 30.0,
                                    "C_end": 128.0, "warmup_epochs": 5}}},
    {"loss": {"capacity_schedule": {"enabled": False}}},
    {"loss": {}},
]


@pytest.mark.parametrize("cfg", BETA_CFGS + CAP_CFGS)
def test_schedules_match_jax(cfg):
    for total in (1, 10):
        ours = (schedules.BetaSchedule(cfg, total),
                schedules.CapacitySchedule(cfg, total))
        theirs = (jax_sched.BetaSchedule(cfg, total),
                  jax_sched.CapacitySchedule(cfg, total))
        for epoch in range(-1, 14):
            for a, b in zip(ours, theirs):
                assert a.value(epoch) == b.value(epoch)


@pytest.mark.parametrize("scheduler", ["cosine", "step", "none"])
def test_lr_and_total_epochs_match_jax(scheduler):
    for epoch in range(1, 12):
        for s in (0, 29, 30, 61):
            kw = dict(base_lr=5e-4, scheduler=scheduler, total_epochs=10)
            assert schedules.lr_at(epoch, s, **kw) == jax_sched.lr_at(
                epoch, s, **kw)
    for enabled in (True, False):
        raw = {"debug": {"enabled": enabled, "epochs": 3},
               "training": {"epochs": 100}}
        assert schedules.resolve_total_epochs(Frozen(raw)) == \
            jax_sched.resolve_total_epochs(JaxFrozen(raw))


# --------------------------------------------------------------------------
# augmentation with the JAX ops' own draws
# --------------------------------------------------------------------------

def _images(seed, b=4, h=12, w=10):
    return np.random.default_rng(seed).uniform(size=(b, h, w, 1)).astype(
        np.float32)


def test_flip_matches_jax_with_same_draws():
    x = _images(0, b=8)
    key = jax.random.PRNGKey(3)
    want = np.asarray(random_hflip(key, jnp.asarray(x)))
    flip = np.asarray(jax.random.bernoulli(key, 0.5, shape=(8,)))
    assert 0 < flip.sum() < 8
    got = augment.hflip(_nchw(x), torch.from_numpy(flip.copy()))
    np.testing.assert_array_equal(_nhwc(got), want)


def test_brightness_matches_jax_with_same_draws():
    x = _images(1)
    key = jax.random.PRNGKey(4)
    want = np.asarray(random_brightness(key, jnp.asarray(x), 0.4))
    factors = np.array(jax.random.uniform(key, (4,), minval=0.6, maxval=1.4))
    got = augment.brightness(_nchw(x), torch.from_numpy(factors))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-7)


def test_rotation_matches_rotate_exact():
    """Same angles, bilinear with zero fill about (H-1)/2; 1e-5 absolute
    (grid_sample's coordinate normalisation rounds in fp32)."""
    x = _images(2)
    angles = np.radians([-10.0, -3.5, 4.0, 10.0]).astype(np.float32)
    want = np.stack([np.asarray(rotate_exact(jnp.asarray(img), a))
                     for img, a in zip(x, angles)])
    got = augment.rotate(_nchw(x), torch.from_numpy(angles))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)


def test_augment_batch_is_flip_then_rotate_then_brightness():
    x = _nchw(_images(3))
    got = augment.augment_batch(x, torch.Generator().manual_seed(9),
                                use_flip=True, degrees=10.0,
                                brightness_range=0.1)
    g = torch.Generator().manual_seed(9)
    flip = torch.rand(4, generator=g) < 0.5
    rad = math.radians(10.0)
    angles = -rad + 2 * rad * torch.rand(4, generator=g)
    factors = 0.9 + 0.2 * torch.rand(4, generator=g)
    want = augment.brightness(augment.rotate(augment.hflip(x, flip), angles),
                              factors)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    off = augment.augment_batch(x, g, use_flip=False, degrees=0.0,
                                brightness_range=0.0)
    assert torch.equal(off, x)


# --------------------------------------------------------------------------
# optimizer chain
# --------------------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


@pytest.mark.parametrize("scale", [3.0, 0.05])
def test_clip_matches_optax(scale):
    """Above the clip every grad scales by clip/norm; below it none moves
    (1e-6 relative)."""
    g = {k: v * scale for k, v in _grads(0).items()}
    want, _ = optax.clip_by_global_norm(1.5).update(
        {k: jnp.asarray(v) for k, v in g.items()}, None)
    tensors = [torch.from_numpy(g["a"].copy()), torch.from_numpy(g["b"].copy())]
    norm = clip_by_global_norm_(tensors, 1.5)
    assert float(norm) == pytest.approx(
        math.sqrt(sum(float((v ** 2).sum()) for v in g.values())), rel=1e-6)
    np.testing.assert_allclose(tensors[0].numpy(), want["a"], rtol=1e-6)
    np.testing.assert_allclose(tensors[1].numpy(), want["b"], rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_update_rules_match_optax(optimizer):
    """Three updates with weight decay and an lr changed per step: coupled
    L2 (adam), decoupled decay (adamw), momentum 0.9 (sgd); 1e-5 relative."""
    raw = {"optimization": {"optimizer": optimizer, "lr": 1e-2,
                            "weight_decay": 0.1},
           "training": {"grad_clip": 2.0}}
    params = _grads(10)
    tx = jax_build_optimizer(JaxFrozen(raw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    chain = build_optimizer([tp["a"], tp["b"]], Frozen(raw))
    for i, lr in enumerate((1e-2, 5e-3, 2e-3)):
        g = _grads(20 + i)
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        chain.step(lr)
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# the whole step
# --------------------------------------------------------------------------

STEPS, B, N = 3, 4, 12


@pytest.mark.parametrize("norm,lpips", [
    pytest.param("layer", False, id="layer"),
    pytest.param("batch", False, id="batch"),
    pytest.param("layer", True, id="layer-lpips")])
def test_three_steps_match_jax_make_train_step(norm, lpips, demo_config_factory,
                                               monkeypatch, tmp_path):
    """Params, BN statistics and every step metric after three fp32 steps
    (capacity objective, FFL on, a padded last batch; with ``lpips``, the
    LPIPS term at weight 20 as in the debug config, both sides loading one
    ``.npz`` of the JAX module's parameters, at 32 px, the least size
    AlexNet's pools take).  Tolerance: metrics 1e-4 relative; params 1e-4
    relative plus 2e-6 absolute, since Adam's first steps move each weight
    by about lr·sign(g), so the rare weight whose gradient is near zero
    carries the fp32 reassociation noise of the two frameworks'
    convolutions."""
    size = 32 if lpips else 16
    path = demo_config_factory(
        image_size=size, latent_dim=6, base_channels=4, num_blocks=2,
        batch_size=B, **{"model.encoder_norm": norm,
                         "model.se_reduction_ratio": 2,
                         "loss.use_ffl": True, "loss.ffl_weight": 0.5,
                         "loss.use_lpips": lpips, "loss.lpips_weight": 20.0,
                         "optimization.lr": 1e-3})
    jax_lpips = port_lpips = None
    if lpips:
        npz = str(tmp_path / "lpips.npz")
        np.savez(npz, **flatten_pytree(_load_or_init_params(None)[1]))
        jax_lpips = jax_build_lpips_fn(npz)
        port_lpips = build_lpips_fn(npz, device="cpu")
    jcfg = jax_get_config(path)
    jmodel = jax_model_from(jcfg)
    tx = jax_build_optimizer(jcfg)
    state = init_state(jmodel, tx, jax.random.PRNGKey(0))
    aug_off = {"use_flip": False, "degrees": 0.0, "brightness": 0.0}
    jstep = jax_step(jmodel, tx, jax_spec_from(jcfg), aug_kwargs=aug_off,
                     use_capacity=True, lpips_fn=jax_lpips,
                     has_bn=norm == "batch", donate=False)

    cfg = get_config(path)
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(params_from_jax(flatten_pytree(
        state.model_variables())), strict=True)
    pstep = make_train_step(
        model, build_optimizer(model.parameters(), cfg),
        loss_spec_from_config(cfg),
        aug_kwargs={"use_flip": False, "degrees": 0.0, "brightness_range": 0.0},
        use_capacity=True, seed=0, lpips_fn=port_lpips)

    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (N, size, size, 1), dtype=np.uint8)
    root = jax.random.PRNGKey(5)
    eps = {}
    for j in range(1, STEPS + 1):
        _, rkey = jax.random.split(jax.random.fold_in(root, j))
        eps[j] = np.array(jax.random.normal(rkey, (B, 6)))
    monkeypatch.setattr(
        step_module, "fused_reparam_kl",
        lambda mu, logvar, seed, offset, start=0: reparam_kl_reference(
            mu, logvar, torch.from_numpy(eps[offset])))

    for j in range(1, STEPS + 1):
        idx = rng.permutation(N)[:B].astype(np.int32)
        mask = np.array([1, 1, 1, 0 if j == STEPS else 1], np.float32)
        sched = {"beta": 1.0, "capacity": 5.0 * j, "capacity_weight": 1.0,
                 "free_bits": 0.0, "lr": 1e-3 / j}
        state, want = jstep(state, jnp.asarray(images), jnp.asarray(idx),
                            jnp.asarray(mask), jax.random.fold_in(root, j),
                            {k: jnp.float32(v) for k, v in sched.items()})
        got = pstep(torch.from_numpy(images), torch.from_numpy(idx).long(),
                    torch.from_numpy(mask), sched, j,
                    step_module.draw_step_augment(
                        torch.Generator(), 0, j, B,
                        {"use_flip": False, "degrees": 0.0,
                         "brightness_range": 0.0}))
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4,
                                                  abs=1e-6), (j, k)
        assert (float(got["recon_lpips"]) > 0) == lpips

    final = params_from_jax(flatten_pytree(state.model_variables()))
    ours = model.state_dict()
    for k, v in final.items():
        if k.endswith("num_batches_tracked"):
            continue
        if norm == "batch" and k.endswith(("conv.bias", "up.1.bias",
                                           "running_mean")):
            # a conv bias right before train-mode BatchNorm has a gradient
            # of exactly zero in exact arithmetic: both frameworks feed
            # Adam rounding noise, which it scales to steps of up to lr, so
            # only that bound holds, and the running mean (which sees the
            # bias with weight 1 - 0.99 per step) inherits it
            bound = 2 * sum(1e-3 / j for j in range(1, STEPS + 1))
            if k.endswith("running_mean"):
                bound = 0.01 * STEPS * bound + 1e-6
            assert float((ours[k] - v).abs().max()) <= bound, k
            continue
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=2e-6, err_msg=k)


# --------------------------------------------------------------------------
# the captured step's form: a slot's tensors and pre-drawn augmentation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [True, False], ids=["capacity", "beta"])
def test_slot_step_with_predrawn_augmentation_is_the_step_bitwise(
        capacity, demo_config_factory):
    """The step as a captured chunk calls it (the schedule as 0-d fp32
    tensors, the step index as a 0-d int64 tensor) against the step called
    with floats and an int, on two copies of one model over four steps
    (flip, 10° rotation, brightness; FFL; free bits in beta mode): every
    metric, parameter, buffer and moment bitwise.  The augmentation's
    uniforms, drawn ahead by ``draw_step_augment``, applied to the step's
    batch give bitwise ``augment_batch`` with a generator seeded from
    ``(seed, step)``, the step's augmentation when it drew its own."""
    path = demo_config_factory(
        image_size=16, latent_dim=6, base_channels=4, num_blocks=2,
        batch_size=B, **{"loss.use_ffl": True, "loss.ffl_weight": 0.5,
                         "loss.free_bits": 0.05, "optimization.lr": 1e-3})
    cfg = get_config(path)
    aug = {"use_flip": True, "degrees": 10.0, "brightness_range": 0.2}
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        model = model_from_config(cfg, device="cpu")
        opt = build_optimizer(model.parameters(), cfg)
        runs.append((model, opt, make_train_step(
            model, opt, loss_spec_from_config(cfg), aug_kwargs=aug,
            use_capacity=capacity, seed=3)))
    runs[1][0].load_state_dict(runs[0][0].state_dict())
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.integers(0, 256, (N, 16, 16, 1),
                                           dtype=np.uint8))
    gen = torch.Generator()
    for j in range(1, 5):
        idx = torch.from_numpy(rng.permutation(N)[:B]).long()
        mask = torch.tensor([1.0, 1.0, 1.0, 0.0 if j == 4 else 1.0])
        sched = {"beta": 0.3 * j, "capacity": 2.5 * j,
                 "capacity_weight": 1.5, "free_bits": 0.05,
                 "lr": 1e-3 / j}
        draws = step_module.draw_step_augment(gen, 3, j, B, aug)
        x = gather_batch(images, idx)
        seeded = torch.Generator().manual_seed(step_module.augment_seed(3, j))
        assert torch.equal(augment.apply_augment(x, draws, **aug),
                           augment.augment_batch(x, seeded, **aug))
        want = runs[0][2](images, idx, mask, sched, j, draws.clone())
        got = runs[1][2](images, idx, mask,
                         {k: torch.tensor(v, dtype=torch.float32)
                          for k, v in sched.items()},
                         torch.tensor(j, dtype=torch.int64), draws=draws)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (j, k)
    for a, b in zip(runs[0][0].state_dict().values(),
                    runs[1][0].state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][1].state_tensors(), runs[1][1].state_tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no-decay", "decay"])
@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_device_update_matches_optax_over_five_steps(optimizer, wd):
    """Five updates with the learning rate a 0-d tensor and changed each
    step, after the clip: the parameters, and for adam/adamw the moments
    and the step count that sets both bias corrections (1 − 0.9ᵗ,
    1 − 0.999ᵗ), against optax's state; 1e-5 relative (atol 1e-7), the
    update test's tolerance above.  The count is one tensor that every
    parameter's ``step`` shares."""
    raw = {"optimization": {"optimizer": optimizer, "lr": 1e-2,
                            "weight_decay": wd},
           "training": {"grad_clip": 2.0}}
    params = _grads(11)
    tx = jax_build_optimizer(JaxFrozen(raw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    chain = build_optimizer([tp["a"], tp["b"]], Frozen(raw))
    for i, lr in enumerate((1e-2, 7e-3, 5e-3, 2e-3, 1e-3)):
        g = _grads(30 + i)
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        chain.step(torch.tensor(lr, dtype=torch.float32))
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)
    if optimizer == "sgd":
        return
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)  # noqa: E731
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.inner_state, is_leaf=is_adam) if is_adam(s))
    assert int(adam.count) == 5
    st = chain.optimizer.state
    assert all(st[p]["step"] is st[tp["a"]]["step"] for p in tp.values())
    assert float(st[tp["a"]]["step"]) == 5.0
    for k, p in tp.items():
        np.testing.assert_allclose(st[p]["exp_avg"].numpy(),
                                   np.asarray(adam.mu[k]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(st[p]["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[k]), rtol=1e-5,
                                   atol=1e-9)
