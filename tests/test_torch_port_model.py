"""The port's model against the JAX package's, fp32 on the CPU.

Weights are made from a seed with numpy in the JAX package's flat layout,
mapped with ``params_from_jax`` and loaded ``strict=True``; inputs are
numpy too.  Forward outputs (μ, logσ², recon) must agree to 1e-4 relative
(atol 1e-5): both sides are fp32 convolutions summed in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betavae_tpu.io.checkpoint import flatten_pytree, unflatten_like
from betavae_tpu.io.torch_compat import export_model_state
from betavae_tpu.models.beta_vae import BetaVAE
from betavae_tpu.models.beta_vae import BetaVAEModule as JaxBetaVAEModule
from betavae_tpu.ops.upsample import bilinear_upsample_x2 as jax_upsample

from betavae_tpu_torch.io.weights import params_from_jax
from betavae_tpu_torch.models.beta_vae import BetaVAEModule
from betavae_tpu_torch.ops.upsample import bilinear_upsample_x2

RTOL, ATOL = 1e-4, 1e-5
LATENT, BASE, RED = 6, 4, 2


def _random_flat(template: dict, seed: int) -> dict:
    """Every leaf of the JAX variables redrawn from a seed, so biases, norm
    affines and BN statistics all carry information through the mapping."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in template.items():
        a = rng.normal(0.0, 0.3, np.shape(v)).astype(np.float32)
        if k.endswith("/var") or k.endswith("/scale"):
            a = np.abs(a) + 0.5
        flat[k] = a
    return flat


def _pair(*, pooling="flatten", norm="layer", activation="relu", img=16,
          blocks=2, latent_clamp=None, logvar_clamp=(-10.0, 5.0), seed=0):
    kw = dict(image_size=img, in_channels=1, latent_dim=LATENT,
              base_channels=BASE, num_blocks=blocks, activation=activation,
              norm_type=norm, se_reduction=RED, encoder_pooling=pooling,
              logvar_clamp=logvar_clamp, latent_clamp=latent_clamp)
    jax_model = BetaVAE(module=JaxBetaVAEModule(**kw))
    template = jax_model.variables_template()   # shapes only, no compile
    flat = _random_flat(flatten_pytree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), template)), seed)
    variables = unflatten_like(template, flat)
    port = BetaVAEModule(**kw)
    port.load_state_dict(params_from_jax(flat), strict=True)
    port.eval()
    return jax_model, variables, flat, port


def _x(seed, n=3, img=16):
    return np.random.default_rng(seed).uniform(
        size=(n, img, img, 1)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.mark.parametrize("pooling,norm", [("flatten", "layer"),
                                          ("flatten", "batch"),
                                          ("gap", "layer"), ("gap", "batch")])
def test_params_from_jax_equals_export_model_state(pooling, norm):
    _, _, flat, _ = _pair(pooling=pooling, norm=norm)
    got = params_from_jax(flat)
    want = export_model_state(flat)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_params_from_jax_rejects_unconsumed_keys():
    _, _, flat, _ = _pair()
    flat["params/mystery/kernel"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_jax(flat)


@pytest.mark.parametrize("pooling,norm,activation,img,blocks", [
    ("flatten", "layer", "relu", 16, 2),
    ("flatten", "batch", "relu", 16, 2),
    ("gap", "layer", "relu", 16, 2),
    ("gap", "batch", "relu", 16, 2),
    ("flatten", "none", "elu", 16, 2),
    ("gap", "layer", "leakyrelu", 16, 2),
    # odd sides: 20 -> 10 -> 5 -> 3, bottleneck_hw is ceil(s/2) per block
    ("flatten", "layer", "relu", 20, 3),
])
def test_forward_matches_jax(pooling, norm, activation, img, blocks):
    jax_model, variables, _, port = _pair(pooling=pooling, norm=norm,
                                          activation=activation, img=img,
                                          blocks=blocks)
    assert port.bottleneck_hw == jax_model.module.bottleneck_hw
    x = _x(1, img=img)
    # eager apply: the primitives compile once per process, where a jitted
    # forward would compile the whole model again for every case
    recon, mu, logvar, _ = jax_model.module.apply(variables, jnp.asarray(x),
                                                  deterministic=True)
    with torch.no_grad():
        t_recon, t_mu, t_logvar, t_z = port(_nchw(x), deterministic=True)
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(mu), RTOL, ATOL)
    np.testing.assert_allclose(t_logvar.numpy(), np.asarray(logvar), RTOL,
                               ATOL)
    np.testing.assert_allclose(t_recon.numpy(),
                               np.transpose(np.asarray(recon), (0, 3, 1, 2)),
                               RTOL, ATOL)
    assert torch.equal(t_z, t_mu)


def test_clamps_match_jax():
    """The logvar clamp bites on encode and the latent clamp on decode."""
    jax_model, variables, _, port = _pair(latent_clamp=0.5,
                                          logvar_clamp=(-0.2, 0.2))
    x = _x(2)
    module = jax_model.module
    _, logvar = module.apply(variables, jnp.asarray(x), method=module.encode)
    z = (3.0 * np.random.default_rng(3).normal(size=(3, LATENT))).astype(
        np.float32)
    recon = module.apply(variables, jnp.asarray(z), method=module.decode)
    with torch.no_grad():
        _, t_logvar = port.encode(_nchw(x))
        t_recon = port.decode(torch.from_numpy(z))
    assert float(t_logvar.abs().max()) == pytest.approx(0.2)
    np.testing.assert_allclose(t_logvar.numpy(), np.asarray(logvar), RTOL,
                               ATOL)
    np.testing.assert_allclose(t_recon.numpy(),
                               np.transpose(np.asarray(recon), (0, 3, 1, 2)),
                               RTOL, ATOL)


def test_batchnorm_train_mode_matches_flax_update():
    """Train-mode BatchNorm: batch statistics normalise, and the running
    statistics move by flax's rule (momentum 0.99, biased variance)."""
    jax_model, variables, _, port = _pair(norm="batch")
    module = jax_model.module
    x = _x(4, n=5)
    (mu, _), upd = module.apply(variables, jnp.asarray(x), train=True,
                                method=module.encode, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        t_mu, _ = port.encode(_nchw(x))
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(mu), RTOL, ATOL)
    stats = flatten_pytree(upd["batch_stats"])
    for i in range(module.num_blocks):
        norm = port.encoder[i].norm
        np.testing.assert_allclose(norm.running_mean.numpy(),
                                   stats[f"enc_{i}/norm/bn/mean"], 1e-5, 1e-6)
        np.testing.assert_allclose(norm.running_var.numpy(),
                                   stats[f"enc_{i}/norm/bn/var"], 1e-5, 1e-6)


def test_groupnorm_eps_is_flax_eps():
    """On an input whose variance is near GroupNorm's eps, 1e-6 (flax) and
    torch's default 1e-5 give visibly different outputs."""
    import flax.linen as nn

    x = (1e-3 * np.random.default_rng(5).normal(size=(2, 4, 4, 3))).astype(
        np.float32)
    gn = nn.GroupNorm(num_groups=1)
    want = gn.apply(gn.init(jax.random.PRNGKey(0), x), x)
    port = BetaVAEModule(16, 1, LATENT, 3, 1).encoder[0].norm
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(),
                               np.transpose(np.asarray(want), (0, 3, 1, 2)),
                               1e-4, 1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 4, 4, 1)])
def test_upsample_matches_jax(shape):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = np.transpose(np.asarray(jax_upsample(jnp.asarray(x))), (0, 3, 1, 2))
    got = bilinear_upsample_x2(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_upsample_keeps_bf16_under_autocast():
    """Under bf16 autocast the upsample runs in its input's dtype, as the
    JAX decoder upsamples in its compute dtype (autocast alone would
    upcast it to fp32).  JAX rounds to bf16 between its row and column
    passes, torch once: within 2⁻⁷ relative plus 2⁻⁶ absolute, one bf16 ulp
    of the intermediates (|x| < 4)."""
    x = np.random.default_rng(7).normal(size=(2, 6, 5, 3)).astype(np.float32)
    want = jax_upsample(jnp.asarray(x, jnp.bfloat16))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = bilinear_upsample_x2(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.transpose(np.asarray(want, np.float32), (0, 3, 1, 2)),
        rtol=2**-7, atol=2**-6)


def test_flagship_geometry_loads_jax_shapes(tmp_path):
    """The flagship config's JAX parameter shapes load strictly into the
    port's model built from the same config (no compile: eval_shape)."""
    from betavae_tpu.config import get_config as jax_get_config
    from betavae_tpu.models.beta_vae import model_from_config as jax_model_from

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.models.beta_vae import model_from_config

    reset_config_cache()
    try:
        cfg = get_config("configs/beta_vae_se.yaml")
        port = model_from_config(cfg, device="cpu")
    finally:
        reset_config_cache()
    template = jax_model_from(jax_get_config("configs/beta_vae_se.yaml"))
    shapes = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    template.variables_template())
    port.load_state_dict(params_from_jax(flatten_pytree(shapes)), strict=True)
    assert port.flat_dim == 512 * 8 * 8
    assert port.mixed_precision


@pytest.mark.parametrize("value,fused", [(True, True), ("true", True),
                                         ("auto", False), (False, False)])
def test_fused_head_builds_and_runs_and_auto_is_off(tmp_path, value, fused):
    """``training.fused_head: true`` builds the fused head and runs it;
    ``auto`` resolves to off (the port has no environment switch); the
    parameters keep ``final_conv``'s names either way."""
    import yaml

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.models.beta_vae import model_from_config

    cfg = yaml.safe_load(open("configs/beta_vae_se_debug.yaml"))
    cfg["data"]["image_size"] = 16
    cfg["model"].update(base_channels=4, num_blocks=2, latent_dim=4)
    cfg["training"]["fused_head"] = value
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    reset_config_cache()
    try:
        model = model_from_config(get_config(str(path)), device="cpu")
    finally:
        reset_config_cache()
    assert model.fused_head is fused
    assert {"final_conv.weight", "final_conv.bias"} <= set(model.state_dict())
    x = torch.rand(2, 1, 16, 16, generator=torch.Generator().manual_seed(0))
    recon, *_ = model(x, deterministic=True)
    assert recon.shape == x.shape and bool(torch.isfinite(recon).all())


def test_fused_head_rejects_unknown_values():
    from betavae_tpu_torch.models.beta_vae import resolve_fused_head

    assert resolve_fused_head(None) is False
    with pytest.raises(ValueError, match="fused_head"):
        resolve_fused_head("sometimes")
