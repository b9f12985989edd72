"""The port's model against the JAX package's, fp32 on the CPU.

Weights are made from a seed with numpy in the JAX package's flat layout,
mapped with ``params_from_jax`` and loaded ``strict=True``; inputs are
numpy too.  Forward outputs (μ, logσ², recon) must agree to 1e-4 relative
(atol 1e-5): both sides are fp32 convolutions summed in different orders.
``training.remat`` (``false`` / ``decoder`` / ``true``) changes only when
activations are computed: bitwise the same loss, gradients and BatchNorm
statistics on the CPU, and each mode the JAX module's with the same remat.
"""

import math

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
from betavae_tpu_torch.ops.upsample import (_alignment, bilinear_upsample_x2,
                                            upsample2x_backward,
                                            upsample2x_backward_reference,
                                            upsample2x_forward,
                                            upsample2x_reference,
                                            upsample_path, vector_tiling)

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
          blocks=2, latent_clamp=None, logvar_clamp=(-10.0, 5.0), seed=0,
          remat=False, latent=LATENT, base=BASE, bf16=False,
          fused_head=False):
    """``(JAX model, its variables, the flat leaves, the port's module)``
    from one seed; ``bf16`` builds the JAX module in bf16 and the port's
    under bf16 autocast, ``fused_head`` the port's fused head (the JAX
    module keeps its XLA head: the same convolution of the gated y)."""
    kw = dict(image_size=img, in_channels=1, latent_dim=latent,
              base_channels=base, num_blocks=blocks, activation=activation,
              norm_type=norm, se_reduction=RED, encoder_pooling=pooling,
              logvar_clamp=logvar_clamp, latent_clamp=latent_clamp,
              remat=remat)
    jax_model = BetaVAE(module=JaxBetaVAEModule(
        **kw, dtype=jnp.bfloat16 if bf16 else jnp.float32))
    template = jax_model.variables_template()   # shapes only, no compile
    flat = _random_flat(flatten_pytree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), template)), seed)
    variables = unflatten_like(template, flat)
    port = BetaVAEModule(**kw, mixed_precision=bf16, fused_head=fused_head)
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


REMAT_MODES = (False, "decoder", True)


def _train_step_grads(port, x: np.ndarray):
    """Loss, gradients and buffers of one train-mode backward through
    encode → decode(μ) with every parameter reached (recon error plus μ²
    and logσ²)."""
    port.train()
    port.zero_grad(set_to_none=True)
    mu, logvar = port.encode(_nchw(x))
    recon = port.decode(mu)
    loss = ((recon - _nchw(x)) ** 2).sum() + mu.square().sum() \
        + logvar.square().sum()
    loss.backward()
    return (loss.detach(), {n: p.grad.clone() for n, p in
                            port.named_parameters()},
            {n: b.clone() for n, b in port.named_buffers()})


@pytest.mark.parametrize("norm", ["layer", "batch"])
@pytest.mark.parametrize("fused_head", [False, True])
def test_remat_modes_give_bitwise_equal_loss_grads_and_statistics(
        norm, fused_head):
    """Remat ``false`` / ``decoder`` / ``true`` give bitwise the same loss
    and gradients on the CPU (``tests/test_model.py:120``), the last
    decoder block's (activations, gates) pair leaving its checkpoint for
    the fused head; with BatchNorm, the running statistics and
    ``num_batches_tracked`` are the no-remat step's: one update a step,
    though a checkpointed block runs its forward again in the backward."""
    x = _x(3, n=4)
    runs = []
    for mode in REMAT_MODES:
        _, _, _, port = _pair(norm=norm, remat=mode, seed=2)
        port.fused_head = fused_head
        runs.append(_train_step_grads(port, x))
    loss0, grads0, bufs0 = runs[0]
    if norm == "batch":
        assert {int(v) for k, v in bufs0.items()
                if k.endswith("num_batches_tracked")} == {1}
    for loss, grads, bufs in runs[1:]:
        assert torch.equal(loss, loss0)
        for name, g in grads0.items():
            assert torch.equal(grads[name], g), name
        for name, b in bufs0.items():
            assert torch.equal(bufs[name], b), name


@pytest.mark.parametrize("mode", REMAT_MODES, ids=str)
def test_remat_matches_the_jax_module_with_the_same_remat(mode):
    """Each mode's loss and gradients against the JAX module built with the
    same ``remat`` (``nn.remat`` on the same blocks), at the forward
    tolerance: 1e-4 relative, and 1e-5 absolute scaled by max(1, the
    largest gradient of the tensor)."""
    jax_model, variables, _, port = _pair(remat=mode, seed=4)
    module = jax_model.module
    x = _x(5, n=2)

    def jax_loss(v):
        recon, mu, logvar, _ = module.apply(v, jnp.asarray(x),
                                            deterministic=True)
        return (jnp.sum((recon - x) ** 2) + jnp.sum(mu ** 2)
                + jnp.sum(logvar ** 2))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(variables)
    loss, grads, _ = _train_step_grads(port, x)
    np.testing.assert_allclose(float(loss), float(want_loss), RTOL, ATOL)
    want = params_from_jax(flatten_pytree(want_grads))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), RTOL,
                                   ATOL * max(1.0, float(want[name].abs().max())),
                                   err_msg=name)


def _jax_loss_and_grads(jax_model, variables, x):
    """The loss of :func:`_train_step_grads` through the JAX module, its
    outputs ``(recon NCHW, μ, logσ²)`` in fp32, and its gradients by the
    port's parameter names."""
    def loss_fn(v):
        recon, mu, logvar, _ = jax_model.module.apply(
            v, jnp.asarray(x), deterministic=True)
        recon, mu, logvar = (a.astype(jnp.float32)
                             for a in (recon, mu, logvar))
        return (jnp.sum((recon - x) ** 2) + jnp.sum(mu ** 2)
                + jnp.sum(logvar ** 2)), (recon, mu, logvar)

    (loss, (recon, mu, logvar)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables)
    outs = (np.transpose(np.asarray(recon), (0, 3, 1, 2)), np.asarray(mu),
            np.asarray(logvar))
    return float(loss), outs, params_from_jax(flatten_pytree(grads))


@pytest.mark.parametrize("remat,fused_head", [(False, False),
                                              ("decoder", True),
                                              (True, True)],
                         ids=["plain", "decoder-fused", "all-fused"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_whole_model_with_the_gn_kernels_matches_jax(bf16, remat,
                                                     fused_head):
    """Every layer-norm ReLU block through ``fused_gn_relu_pool`` (the
    plain version on the CPU), the fused head's ``return_gate`` path and
    remat ``decoder``/``all`` included: the outputs (recon, μ, logσ²) and
    the parameters' gradients of one train-mode backward against the JAX
    module.  fp32: the forward tolerance, 1e-4 relative with 1e-5 absolute
    scaled by the tensor's largest value, each output and each leaf.  bf16,
    the GN kernels' bf16 tolerance (``test_torch_port_gn.py``), 5e-2: each
    output against the JAX module's bf16 one, within 5e-2 of its largest
    value; the whole gradient (every leaf, one vector) against the JAX
    module's fp32 gradient, within 5e-2 of its norm.  A single small leaf
    (an SE bias of 2 values) moves by up to ~12 % of its norm between the
    JAX module's own bf16 and fp32 gradients, the port's by as much; the
    whole gradient 1–2.8 % (JAX bf16) and 0.4–1.4 % (the port) over seeds
    4, 7, 11, 13."""
    seed, x = 4, _x(5, n=2)
    jax_model, variables, _, port = _pair(remat=remat, seed=seed, bf16=bf16,
                                          fused_head=fused_head)
    _, outs, want = _jax_loss_and_grads(jax_model, variables, x)
    if bf16:
        jax32, variables32, _, _ = _pair(remat=remat, seed=seed)
        _, _, want = _jax_loss_and_grads(jax32, variables32, x)
    port.train()
    mu, logvar = port.encode(_nchw(x))
    recon = port.decode(mu)
    (((recon - _nchw(x)) ** 2).sum() + mu.square().sum()
     + logvar.square().sum()).backward()
    rtol, atol = (0.0, 5e-2) if bf16 else (RTOL, ATOL)
    for name, got, ref in zip(("recon", "mu", "logvar"),
                              (recon, mu, logvar), outs):
        np.testing.assert_allclose(
            got.detach().float().numpy(), ref, rtol,
            atol * max(1.0, float(np.abs(ref).max())), err_msg=name)
    if bf16:
        got = torch.cat([p.grad.flatten() for p in port.parameters()])
        ref = torch.cat([want[n].flatten() for n, _ in
                         port.named_parameters()])
        assert float((got - ref).norm() / ref.norm()) <= 5e-2
        return
    for name, p in port.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol,
                                   atol * max(1.0, float(np.abs(ref).max())),
                                   err_msg=name)


@pytest.mark.parametrize("activation", ["relu", "leakyrelu", "elu"])
@pytest.mark.parametrize("norm", ["layer", "batch", "none"])
def test_only_layer_norm_relu_blocks_take_the_gn_kernels(monkeypatch, norm,
                                                         activation):
    """A block whose norm is ``layer`` and whose activation is ``relu``
    runs ``fused_gn_relu_pool`` (its ``nn.GroupNorm`` only holds γ and β)
    and hands its pooled mean to the SE block; every other block runs its
    norm and activation modules as before, and its SE block takes the mean
    itself.  Forward and backward, remat ``all`` included."""
    from betavae_tpu_torch.models import beta_vae, se

    calls = {"fused": 0, "modules": 0, "pooled": 0, "squeezed": 0}
    fused, normed = beta_vae.fused_gn_relu_pool, beta_vae._normed

    def counted_fused(*args):
        calls["fused"] += 1
        return fused(*args)

    def counted_normed(*args):
        calls["modules"] += 1
        return normed(*args)

    excite = se._Excite.forward

    def counted_excite(self, x, return_gate=False, pooled=None):
        calls["squeezed" if pooled is None else "pooled"] += 1
        return excite(self, x, return_gate, pooled)

    monkeypatch.setattr(beta_vae, "fused_gn_relu_pool", counted_fused)
    monkeypatch.setattr(beta_vae, "_normed", counted_normed)
    monkeypatch.setattr(se._Excite, "forward", counted_excite)
    port = BetaVAEModule(16, 1, LATENT, BASE, 2, activation=activation,
                         norm_type=norm, se_reduction=RED, remat=True)
    port.train()
    x = torch.rand(2, 1, 16, 16, generator=torch.Generator().manual_seed(0))
    recon, mu, logvar, _ = port(x, deterministic=True)
    (recon.sum() + mu.sum() + logvar.sum()).backward()
    # 4 blocks, each run again by remat's recompute in the backward
    fuses = norm == "layer" and activation == "relu"
    assert calls == {"fused": 8 * fuses, "modules": 8 * (not fuses),
                     "pooled": 8 * fuses, "squeezed": 8 * (not fuses)}
    assert all(p.grad is not None for p in port.parameters())


@pytest.mark.parametrize("bf16", [False, True])
def test_a_groupnorm_of_two_groups_takes_nn_groupnorm(monkeypatch, bf16):
    """Only GroupNorm(1) goes to the GN kernels: a block whose
    ``nn.GroupNorm`` has two groups, followed by ReLU, gives
    ``relu(nn.GroupNorm(h))`` (bitwise: the same modules run), launches no
    GN kernel, counts itself as a library GroupNorm, and its SE block takes
    the mean itself."""
    from betavae_tpu_torch.models import beta_vae
    from betavae_tpu_torch.utils.profiling import LIBRARY_CALLS

    calls = {"fused": 0}
    fused = beta_vae.fused_gn_relu_pool

    def counted_fused(*args):
        calls["fused"] += 1
        return fused(*args)

    monkeypatch.setattr(beta_vae, "fused_gn_relu_pool", counted_fused)
    block = beta_vae.ConvBlock(1, 8, "layer", "relu", RED)
    block.norm = torch.nn.GroupNorm(2, 8, eps=1e-6)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        block.norm.weight.copy_(torch.rand(8, generator=g) + 0.5)
        block.norm.bias.copy_(torch.randn(8, generator=g))
    h = torch.randn(2, 8, 8, 8, generator=g)
    if bf16:
        h = h.bfloat16()
    before = LIBRARY_CALLS["gn.library"]
    got, pooled = beta_vae._norm_act(block, h)
    want = torch.relu(block.norm(h).to(h.dtype))
    assert pooled is None and calls["fused"] == 0
    assert LIBRARY_CALLS["gn.library"] == before + 1
    assert got.dtype == h.dtype and torch.equal(got, want)
    block.norm = torch.nn.GroupNorm(1, 8, eps=1e-6)
    beta_vae._norm_act(block, h.float())
    assert calls["fused"] == 1


def test_state_dict_keys_are_the_reference_models():
    """The GN kernels leave the parameter names as they were: each block's
    ``norm.weight`` and ``norm.bias`` still sit in its GroupNorm, under the
    reference torch model's names."""
    port = BetaVAEModule(16, 1, LATENT, BASE, 2, se_reduction=RED)
    blocks = [f"encoder.{i}." for i in range(2)] + \
        [f"decoder_blocks.{i}." for i in range(2)]
    want = {"fc_mu", "fc_logvar", "fc_dec", "final_conv"}
    for b in blocks:
        conv = f"{b}conv" if b.startswith("encoder") else f"{b}up.1"
        want |= {conv, f"{b}norm", f"{b}se.block.fc.0", f"{b}se.block.fc.2"}
    assert set(port.state_dict()) == {f"{m}.{p}" for m in want
                                      for p in ("weight", "bias")}


def test_remat_values_and_the_config_key(tmp_path):
    """``training.remat`` takes the JAX module's spellings, reaches the
    model through the config, and refuses anything else by name."""
    import yaml

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.models.beta_vae import (model_from_config,
                                                   resolve_remat)

    assert [resolve_remat(v) for v in (True, "all", "true", "decoder", False,
                                       None, "none", "false")] == \
        ["all"] * 3 + ["decoder"] + ["none"] * 4
    with pytest.raises(ValueError, match="training.remat"):
        resolve_remat("encoder")
    cfg = yaml.safe_load(open("configs/beta_vae_se_debug.yaml"))
    cfg["data"]["image_size"] = 16
    cfg["model"].update(base_channels=4, num_blocks=2, latent_dim=4)
    cfg["training"]["remat"] = "decoder"
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    reset_config_cache()
    try:
        assert model_from_config(get_config(str(path)),
                                 device="cpu").remat == "decoder"
    finally:
        reset_config_cache()


# --------------------------------------------------------------------------
# the ×2 upsample's plain versions (the kernels' oracles): forward and the
# gather-form backward against the JAX function and its VJP, and against
# F.interpolate's autograd
# --------------------------------------------------------------------------

# NCHW: odd H and W, H ≠ W, 1×1, B·C > 1
UPSAMPLE_SHAPES = [(2, 3, 5, 7), (1, 1, 1, 1), (2, 2, 4, 3), (3, 1, 1, 6)]


def _upsample_inputs(shape, dtype):
    """x and dy from a seed, as the port's dtype and as the fp32 values of
    those same numbers (bf16 inputs are rounded before either side sees
    them, so both compute on one set of values)."""
    rng = np.random.default_rng(sum(shape))
    b, c, h, w = shape
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(b, c, 2 * h, 2 * w)).astype(
        np.float32)).to(dtype)
    return x, dy, x.float().numpy(), dy.float().numpy()


def _upsample_tolerance(dtype, want):
    """fp32: 1e-6 relative (plus 1e-6 of the largest |value|, for values
    that cancel); bf16: one bf16 rounding of the fp32 result, 2⁻⁸."""
    rtol = 1e-6 if dtype == torch.float32 else 2**-8
    return dict(rtol=rtol, atol=1e-6 * float(np.abs(want).max()))


def _port_value_and_grad(x, dy):
    xg = x.clone().requires_grad_()
    y = bilinear_upsample_x2(xg)
    y.backward(dy)
    assert y.dtype == x.dtype and xg.grad.dtype == x.dtype
    return y.detach().float().numpy(), xg.grad.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES, ids=str)
def test_upsample_plain_and_gradient_match_jax_vjp(shape, dtype):
    """The plain forward and its gather backward (what CPU tensors take)
    against ``bilinear_upsample_x2`` of the JAX package and its
    ``jax.vjp``, fp32 on the JAX side."""
    x, dy, x32, dy32 = _upsample_inputs(shape, dtype)
    nhwc = (0, 2, 3, 1)
    want, vjp = jax.vjp(jax_upsample, jnp.asarray(np.transpose(x32, nhwc)))
    (want_dx,) = vjp(jnp.asarray(np.transpose(dy32, nhwc)))
    want = np.transpose(np.asarray(want), (0, 3, 1, 2))
    want_dx = np.transpose(np.asarray(want_dx), (0, 3, 1, 2))
    got, got_dx = _port_value_and_grad(x, dy)
    np.testing.assert_allclose(got, want, **_upsample_tolerance(dtype, want))
    np.testing.assert_allclose(got_dx, want_dx,
                               **_upsample_tolerance(dtype, want_dx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES, ids=str)
def test_upsample_plain_and_gradient_match_interpolate_autograd(shape, dtype):
    """The same against ``F.interpolate(scale_factor=2, mode="bilinear",
    align_corners=False)`` and its autograd, in fp32 on the same values:
    the library call the kernels are timed against."""
    import torch.nn.functional as F

    x, dy, x32, dy32 = _upsample_inputs(shape, dtype)
    xr = torch.from_numpy(x32).requires_grad_()
    want_t = F.interpolate(xr, scale_factor=2, mode="bilinear",
                           align_corners=False)
    want_t.backward(torch.from_numpy(dy32))
    want, want_dx = want_t.detach().numpy(), xr.grad.numpy()
    got, got_dx = _port_value_and_grad(x, dy)
    np.testing.assert_allclose(got, want, **_upsample_tolerance(dtype, want))
    np.testing.assert_allclose(got_dx, want_dx,
                               **_upsample_tolerance(dtype, want_dx))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_upsample_gather_backward_is_the_forward_transposed(n):
    """Per axis the gather backward is the forward's matrix transposed, the
    clamped taps folded into the edge: ``dx[0] = 1.0·dy[0] + 0.75·dy[1] +
    0.25·dy[2]``, and for n = 1 both taps of each output land on x[0]."""
    eye = torch.eye(n, dtype=torch.float32)
    # column k of the forward's [2n, n] matrix: the upsample of one-hot x
    a = upsample2x_reference(eye.reshape(n, 1, n, 1).expand(n, 1, n, n)
                             .contiguous())[:, 0, :, 0].t()
    g = torch.from_numpy(np.random.default_rng(n).normal(
        size=(2 * n,)).astype(np.float32))
    dy = g.reshape(1, 1, 2 * n, 1).expand(1, 1, 2 * n, 2).contiguous()
    # W = 1: the W axis folds both taps of each output into one value
    got = upsample2x_backward_reference(dy)[0, 0, :, 0]
    torch.testing.assert_close(got, 2.0 * (a.t() @ g), rtol=1e-6, atol=1e-6)
    if n == 1:
        assert a.t().tolist() == [[1.0, 1.0]]
    else:
        assert a.t()[0, :3].tolist() == [1.0, 0.75, 0.25][:min(3, 2 * n)]


def test_upsample_cpu_tensors_take_the_plain_versions_without_launches():
    """On the CPU the wrappers return the plain versions' bits and count no
    launch; the autograd Function's gradient is the gather backward's;
    two calls give the same bits."""
    x, dy, _, _ = _upsample_inputs((2, 3, 5, 4), torch.float32)
    before = (upsample2x_forward.launches, upsample2x_backward.launches)
    assert torch.equal(upsample2x_forward(x), upsample2x_reference(x))
    assert torch.equal(upsample2x_backward(dy),
                       upsample2x_backward_reference(dy))
    _, got_dx = _port_value_and_grad(x, dy)
    _, again_dx = _port_value_and_grad(x, dy)
    assert np.array_equal(got_dx, upsample2x_backward_reference(dy).numpy())
    assert np.array_equal(got_dx, again_dx)
    assert (upsample2x_forward.launches, upsample2x_backward.launches) == before


# --------------------------------------------------------------------------
# the upsample kernels' path rule and the vector path's tiling (the kernels
# run on the card only; their index map is mirrored in numpy)
# --------------------------------------------------------------------------

# x [B, C, H, W] of the flagship decoder's four upsamples and the scaled
# config's five (configs/beta_vae_se_tpu_scaled.yaml: B 256, 5 blocks)
UPSAMPLE_FLAGSHIP = [(32, 512, 8, 8), (32, 256, 16, 16), (32, 128, 32, 32),
                     (32, 64, 64, 64)]
UPSAMPLE_SCALED = [(256, 1024, 8, 8), (256, 512, 16, 16), (256, 256, 32, 32),
                   (256, 128, 64, 64), (256, 64, 128, 128)]
# small shapes on the vector path: odd H (a plane's last band partial),
# a row of one 16-byte unit and a row of 32 (one warp)
UPSAMPLE_ODD = [((2, 3, 5, 16), torch.bfloat16), ((3, 2, 7, 8), torch.float32),
                ((1, 2, 3, 256), torch.bfloat16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", UPSAMPLE_FLAGSHIP + UPSAMPLE_SCALED, ids=str)
def test_upsample_path_is_vector_on_the_main_shapes(shape, dtype):
    """Every upsample of the flagship and the scaled config, both ways, in
    bf16 and fp32, takes the vector path with 16-byte aligned pointers, as
    fresh tensors have."""
    assert upsample_path(shape, dtype, 16) == "vector"
    assert upsample_path(shape, dtype, 256) == "vector"
    x = torch.empty(shape, dtype=dtype)
    y = torch.empty(shape[:2] + (2 * shape[2], 2 * shape[3]), dtype=dtype)
    assert _alignment(x, y) == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_upsample_path_is_generic_for_ragged_rows_and_misaligned_pointers(
        dtype):
    """[3, 5, 37, 53] (rows not a whole number of 16-byte units), rows of
    3 and 64 units (not a power of two up to a warp), a pointer one value
    past a 16-byte boundary (a storage offset of 1) and any alignment
    under 16 take the generic path."""
    v = 16 // torch.tensor([], dtype=dtype).element_size()
    assert upsample_path((3, 5, 37, 53), dtype, 16) == "generic"
    assert upsample_path((2, 3, 4, 6), dtype, 16) == "generic"
    assert upsample_path((1, 2, 3, 3 * v), dtype, 16) == "generic"
    assert upsample_path((1, 2, 3, 64 * v), dtype, 16) == "generic"
    assert upsample_path((1, 2, 3, 32 * v), dtype, 16) == "vector"
    shape = (32, 64, 64, 64)
    n = math.prod(shape)
    x = torch.empty(n + 1, dtype=dtype)[1:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == 1
    out = torch.empty(shape[:2] + (128, 128), dtype=dtype)
    align = _alignment(x, out)
    assert align == x.element_size()
    assert upsample_path(shape, dtype, align) == "generic"
    for align in (1, 2, 4, 8):
        assert upsample_path(shape, dtype, align) == "generic"


def _check_tiling(shape, dtype, backward: bool) -> None:
    """The mirror of the vector kernels' index map, a batch of whole warps
    at a time: the chunks the batch's threads compute, and those they
    store, are each one run of the output that starts where the last
    batch's ended, every chunk once, and the runs end at the output's end
    (so every output element is written exactly once, and the forward
    stores only staged values); every load is inside the input plane."""
    b, c, h, w = shape
    in_hw = (2 * h, 2 * w) if backward else (h, w)
    v = 16 // torch.tensor([], dtype=dtype).element_size()
    out_chunks = b * c * h * w // v * (1 if backward else 4)
    ctas = vector_tiling(shape, dtype, backward, items=slice(0, 32))["ctas"]
    batch, done = 1 << 20, 0
    for start in range(0, ctas * 256, batch):
        tl = vector_tiling(shape, dtype, backward,
                           items=slice(start, min(start + batch, ctas * 256)))
        assert ((0 <= tl["plane"]) & (tl["plane"] < b * c)).all()
        assert ((0 <= tl["in_row0"]) & (tl["in_row1"] < in_hw[0])).all()
        assert ((0 <= tl["in_col0"]) & (tl["in_col1"] < in_hw[1])).all()
        computed = np.sort(tl["computed"][tl["computed"] >= 0])
        stored = np.sort(tl["stored"][tl["stored"] >= 0])
        want = np.arange(done, done + len(computed))
        assert np.array_equal(computed, want)
        assert np.array_equal(stored, want)
        done += len(computed)
    assert done == out_chunks


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("shape,dtype", [
    *((s, torch.bfloat16) for s in UPSAMPLE_FLAGSHIP + UPSAMPLE_SCALED),
    *((s, torch.float32) for s in UPSAMPLE_FLAGSHIP)], ids=str)
def test_upsample_vector_tiling_covers_the_output_once(shape, dtype, backward):
    """At the main path's shapes (the flagship's in bf16 and fp32, the
    scaled config's in bf16)."""
    _check_tiling(shape, dtype, backward)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("shape,dtype", UPSAMPLE_ODD, ids=str)
def test_upsample_vector_tiling_covers_odd_shapes_once(shape, dtype, backward):
    """At small shapes on the vector path whose last band is partial or
    whose rows fill one 16-byte unit or a whole warp; the last CTA's
    threads past the last item compute nothing."""
    assert upsample_path(shape, dtype, 16) == "vector"
    tl = vector_tiling(shape, dtype, backward)
    idle = np.arange(tl["ctas"] * 256) >= tl["items_total"]
    assert idle.any() and (tl["computed"][idle] == -1).all()
    _check_tiling(shape, dtype, backward)


def test_scaled_config_geometry_matches_jax_forward_and_loss():
    """A tiny geometry of ``configs/beta_vae_se_tpu_scaled.yaml``: 5 blocks
    (32 px → 1 px bottleneck, base 4 → 64 channels, latent 8, GroupNorm(1),
    flatten), its objective (MSE + FFL 0.5, capacity mode), against the
    JAX module and ``compute_loss`` at the forward tolerance (1e-4)."""
    from betavae_tpu.models.losses import LossSpec as JaxLossSpec
    from betavae_tpu.models.losses import compute_loss as jax_compute_loss

    from betavae_tpu_torch.models.losses import LossSpec, compute_loss

    jax_model, variables, _, port = _pair(img=32, blocks=5, latent=8, base=4,
                                          seed=11)
    assert port.bottleneck_hw == jax_model.module.bottleneck_hw == 1
    x = _x(12, n=3, img=32)
    recon, mu, logvar, z = jax_model.module.apply(variables, jnp.asarray(x),
                                                  deterministic=True)
    kl = -0.5 * (1.0 + logvar - mu ** 2 - jnp.exp(logvar))
    spec_kw = dict(use_ffl=True, ffl_weight=0.5)
    call_kw = dict(beta=1.0, capacity=60.0, capacity_weight=1.0)
    want = jax_compute_loss((recon, mu, logvar, z, kl), jnp.asarray(x),
                            spec=JaxLossSpec(**spec_kw), **call_kw)
    with torch.no_grad():
        t_recon, t_mu, t_logvar, t_z = port(_nchw(x), deterministic=True)
        t_kl = -0.5 * (1.0 + t_logvar - t_mu ** 2 - torch.exp(t_logvar))
        got = compute_loss((t_recon, t_mu, t_logvar, t_z, t_kl), _nchw(x),
                           spec=LossSpec(**spec_kw), **call_kw)
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(mu), RTOL, ATOL)
    np.testing.assert_allclose(t_logvar.numpy(), np.asarray(logvar), RTOL,
                               ATOL)
    np.testing.assert_allclose(t_recon.numpy(),
                               np.transpose(np.asarray(recon), (0, 3, 1, 2)),
                               RTOL, ATOL)
    for key in ("total", "recon", "recon_ffl", "kl_mean", "kl_effective"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=RTOL,
                                                abs=ATOL), key
