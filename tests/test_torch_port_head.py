"""The port's fused SE-gate∘head-conv against the JAX package's, on the CPU.

``betavae_tpu_torch.ops.head`` on CPU tensors runs its plain versions (the
CUDA kernels run on the card only: ``tests/test_torch_port_cuda.py``); the
JAX side runs its Pallas kernels in the TPU interpreter, as
``tests/test_pallas_head.py`` does.  Inputs are made with numpy from seeds
and handed to both, NHWC to JAX and NCHW to the port.  Tolerances are the
JAX test's own: forward 5e-5 absolute, gradients 1e-3 absolute plus 1e-4
relative (fp32 sums in other orders).
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
from betavae_tpu.ops import pallas_head as jax_head

from betavae_tpu_torch.models.beta_vae import BetaVAEModule
from betavae_tpu_torch.ops import head

SHAPES = [(2, 16, 16, 8), (3, 32, 24, 64)]   # (B, H, W, C)


def _inputs(b, h, w, c):
    rng = np.random.default_rng(0)
    y = rng.normal(size=(b, h, w, c)).astype(np.float32)          # NHWC
    s = rng.uniform(0, 1, (b, c)).astype(np.float32)
    k = rng.normal(size=(3, 3, c)).astype(np.float32)             # HWC
    return y, s, k


def _to_port(y, s, k):
    """NHWC y → NCHW, HWC k → the port's [C, 3, 3] (``weight[0]``)."""
    return (torch.from_numpy(np.ascontiguousarray(y.transpose(0, 3, 1, 2))),
            torch.from_numpy(s),
            torch.from_numpy(np.ascontiguousarray(k.transpose(2, 0, 1))))


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_forward_matches_jax_kernel_and_reference(b, h, w, c):
    y, s, k = _inputs(b, h, w, c)
    want = np.asarray(jax_head.fused_se_conv_head(
        jnp.asarray(y), jnp.asarray(s), jnp.asarray(k), True))
    oracle = np.asarray(jax_head.head_conv_reference(
        jnp.asarray(y), jnp.asarray(s), jnp.asarray(k)))
    before = head.head_forward.launches
    got = head.fused_se_conv_head(*_to_port(y, s, k))
    assert got.shape == (b, h, w) and got.dtype == torch.float32
    assert head.head_forward.launches == before   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_gradients_match_jax_custom_vjp(b, h, w, c):
    """d/d(y, s, k) of Σ sin(head(y, s, k)) through the autograd Function
    against ``jax.grad`` through the Pallas custom VJP (interpret mode)."""
    y, s, k = _inputs(b, h, w, c)

    def loss(y_, s_, k_):
        return jnp.sum(jnp.sin(jax_head.fused_se_conv_head(y_, s_, k_, True)))

    gy, gs, gk = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(y), jnp.asarray(s), jnp.asarray(k))
    ty, ts, tk = (t.requires_grad_() for t in _to_port(y, s, k))
    torch.sin(head.fused_se_conv_head(ty, ts, tk)).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(),
                               np.asarray(gy).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tk.grad.numpy(),
                               np.asarray(gk).transpose(2, 0, 1),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_m_reduction_matches_jax_m_kernel(b, h, w, c):
    """The plain M against the JAX ``_mkernel`` (interpret): the same
    [B, 9, C] layout, tap = 3·dh + dw."""
    y, _, _ = _inputs(b, h, w, c)
    dy = np.random.default_rng(3).normal(size=(b, h, w)).astype(np.float32)
    want = np.asarray(jax_head._run_m(jnp.asarray(y), jnp.asarray(dy), True))
    got = head.head_m(torch.from_numpy(np.ascontiguousarray(
        y.transpose(0, 3, 1, 2))), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_dx_matches_jax_and_keeps_the_activation_dtype():
    b, h, w, c = 2, 7, 9, 5
    y, s, k = _inputs(b, h, w, c)
    dy = np.random.default_rng(4).normal(size=(b, h, w)).astype(np.float32)
    want = np.asarray(jax_head._dx_xla(jnp.asarray(dy), jnp.asarray(s),
                                       jnp.asarray(k), jnp.float32))
    _, ts, tk = _to_port(y, s, k)
    got = head.head_dx(torch.from_numpy(dy), ts, tk, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    assert head.head_dx(torch.from_numpy(dy), ts, tk,
                        torch.bfloat16).dtype == torch.bfloat16


def test_gradients_come_back_in_the_input_dtypes():
    y, s, k = _to_port(*_inputs(2, 6, 5, 3))
    y = y.to(torch.bfloat16).requires_grad_()
    s = s.to(torch.bfloat16).requires_grad_()
    k = k.requires_grad_()
    head.fused_se_conv_head(y, s, k).sum().backward()
    assert (y.grad.dtype, s.grad.dtype, k.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)


def test_wrappers_refuse_other_devices():
    y = torch.zeros(1, 2, 3, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        head.head_forward(y, torch.zeros(1, 2, device="meta"),
                          torch.zeros(2, 3, 3, device="meta"))
    with pytest.raises(ValueError, match="device"):
        head.head_m(y, torch.zeros(1, 3, 3))


# --------------------------------------------------------------------------
# the model wiring
# --------------------------------------------------------------------------

KW = dict(image_size=16, in_channels=1, latent_dim=4, base_channels=4,
          num_blocks=2, activation="relu", norm_type="layer", se_reduction=2,
          encoder_pooling="flatten", logvar_clamp=(-10.0, 5.0))


def _random_variables(module, seed):
    template = BetaVAE(module=module).variables_template()
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in flatten_pytree(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), template)).items():
        a = rng.normal(0.0, 0.3, np.shape(leaf)).astype(np.float32)
        flat[key] = np.abs(a) + 0.5 if key.endswith("/scale") else a
    return unflatten_like(template, flat)


@pytest.mark.parametrize("use_decoder_se", [True, False])
def test_fused_model_matches_jax_fused_model(use_decoder_se, monkeypatch):
    """Port ``BetaVAEModule(fused_head=True)`` against JAX
    ``BetaVAEModule(fused_head=True)`` with its Pallas head in interpret
    mode, weights from ``export_model_state``: recon and every parameter
    gradient of Σ(recon − x)² + Σμ² within 1e-4 relative (fp32; 1e-6
    absolute for the values near zero).  The port's fused and unfused
    decoders agree within 1e-5."""
    monkeypatch.setenv("BETAVAE_HEAD_INTERPRET", "1")   # read at apply time
    kw = dict(KW, use_decoder_se=use_decoder_se)
    jax_module = JaxBetaVAEModule(**kw, fused_head=True)
    variables = _random_variables(jax_module, seed=1)
    x = np.random.default_rng(2).uniform(size=(2, 16, 16, 1)).astype(
        np.float32)

    def loss(v):
        rec, mu, _, _ = jax_module.apply(v, jnp.asarray(x), deterministic=True)
        return jnp.sum((rec - x) ** 2) + jnp.sum(mu ** 2), rec

    (_, rec), grads = jax.value_and_grad(loss, has_aux=True)(variables)

    port = BetaVAEModule(**kw, fused_head=True)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          export_model_state(flatten_pytree(variables)).items()},
                         strict=True)
    unfused = BetaVAEModule(**kw, fused_head=False)
    unfused.load_state_dict(port.state_dict(), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    t_rec, t_mu, _, _ = port(xt, deterministic=True)
    (((t_rec - xt) ** 2).sum() + (t_mu ** 2).sum()).backward()

    np.testing.assert_allclose(t_rec.detach().numpy(),
                               np.asarray(rec).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-6)
    want = export_model_state(flatten_pytree(grads))
    # fc_logvar takes no part in a deterministic forward: JAX gives zeros
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    with torch.no_grad():
        np.testing.assert_allclose(
            unfused(xt, deterministic=True)[0].numpy(),
            t_rec.detach().numpy(), rtol=0, atol=1e-5)
