"""The port's FFL, LPIPS and ``compute_loss`` against the JAX package, fp32
on CPU.

Inputs are numpy arrays from a seed (NHWC for JAX, NCHW for the port).
Values hold to 1e-5 relative (atol 1e-6; the FFL's matmul DFT against
cuFFT/pocketfft's FFT differs at fp32 rounding) and gradients to 1e-4
relative (atol 1e-6).  LPIPS loads one ``.npz`` (the JAX module's own
parameters in the converter's layout) into both packages; its distance
holds to 1e-4 relative and its gradient to 1e-4 relative plus 1e-6 of the
largest |value| (five convolutions and a channel normalisation, summed in
other orders by XLA and by PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betavae_tpu.io.checkpoint import flatten_pytree
from betavae_tpu.models.losses import LossSpec as JaxLossSpec
from betavae_tpu.models.losses import compute_loss as jax_compute_loss
from betavae_tpu.ops.ffl import focal_frequency_loss as jax_ffl
from betavae_tpu.ops.lpips import _load_or_init_params
from betavae_tpu.ops.lpips import build_lpips_fn as jax_build_lpips_fn

from betavae_tpu_torch.models.losses import LossSpec, compute_loss
from betavae_tpu_torch.ops.ffl import focal_frequency_loss
from betavae_tpu_torch.ops.lpips import build_lpips_fn, load_lpips_module

B, H, W, L = 4, 16, 16, 6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("alpha,channels", [(1.0, 1), (2.0, 2)])
def test_ffl_matches_jax(alpha, channels):
    rng = np.random.default_rng(0)
    pred = rng.uniform(size=(B, H, W, channels)).astype(np.float32)
    target = rng.uniform(size=(B, H, W, channels)).astype(np.float32)
    want = float(jax_ffl(jnp.asarray(pred), jnp.asarray(target), alpha=alpha))
    got = float(focal_frequency_loss(_nchw(pred), _nchw(target), alpha=alpha))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "recon": rng.uniform(0.05, 0.95, size=(B, H, W, 1)).astype(np.float32),
        "x": rng.uniform(size=(B, H, W, 1)).astype(np.float32),
        "mu": rng.normal(size=(B, L)).astype(np.float32),
        "logvar": rng.normal(size=(B, L)).astype(np.float32),
        "z": rng.normal(size=(B, L)).astype(np.float32),
        "kl": np.abs(rng.normal(size=(B, L))).astype(np.float32),
    }


MODES = {
    # name: (spec kwargs, compute_loss kwargs)
    "beta": (dict(use_ffl=True, ffl_weight=0.5), dict(beta=0.7)),
    "free_bits": (dict(free_bits_enabled=True), dict(beta=1.3, free_bits=0.6)),
    "capacity": (dict(use_ffl=True, ffl_weight=0.5),
                 dict(beta=1.0, capacity=3.0, capacity_weight=2.0)),
    "deterministic": (dict(deterministic=True, latent_reg_lambda=0.1),
                      dict(beta=1.0)),
    "latent_reg_bce": (dict(recon_loss_type="bce", latent_reg_lambda=0.2),
                       dict(beta=0.5)),
    "l1": (dict(recon_loss_type="l1"), dict(beta=0.5)),
}
SCALARS = ("total", "recon", "recon_base", "recon_lpips", "recon_ffl",
           "kl_mean", "kl_effective", "latent_reg", "beta")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_compute_loss_values_and_grads_match_jax(mode):
    spec_kw, call_kw = MODES[mode]
    a = _arrays(1)
    mask = np.array([1, 1, 0, 1], np.float32)  # a padded batch row

    def jax_total(recon, mu, kl):
        out = jax_compute_loss(
            (recon, mu, jnp.asarray(a["logvar"]), jnp.asarray(a["z"]), kl),
            jnp.asarray(a["x"]), spec=JaxLossSpec(**spec_kw),
            mask=jnp.asarray(mask), **call_kw)
        return out["total"], out

    (_, want), grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(a["recon"]), jnp.asarray(a["mu"]), jnp.asarray(a["kl"]))

    recon = _nchw(a["recon"]).requires_grad_()
    mu = torch.from_numpy(a["mu"]).requires_grad_()
    kl = torch.from_numpy(a["kl"]).requires_grad_()
    got = compute_loss(
        (recon, mu, torch.from_numpy(a["logvar"]), torch.from_numpy(a["z"]),
         kl), _nchw(a["x"]), spec=LossSpec(**spec_kw),
        mask=torch.from_numpy(mask), **call_kw)
    got["total"].backward()

    assert set(got) == set(want)
    assert got["mode"] == want["mode"]
    for k in SCALARS:
        assert float(got[k].detach()) == pytest.approx(
            float(want[k]), rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(got["kl_per_dim"].detach().numpy(),
                               np.asarray(want["kl_per_dim"]), 1e-5, 1e-6)
    cap = float(got["capacity"])
    assert (np.isnan(cap) and np.isnan(float(want["capacity"]))) or \
        cap == pytest.approx(float(want["capacity"]))
    np.testing.assert_allclose(recon.grad.numpy(),
                               np.transpose(np.asarray(grads[0]), (0, 3, 1, 2)),
                               1e-4, 1e-6)
    for t, g in ((mu, grads[1]), (kl, grads[2])):
        want_g = np.asarray(g)
        got_g = np.zeros_like(want_g) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got_g, want_g, 1e-4, 1e-6)


# --------------------------------------------------------------------------
# LPIPS
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """The JAX module's parameters in ``scripts/convert_lpips_weights.py``'s
    layout (``net/conv{i}/kernel`` HWIO, ``net/conv{i}/bias``, ``lin{i}``)."""
    _, params = _load_or_init_params(None)
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    np.savez(path, **flatten_pytree(params))
    return str(path)


@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (2, 48, 40, 3)])
def test_lpips_distance_and_gradient_match_jax(lpips_npz, shape):
    rng = np.random.default_rng(shape[-1])
    pred = rng.uniform(size=shape).astype(np.float32)
    target = rng.uniform(size=shape).astype(np.float32)
    jax_lpips = jax_build_lpips_fn(lpips_npz)
    want, want_grad = jax.value_and_grad(
        lambda p: jax_lpips(p, jnp.asarray(target)))(jnp.asarray(pred))

    lpips = build_lpips_fn(lpips_npz, device="cpu")
    p = _nchw(pred).requires_grad_()
    t = _nchw(target)
    got = lpips(p, t)
    got.backward()
    assert float(want) > 0
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    want_grad = np.transpose(np.asarray(want_grad), (0, 3, 1, 2))
    np.testing.assert_allclose(p.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-6 * float(np.abs(want_grad).max()))
    assert t.grad is None


def test_lpips_identical_images_give_zero(lpips_npz, monkeypatch):
    """0 for identical images with the converted weights and with the
    seeded random init, whose parameters are frozen, replay, and follow
    flax's initialisers (zero biases, ``lin{i}`` in [0, 0.1))."""
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    x = _nchw(np.random.default_rng(0).uniform(
        size=(2, 64, 64, 1)).astype(np.float32))
    for path in (lpips_npz, None):
        assert float(build_lpips_fn(path, device="cpu")(x, x)) == 0.0
    with pytest.warns(UserWarning, match="random"):
        first = load_lpips_module(None).state_dict()
    second = load_lpips_module(None).state_dict()
    assert all(torch.equal(v, second[k]) for k, v in first.items())
    assert not any(v.requires_grad for v in load_lpips_module(None).parameters())
    for i in range(5):
        assert not first[f"net.convs.{i}.bias"].any()
        lin = first[f"lins.{i}"]
        assert float(lin.min()) >= 0.0 and float(lin.max()) < 0.1
