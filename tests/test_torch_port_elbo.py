"""The fused reparam+KL kernel's plain version against the JAX package.

On the CPU the JAX ``fused_reparam_kl`` runs in the TPU interpreter, as
``tests/test_pallas_elbo.py`` runs it; its PRNG returns zero bits there, so
its ε is recovered as ``(z − μ)/std`` and handed to the port's plain
version.  Values hold to 1e-5 relative (atol 1e-6): the same fp32 formula,
rounded in the same order.  The port's own noise (Philox4x32-10 +
Box–Muller) is checked against Random123's known-answer vectors.  The
autograd Function's CPU backward (the plain closed form the backward kernel
replaces) is held to the JAX VJP ``_bwd`` called directly with a nonzero ε,
since the interpreter's ε is zero and would hide the g_z term of dlogσ².
The kernels themselves are held against the plain versions on the card by
``tests/test_torch_port_cuda.py``.  A data-parallel rank's ``start`` draws
its rows of the whole batch's noise, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betavae_tpu.ops.pallas_elbo import _bwd as jax_bwd
from betavae_tpu.ops.pallas_elbo import fused_reparam_kl as jax_fused

from betavae_tpu_torch.ops.elbo import (fused_reparam_kl, philox4x32_10,
                                        philox_normal, reparam_kl_backward,
                                        reparam_kl_forward,
                                        reparam_kl_reference)


def _inputs(seed, shape=(8, 64)):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=shape).astype(np.float32)
    logvar = np.clip(rng.normal(size=shape), -10, 5).astype(np.float32)
    return mu, logvar


def _jax_interpret(mu, logvar, seed=11):
    z, kl = jax_fused(jnp.int32(seed), jnp.asarray(mu), jnp.asarray(logvar),
                      True)
    z = np.asarray(z)
    eps = (z - mu) / np.exp(0.5 * logvar)
    return z, np.asarray(kl), eps.astype(np.float32)


def test_plain_version_matches_jax_kernel():
    mu, logvar = _inputs(0)
    z, kl, eps = _jax_interpret(mu, logvar)
    t_z, t_kl = reparam_kl_reference(torch.from_numpy(mu),
                                     torch.from_numpy(logvar),
                                     torch.from_numpy(eps))
    np.testing.assert_allclose(t_z.numpy(), z, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_kl.numpy(), kl, rtol=1e-5, atol=1e-6)


def test_plain_autograd_matches_jax_vjp():
    """Gradients of Σ(a·z + b·kl) through the plain version (autograd) and
    through the JAX custom VJP, with the same ε; 1e-4 relative (atol 1e-5)
    as ``tests/test_pallas_elbo.py`` holds its VJP."""
    mu, logvar = _inputs(1)
    rng = np.random.default_rng(2)
    a = rng.normal(size=mu.shape).astype(np.float32)
    b = rng.normal(size=mu.shape).astype(np.float32)
    _, _, eps = _jax_interpret(mu, logvar, seed=5)

    def loss(m, lv):
        z, kl = jax_fused(jnp.int32(5), m, lv, True)
        return jnp.sum(z * a) + jnp.sum(kl * b)

    d_mu, d_logvar = jax.grad(loss, argnums=(0, 1))(jnp.asarray(mu),
                                                     jnp.asarray(logvar))
    t_mu = torch.from_numpy(mu).requires_grad_()
    t_lv = torch.from_numpy(logvar).requires_grad_()
    t_z, t_kl = reparam_kl_reference(t_mu, t_lv, torch.from_numpy(eps))
    ((t_z * torch.from_numpy(a)).sum() + (t_kl * torch.from_numpy(b)).sum()
     ).backward()
    np.testing.assert_allclose(t_mu.grad.numpy(), np.asarray(d_mu),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_lv.grad.numpy(), np.asarray(d_logvar),
                               rtol=1e-4, atol=1e-5)


def test_cpu_backward_matches_jax_bwd():
    """Gradients of Σ(g_z·z + g_kl·kl) through the Function on CPU tensors
    (its ε: the Philox stream at (seed, offset), nonzero) against the JAX
    closed form on the same residuals (μ, logσ², ε) and cotangents: 1e-5
    relative (atol 1e-6); the backward kernel's count stays 0."""
    reparam_kl_backward.launches = 0
    mu, logvar = _inputs(5)
    rng = np.random.default_rng(6)
    g_z = rng.normal(size=mu.shape).astype(np.float32)
    g_kl = rng.normal(size=mu.shape).astype(np.float32)
    eps = philox_normal(mu.shape, 21, 9)
    assert float(eps.abs().min()) > 0
    t_mu = torch.from_numpy(mu).requires_grad_()
    t_lv = torch.from_numpy(logvar).requires_grad_()
    z, kl = fused_reparam_kl(t_mu, t_lv, seed=21, offset=9)
    torch.autograd.backward((z, kl), (torch.from_numpy(g_z),
                                      torch.from_numpy(g_kl)))
    _, want_mu, want_lv = jax_bwd(
        False, (jnp.asarray(mu), jnp.asarray(logvar), jnp.asarray(eps.numpy())),
        (jnp.asarray(g_z), jnp.asarray(g_kl)))
    np.testing.assert_allclose(t_mu.grad.numpy(), np.asarray(want_mu),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_lv.grad.numpy(), np.asarray(want_lv),
                               rtol=1e-5, atol=1e-6)
    assert reparam_kl_backward.launches == 0


def test_cpu_wrapper_is_the_plain_version_and_never_launches():
    """On CPU tensors the wrapper computes the plain version with its own
    Philox ε, its closed-form backward equals autograd through the plain
    version, and the launch count stays 0."""
    fused_reparam_kl.launches = 0
    mu, logvar = _inputs(3)
    t_mu = torch.from_numpy(mu).requires_grad_()
    t_lv = torch.from_numpy(logvar).requires_grad_()
    z, kl = fused_reparam_kl(t_mu, t_lv, seed=115, offset=4)
    eps = philox_normal(mu.shape, 115, 4)
    z_ref, kl_ref = reparam_kl_reference(torch.from_numpy(mu),
                                         torch.from_numpy(logvar), eps)
    torch.testing.assert_close(z.detach(), z_ref, rtol=0, atol=0)
    torch.testing.assert_close(kl.detach(), kl_ref, rtol=0, atol=0)

    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=mu.shape).astype(np.float32))
    ((z * g).sum() + (kl * 2.0).sum()).backward()
    p_mu = torch.from_numpy(mu).requires_grad_()
    p_lv = torch.from_numpy(logvar).requires_grad_()
    pz, pkl = reparam_kl_reference(p_mu, p_lv, eps)
    ((pz * g).sum() + (pkl * 2.0).sum()).backward()
    torch.testing.assert_close(t_mu.grad, p_mu.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(t_lv.grad, p_lv.grad, rtol=1e-5, atol=1e-5)
    assert fused_reparam_kl.launches == 0


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's published Philox4x32-10 known-answer vectors."""
    words = [torch.tensor([c], dtype=torch.int64) for c in counter]
    got = philox4x32_10(*words, *key)
    assert tuple(int(w) for w in got) == want


def test_noise_statistics_and_seeding():
    """N(0,1) moments on 32768 draws (the bounds of the JAX package's
    hardware noise test), replay for a (seed, offset), change otherwise."""
    eps = philox_normal((256, 128), seed=3, offset=0)
    assert abs(float(eps.mean())) < 0.02
    assert abs(float(eps.std()) - 1.0) < 0.02
    assert 0.28 < float((eps.abs() > 1.0).float().mean()) < 0.36
    assert torch.equal(eps, philox_normal((256, 128), seed=3, offset=0))
    assert not torch.equal(eps, philox_normal((256, 128), seed=4, offset=0))
    assert not torch.equal(eps, philox_normal((256, 128), seed=3, offset=1))
    # element i depends on i alone, not on the shape of the call
    assert torch.equal(eps.reshape(-1)[:100],
                       philox_normal((100,), seed=3, offset=0))


@pytest.mark.parametrize("rows,world", [(16, 2), (8, 4), (1, 32)])
def test_start_draws_the_rows_of_the_whole_batch(rows, world):
    """A data-parallel rank r holding ``rows`` rows of a [rows·world, 64]
    batch passes ``start = r·rows·64`` and must draw exactly those rows of
    the whole batch's ε, bitwise: the plain Philox and the CPU wrapper's
    z and KL; ``start = 0`` is the call without it, bitwise."""
    shape = (rows * world, 64)
    full = philox_normal(shape, seed=115, offset=7)
    assert torch.equal(full, philox_normal(shape, 115, 7, start=0))
    mu, logvar = (torch.from_numpy(a) for a in _inputs(5, shape))
    z_full, kl_full, eps_full = reparam_kl_forward(mu, logvar, 115, 7)
    assert torch.equal(eps_full, full)
    for r in range(world):
        sl = slice(r * rows, (r + 1) * rows)
        start = r * rows * 64
        assert torch.equal(philox_normal((rows, 64), 115, 7, start=start),
                           full[sl])
        z, kl, eps = reparam_kl_forward(mu[sl], logvar[sl], 115, 7, start)
        assert torch.equal(eps, full[sl])
        assert torch.equal(z, z_full[sl]) and torch.equal(kl, kl_full[sl])
        zf, klf = fused_reparam_kl(mu[sl], logvar[sl], 115, 7, start)
        assert torch.equal(zf, z_full[sl]) and torch.equal(klf, kl_full[sl])
    with pytest.raises(ValueError, match="start"):
        philox_normal((2, 64), 115, 7, start=-1)


@pytest.mark.parametrize("offset", [7, 2**31 + 100_000 + 3, 2**40 + 5],
                         ids=["step", "val", "high-word"])
@pytest.mark.parametrize("rows,world", [(8, 1), (16, 2), (1, 32)])
def test_device_offset_is_the_int_offset_bitwise(offset, rows, world):
    """The offset as a 0-d int64 tensor (a captured step's slot) gives
    bitwise the int offset's ε, z and KL, at every rank's ``start``, in the
    plain Philox, ``reparam_kl_forward`` and the autograd wrapper, whose
    gradients are bitwise too; KL matches the JAX kernel's (interpreter)
    and z the JAX formula on this ε, at the tolerance above (1e-5 relative,
    atol 1e-6)."""
    shape = (rows * world, 64)
    dev_offset = torch.tensor(offset, dtype=torch.int64)
    mu_np, logvar_np = _inputs(6, shape)
    mu, logvar = torch.from_numpy(mu_np), torch.from_numpy(logvar_np)
    for r in range(world):
        sl, start = slice(r * rows, (r + 1) * rows), r * rows * 64
        assert torch.equal(
            philox_normal((rows, 64), 115, dev_offset, start=start),
            philox_normal((rows, 64), 115, offset, start=start))
        want = reparam_kl_forward(mu[sl], logvar[sl], 115, offset, start)
        got = reparam_kl_forward(mu[sl], logvar[sl], 115, dev_offset, start)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        grads = []
        for off in (offset, dev_offset):
            m = mu[sl].clone().requires_grad_()
            lv = logvar[sl].clone().requires_grad_()
            z, kl = fused_reparam_kl(m, lv, 115, off, start)
            ((z * 3.0).sum() + kl.sum()).backward()
            grads.append((z.detach(), kl.detach(), m.grad, lv.grad))
        for g, w in zip(*grads):
            assert torch.equal(g, w)
    _, kl_jax, _ = _jax_interpret(mu_np, logvar_np)
    z, kl, eps = reparam_kl_forward(mu, logvar, 115, dev_offset)
    np.testing.assert_allclose(kl.numpy(), kl_jax, rtol=1e-5, atol=1e-6)
    z_jax = jnp.asarray(mu_np) + jnp.asarray(eps.numpy()) * jnp.exp(
        0.5 * jnp.asarray(logvar_np))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="0-d int64"):
        reparam_kl_forward(mu, logvar, 115, dev_offset.to(torch.int32))
