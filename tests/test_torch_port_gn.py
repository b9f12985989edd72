"""The GroupNorm(1)+ReLU+pool port against the JAX Pallas kernel, on the CPU.

``betavae_tpu_torch.ops.gn`` (the plain versions, and the autograd Function
whose kernels take them for CPU tensors) against
``betavae_tpu.ops.pallas_gn.fused_gn_relu_pool`` run in the TPU interpreter,
on the same numpy inputs, NHWC for JAX and NCHW for the port.  Tolerances
are those of ``tests/test_pallas_gn.py``: y and pooled 2e-6, gradients of
x, γ and β through both outputs 2e-4, bf16 y 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betavae_tpu.ops.pallas_gn import fused_gn_relu_pool as jax_gn

from betavae_tpu_torch.ops.gn import (fused_gn_relu_pool, fused_groupnorm_relu,
                                      gn_backward, gn_backward_reference,
                                      gn_forward, gn_forward_reference,
                                      gn_relu_pool_reference,
                                      groupnorm_relu_reference, stats_splits)

SHAPES = [(3, 16, 8, 8), (2, 5, 9, 13)]     # NCHW; the second ragged


def _data(shape, seed):
    b, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)         # NHWC
    gamma = rng.normal(size=c).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    return x, gamma, beta


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _jax(x, gamma, beta):
    return jax_gn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                  1e-6, True)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_kernel(shape):
    x, gamma, beta = _data(shape, seed=3)
    y_j, pooled_j = _jax(x, gamma, beta)
    xt, gt, bt = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    for y, pooled in (fused_gn_relu_pool(xt, gt, bt),
                      gn_relu_pool_reference(xt, gt, bt)):
        np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), atol=2e-6)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j),
                                   atol=2e-6)
        assert pooled.dtype == torch.float32 and pooled.shape == shape[:2]
    np.testing.assert_allclose(
        _nhwc(fused_groupnorm_relu(xt, gt, bt)), np.asarray(y_j), atol=2e-6)
    np.testing.assert_allclose(
        _nhwc(groupnorm_relu_reference(xt, gt, bt)), np.asarray(y_j),
        atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_through_both_outputs_match_jax_kernel(shape):
    """dL/dx, dL/dγ, dL/dβ of a loss over y and pooled: the autograd
    Function (its backward the kernels' plain version) against jax.grad
    through the Pallas kernel's custom VJP."""
    b, c, h, w = shape
    x, gamma, beta = _data(shape, seed=4)
    rng = np.random.default_rng(5)
    wy = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wp = rng.normal(size=(b, c)).astype(np.float32)

    def loss_j(x, g, bt):
        y, pooled = jax_gn(x, g, bt, 1e-6, True)
        return jnp.sum(y * wy) + 3.0 * jnp.sum(pooled * wp)

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))

    xt = _nchw(x).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    y, pooled = fused_gn_relu_pool(xt, gt, bt)
    (torch.sum(y * _nchw(wy)) + 3.0 * torch.sum(
        pooled * torch.from_numpy(wp))).backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(grads_j[0]),
                               atol=2e-4)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(grads_j[1]),
                               atol=2e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(grads_j[2]),
                               atol=2e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_closed_form_backward_matches_autograd_of_plain_forward(shape):
    """The kernels' closed-form backward (plain version) against autograd
    through the plain forward, in float64: the formula itself, 1e-10."""
    b, c, h, w = shape
    x, gamma, beta = _data(shape, seed=6)
    rng = np.random.default_rng(7)
    gy = torch.from_numpy(rng.normal(size=(b, c, h, w)))
    gp = torch.from_numpy(rng.normal(size=(b, c)))
    xt = _nchw(x).double().requires_grad_()
    gt = torch.from_numpy(gamma).double().requires_grad_()
    bt = torch.from_numpy(beta).double().requires_grad_()

    def forward64(x, g, bt_):
        # gn_forward_reference's math in float64
        n = x[0].numel()
        flat = x.reshape(x.shape[0], -1)
        m = flat.sum(dim=1) / n
        rstd = torch.rsqrt(torch.clamp_min(
            (flat * flat).sum(dim=1) / n - m * m, 0.0) + 1e-6)
        z = (x - m[:, None, None, None]) * rstd[:, None, None, None] \
            * g[None, :, None, None] + bt_[None, :, None, None]
        y = torch.clamp_min(z, 0.0)
        return y, y.mean(dim=(2, 3)), m, rstd

    y, pooled, m, rstd = forward64(xt, gt, bt)
    dx_a, dg_a, db_a = torch.autograd.grad(
        (y * gy).sum() + (pooled * gp).sum(), (xt, gt, bt))
    with torch.no_grad():
        x64 = xt.detach()
        zero = torch.zeros((), dtype=torch.float64)
        xhat = (x64 - m[:, None, None, None]) * rstd[:, None, None, None]
        z = xhat * gt[None, :, None, None] + bt[None, :, None, None]
        g = gy + (gp / (h * w))[:, :, None, None]
        gz = torch.where(z > 0, g, zero)
        dxhat = gz * gt[None, :, None, None]
        n = c * h * w
        dx = rstd[:, None, None, None] * (
            dxhat - dxhat.sum(dim=(1, 2, 3), keepdim=True) / n
            - xhat * (dxhat * xhat).sum(dim=(1, 2, 3), keepdim=True) / n)
    torch.testing.assert_close(dx, dx_a, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(gz.sum(dim=(0, 2, 3)), db_a, rtol=1e-10,
                               atol=1e-10)
    torch.testing.assert_close((gz * xhat).sum(dim=(0, 2, 3)), dg_a,
                               rtol=1e-10, atol=1e-10)

    # the port's plain backward, fp32, from the same m and rstd
    x32, g32, b32 = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    _, _, m32, r32 = gn_forward_reference(x32, g32, b32)
    dx32, dg32, db32 = gn_backward_reference(x32, g32, b32, m32, r32,
                                             gy.float(), gp.float())
    torch.testing.assert_close(dx32.double(), dx_a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dg32.sum(0).double(), dg_a, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(db32.sum(0).double(), db_a, rtol=1e-4,
                               atol=1e-4)


def test_bf16_io_dtype_matches_jax_kernel():
    """bf16 x: y comes back bf16 (within 5e-2 of the JAX kernel's bf16 y),
    pooled fp32 and, from the fp32 y, within 2e-6 of the JAX kernel's."""
    x, gamma, beta = _data((3, 16, 8, 8), seed=2)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    y_j, pooled_j = jax_gn(x16, jnp.asarray(gamma), jnp.asarray(beta), 1e-6,
                           True)
    xt = _nchw(np.asarray(x16.astype(jnp.float32))).to(torch.bfloat16)
    y, pooled = fused_gn_relu_pool(xt, torch.from_numpy(gamma),
                                   torch.from_numpy(beta))
    assert y.dtype == torch.bfloat16 and pooled.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j, dtype=np.float32),
                               atol=5e-2)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j),
                               atol=2e-6)


def test_pooled_averages_the_fp32_y_not_the_rounded_y():
    """pooled is the mean of y before y is rounded to bf16: equal (1e-7)
    to the mean of the plain fp32 y and to the JAX kernel's pooled, and
    measurably off the mean of the bf16 y the caller gets back."""
    rng = np.random.default_rng(11)
    b, c, h, w = 2, 4, 16, 16
    # values just above bf16's rounding points, so that y's rounding moves
    # every channel's mean the same way
    x = (1.0 + rng.integers(0, 64, size=(b, c, h, w)) / 64.0
         + 2.0**-10).astype(np.float32)
    gamma = np.full(c, 1.0, np.float32)
    beta = np.full(c, 2.0, np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y, pooled = fused_gn_relu_pool(xt, torch.from_numpy(gamma),
                                   torch.from_numpy(beta))
    y32, _ = gn_relu_pool_reference(xt, torch.from_numpy(gamma),
                                    torch.from_numpy(beta))
    torch.testing.assert_close(pooled, y32.mean(dim=(2, 3)), rtol=0,
                               atol=1e-7)
    rounded = y.float().mean(dim=(2, 3))
    assert float((pooled - rounded).abs().max()) > 1e-4
    _, pooled_j = jax_gn(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(
        jnp.bfloat16), jnp.asarray(gamma), jnp.asarray(beta), 1e-6, True)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j),
                               atol=2e-6)


def test_cpu_tensors_take_the_plain_version_without_launching():
    x, gamma, beta = _data((2, 5, 9, 13), seed=8)
    xt, gt, bt = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    before = (gn_forward.launches, gn_backward.launches)
    y, pooled, m, rstd = gn_forward(xt, gt, bt)
    dx, dg, db = gn_backward(xt, gt, bt, m, rstd, torch.ones_like(xt),
                             torch.ones(2, 5))
    assert (gn_forward.launches, gn_backward.launches) == before
    assert dx.shape == xt.shape and dg.shape == db.shape == (2, 5)
    y_ref, pooled_ref, m_ref, r_ref = gn_forward_reference(xt, gt, bt)
    assert torch.equal(y, y_ref) and torch.equal(pooled, pooled_ref)
    assert torch.equal(m, m_ref) and torch.equal(rstd, r_ref)


@pytest.mark.parametrize("values,splits", [
    (1, 1), (8192, 1), (8193, 2), (64 * 128 * 128, 128), (512 * 8 * 8, 4),
    (5 * 37 * 53, 2)])
def test_stats_splits(values, splits):
    """Blocks per sample of the stats pass: one per 8192 values."""
    assert stats_splits(values) == splits
