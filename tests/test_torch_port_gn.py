"""The GroupNorm(1)+ReLU+pool port against the JAX Pallas kernel, on the CPU.

``betavae_tpu_torch.ops.gn`` (the plain versions, and the autograd Function
whose kernels take them for CPU tensors) against
``betavae_tpu.ops.pallas_gn.fused_gn_relu_pool`` run in the TPU interpreter,
on the same numpy inputs, NHWC for JAX and NCHW for the port.  Tolerances
are those of ``tests/test_pallas_gn.py``: y and pooled 2e-6, gradients of
x, γ and β through both outputs 2e-4, bf16 y 5e-2.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betavae_tpu.ops.pallas_gn import fused_gn_relu_pool as jax_gn

from betavae_tpu_torch.ops.gn import (_param_views, _partial_offset,
                                      _stats_views, fused_gn_relu_pool,
                                      fused_groupnorm_relu, gn_backward,
                                      gn_backward_reference, gn_forward,
                                      gn_forward_reference, gn_path,
                                      gn_relu_pool_reference,
                                      groupnorm_relu_reference)

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


def _one_flip(y, hw: int) -> float:
    """How far one bf16 y value rounded the other way moves a channel's
    mean: one bf16 step (2⁻⁷ of the value, at most) of the largest y, over
    the plane."""
    return 2.0**-7 * float(np.abs(np.asarray(y, dtype=np.float32)).max()) / hw


def test_bf16_io_dtype_matches_jax_kernel():
    """bf16 x: y comes back bf16 (within 5e-2 of the JAX kernel's bf16 y),
    pooled fp32, within one y rounding flip of the mean of the JAX kernel's
    bf16 y: the mean of y as the block passes it on (the JAX kernel's own
    pooled is its fp32 y's: ``test_bf16_pooled_is_the_mean_of_the_bf16_y``)."""
    x, gamma, beta = _data((3, 16, 8, 8), seed=2)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    y_j, _ = jax_gn(x16, jnp.asarray(gamma), jnp.asarray(beta), 1e-6, True)
    xt = _nchw(np.asarray(x16.astype(jnp.float32))).to(torch.bfloat16)
    y, pooled = fused_gn_relu_pool(xt, torch.from_numpy(gamma),
                                   torch.from_numpy(beta))
    assert y.dtype == torch.bfloat16 and pooled.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j, dtype=np.float32),
                               atol=5e-2)
    np.testing.assert_allclose(
        pooled.numpy(), np.asarray(y_j, dtype=np.float32).mean(axis=(1, 2)),
        rtol=0, atol=_one_flip(y_j, 8 * 8))


def _rounding_data():
    """[2, 4, 16, 16] x just above bf16's rounding points, γ 1, β 2, so
    that y's rounding to bf16 moves every channel's mean the same way."""
    rng = np.random.default_rng(11)
    b, c, h, w = 2, 4, 16, 16
    x = (1.0 + rng.integers(0, 64, size=(b, c, h, w)) / 64.0
         + 2.0**-10).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.full((c,), 1.0), torch.full((c,), 2.0))


def test_pooled_averages_the_fp32_y_not_the_rounded_y():
    """fp32 x: pooled is the mean of the fp32 y, equal (1e-7) to the plain
    fp32 y's and (2e-6) to the JAX kernel's pooled, and measurably off the
    mean of y rounded to bf16."""
    xt, gt, bt = _rounding_data()
    x32 = xt.float()
    y, pooled = fused_gn_relu_pool(x32, gt, bt)
    assert y.dtype == torch.float32
    torch.testing.assert_close(pooled, y.mean(dim=(2, 3)), rtol=0, atol=1e-7)
    rounded = y.to(torch.bfloat16).float().mean(dim=(2, 3))
    assert float((pooled - rounded).abs().max()) > 1e-4
    _, pooled_j = jax_gn(jnp.asarray(x32.numpy().transpose(0, 2, 3, 1)),
                         jnp.asarray(gt.numpy()), jnp.asarray(bt.numpy()),
                         1e-6, True)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j),
                               atol=2e-6)


def test_bf16_pooled_is_the_mean_of_the_bf16_y():
    """bf16 x: pooled is the mean of the bf16 y the block passes on, as the
    JAX model's blocks take it (flax ``GroupNorm`` in bf16 → ReLU → the SE
    block's mean) and as the mean of the JAX kernel's bf16 y gives it:
    within one y rounding flip of each.  The JAX kernel's own pooled, the
    mean of its fp32 y, is off by more than that."""
    xt, gt, bt = _rounding_data()
    hw = xt.shape[2] * xt.shape[3]
    y, pooled = fused_gn_relu_pool(xt, gt, bt)
    torch.testing.assert_close(pooled, y.float().mean(dim=(2, 3)), rtol=0,
                               atol=1e-7)
    x16 = jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1)).astype(
        jnp.bfloat16)
    g, b = jnp.asarray(gt.numpy()), jnp.asarray(bt.numpy())
    y_j, pooled_j = jax_gn(x16, g, b, 1e-6, True)
    norm = flax_nn.GroupNorm(num_groups=1, epsilon=1e-6, dtype=jnp.bfloat16)
    h = jax.nn.relu(norm.apply({"params": {"scale": g, "bias": b}}, x16))
    assert h.dtype == jnp.bfloat16
    tol = _one_flip(y_j, hw)
    for ref in (y_j, h):
        np.testing.assert_allclose(
            pooled.numpy(), np.asarray(ref, dtype=np.float32).mean(
                axis=(1, 2)), rtol=0, atol=tol)
    assert float(np.abs(pooled.numpy() - np.asarray(pooled_j)).max()) > tol


def test_cpu_tensors_take_the_plain_version_without_launching():
    x, gamma, beta = _data((2, 5, 9, 13), seed=8)
    xt, gt, bt = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    before = (gn_forward.launches, gn_backward.launches,
              dict(gn_forward.launches_by_path),
              dict(gn_backward.launches_by_path))
    y, pooled, m, rstd = gn_forward(xt, gt, bt)
    dx, dg, db = gn_backward(xt, gt, bt, m, rstd, torch.ones_like(xt),
                             torch.ones(2, 5))
    assert (gn_forward.launches, gn_backward.launches,
            gn_forward.launches_by_path,
            gn_backward.launches_by_path) == before
    assert dx.shape == xt.shape and dg.shape == db.shape == (2, 5)
    y_ref, pooled_ref, m_ref, r_ref = gn_forward_reference(xt, gt, bt)
    assert torch.equal(y, y_ref) and torch.equal(pooled, pooled_ref)
    assert torch.equal(m, m_ref) and torch.equal(rstd, r_ref)


@pytest.mark.parametrize("shape,offset", [
    ((2, 4, 8, 8), 0.0), ((3, 5, 9, 13), 0.0), ((2, 4, 8, 8), 1e3),
    ((1, 16, 32, 32), 1e3), ((2, 3, 5, 7), 1e4), ((4, 2, 16, 16), -300.0)])
def test_plain_statistics_are_the_float64_ones(shape, offset):
    """The plain versions' m and rstd: the float64 mean and variance of the
    fp32 values, rounded to fp32, also where the mean is 300 to 10⁴ times
    the spread (Σx²/n − m² in fp32 keeps none of such a variance's
    digits)."""
    b = shape[0]
    g = torch.Generator().manual_seed(7)
    x = offset + torch.randn(shape, generator=g)
    c = shape[1]
    _, _, m, rstd = gn_forward_reference(x, torch.ones(c), torch.zeros(c))
    x64 = x.double().reshape(b, -1)
    assert torch.equal(m, x64.mean(dim=1).float())
    want = torch.rsqrt(x64.var(dim=1, unbiased=False) + 1e-6)
    torch.testing.assert_close(rstd.double(), want, rtol=3e-7, atol=0)


BF16, FP32 = torch.bfloat16, torch.float32


def _misaligned_view():
    """A contiguous bf16 [2, 8, 64, 66] that starts 2 bytes past a 16-byte
    boundary: the path rule reads shape and dtype only, so it takes the
    cluster path (the kernel walks it one value at a time)."""
    flat = torch.zeros(2 * 8 * 64 * 66 + 1, dtype=BF16)
    return flat[1:].view(2, 8, 64, 66)


@pytest.mark.parametrize("shape,dtype,want", [
    # the flagship's eight blocks in bf16: clusters of 8 (B = 32, 264 / 32)
    # but dec3, whose 2 MiB sample is over 8 CTAs of 72 KiB
    pytest.param((32, 64, 64, 64), BF16, ("cluster", 8), id="enc0"),
    pytest.param((32, 128, 32, 32), BF16, ("cluster", 8), id="enc1"),
    pytest.param((32, 256, 16, 16), BF16, ("cluster", 8), id="enc2"),
    pytest.param((32, 512, 8, 8), BF16, ("cluster", 8), id="enc3"),
    pytest.param((32, 256, 16, 16), BF16, ("cluster", 8), id="dec0"),
    pytest.param((32, 128, 32, 32), BF16, ("cluster", 8), id="dec1"),
    pytest.param((32, 64, 64, 64), BF16, ("cluster", 8), id="dec2"),
    pytest.param((32, 64, 128, 128), BF16, ("generic", 0), id="dec3"),
    pytest.param((32, 64, 128, 128), FP32, ("generic", 0),
                 id="largest-fp32"),
    # ragged: k0 = min(8, 264 // 3, C = 5), one channel a CTA
    pytest.param((3, 5, 37, 53), FP32, ("cluster", 5), id="ragged"),
    pytest.param((2, 64, 32, 32), FP32, ("cluster", 8), id="canary"),
    pytest.param(tuple(_misaligned_view().shape), BF16, ("cluster", 8),
                 id="misaligned-view"),
    # one channel a CTA of 36852 bf16 values fills the 72 KiB budget with
    # its 24 bytes; one value more is over it
    pytest.param((1, 8, 1, 36852), BF16, ("cluster", 8), id="at-budget"),
    pytest.param((1, 8, 1, 36853), BF16, ("generic", 0),
                 id="one-value-over-budget"),
    # at B = 64, k0 = 264 // 64 = 4: 16 channels of 2 KiB fit a CTA, but
    # 8 KiB channels fit only 8 to a CTA, so k grows to 8
    pytest.param((64, 64, 32, 32), BF16, ("cluster", 4), id="B64"),
    pytest.param((64, 64, 64, 64), BF16, ("cluster", 8), id="B64-grows"),
])
def test_gn_path(shape, dtype, want):
    """``gn_path``'s rule (``betavae_gn_path`` states the same in C; a
    card test holds the two equal): the flagship's blocks but dec3 and the
    canary take clusters, a misaligned view too, and a sample one value
    over the shared-memory budget the generic path."""
    assert gn_path(shape, dtype) == want


def test_gn_path_rejects_other_dtypes():
    with pytest.raises(TypeError):
        gn_path((2, 8, 4, 4), torch.float16)


@pytest.mark.parametrize("b,c,splits", [(3, 5, 0), (32, 64, 0), (2, 7, 3)])
def test_output_views_have_the_callers_shapes_and_strides(b, c, splits):
    """pooled [B, C], m [B] and rstd [B] are views of the forward's one
    fp32 buffer at the offsets ``betavae_gn_fwd`` writes (pooled, then m,
    then rstd, then the generic path's stats scratch), and dγ, dβ [B, C]
    views of the backward's [2, B, C] buffer: contiguous, row-major, and
    apart."""
    size = (b * c + 2 * b if not splits
            else _partial_offset(b, c) + 2 * b * splits)
    buf = torch.arange(size, dtype=torch.float32)
    pooled, m, rstd = _stats_views(buf, b, c)
    assert (pooled.shape, pooled.stride()) == ((b, c), (c, 1))
    assert (m.shape, m.stride(), rstd.shape, rstd.stride()) == (
        (b,), (1,), (b,), (1,))
    assert [t.storage_offset() for t in (pooled, m, rstd)] == [
        0, b * c, b * c + b]
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               and t.untyped_storage().data_ptr()
               == buf.untyped_storage().data_ptr() for t in (pooled, m, rstd))
    assert float(pooled[b - 1, c - 1]) == b * c - 1
    assert _partial_offset(b, c) >= b * c + 2 * b
    assert _partial_offset(b, c) % 4 == 0      # 16-byte aligned float2s

    params = torch.arange(2 * b * c, dtype=torch.float32).view(2, b, c)
    dgamma, dbeta = _param_views(params)
    for t, offset in ((dgamma, 0), (dbeta, b * c)):
        assert (t.shape, t.stride(), t.storage_offset()) == (
            (b, c), (c, 1), offset)
        assert t.is_contiguous() and float(t[0, 0]) == offset
