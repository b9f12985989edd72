"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where no GPU is present.  The
file imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from betavae_tpu_torch.ops.elbo import (fused_reparam_kl, philox_normal,
                                        reparam_kl_forward,
                                        reparam_kl_reference)
from betavae_tpu_torch.ops.head import (fused_se_conv_head, head_conv_reference,
                                        head_forward, head_m, head_m_reference)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64), (65536, 64)])
def test_kernel_matches_plain_version(cuda_device, shape):
    """z and kl within 1e-5 relative of the plain version given the
    kernel's ε; ε within 1e-5 of the plain Philox + Box–Muller."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    mu = torch.randn(shape, generator=g, device=cuda_device)
    logvar = torch.randn(shape, generator=g, device=cuda_device).clamp(-10, 5)
    before = fused_reparam_kl.launches
    z, kl, eps = reparam_kl_forward(mu, logvar, 115, 7)
    torch.cuda.synchronize()
    assert fused_reparam_kl.launches == before + 1
    z_ref, kl_ref = reparam_kl_reference(mu, logvar, eps)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        eps, philox_normal(shape, 115, 7, device=cuda_device),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_gradients_match_plain_autograd(cuda_device):
    """The autograd Function's closed-form backward against autograd
    through the plain version with the kernel's ε: 1e-5 relative."""
    shape = (32, 64)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    mu = torch.randn(shape, generator=g, device=cuda_device)
    logvar = torch.randn(shape, generator=g, device=cuda_device).clamp(-10, 5)
    g_z = torch.randn(shape, generator=g, device=cuda_device)
    g_kl = torch.randn(shape, generator=g, device=cuda_device)
    _, _, eps = reparam_kl_forward(mu, logvar, 3, 0)

    mu_k, lv_k = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    zk, klk = fused_reparam_kl(mu_k, lv_k, 3, 0)
    ((zk * g_z).sum() + (klk * g_kl).sum()).backward()
    mu_p, lv_p = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    zp, klp = reparam_kl_reference(mu_p, lv_p, eps)
    ((zp * g_z).sum() + (klp * g_kl).sum()).backward()
    for got, want in ((mu_k.grad, mu_p.grad), (lv_k.grad, lv_p.grad)):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def _head_inputs(shape, dtype, device, seed=0):
    b, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(shape, generator=g, device=device).to(dtype)
    s = torch.rand(b, c, generator=g, device=device).to(dtype)
    k = torch.randn(c, 3, 3, generator=g, device=device)
    dy = torch.randn(b, h, w, generator=g, device=device)
    return y, s, k, dy


def _close(got, want):
    """1e-5 relative plus 1e-5 of the largest |value|: fp32 sums of the
    same products in another order."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.fixture
def no_tf32():
    """The plain forward is an fp32 cuDNN conv: keep TF32 out of it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,misaligned", [
    ((32, 64, 128, 128), torch.bfloat16, False),
    ((32, 64, 128, 128), torch.float32, False),
    ((3, 64, 37, 53), torch.float32, False),
    ((2, 5, 9, 130), torch.bfloat16, False),
    ((2, 6, 13, 136), torch.bfloat16, False),
    ((3, 5, 11, 132), torch.float32, False),
    ((2, 6, 13, 136), torch.bfloat16, True)])
def test_head_kernels_match_plain_versions(cuda_device, no_tf32, shape,
                                           dtype, misaligned):
    """Forward and M kernels against the plain versions computed in fp32
    from the same (bf16) values: the flagship shape, ragged ones, widths
    past one 128-column tile that do and do not allow 16-byte loads, and a
    contiguous y that does not start on a 16-byte boundary."""
    y, s, k, dy = _head_inputs(shape, dtype, cuda_device)
    if misaligned:
        flat = torch.empty(y.numel() + 1, dtype=dtype, device=cuda_device)
        y = flat[1:].view(shape).copy_(y)
        assert y.is_contiguous() and y.data_ptr() % 16 != 0
    fwd, m = head_forward.launches, head_m.launches
    out = head_forward(y, s, k)
    mm = head_m(y, dy)
    torch.cuda.synchronize()
    assert (head_forward.launches, head_m.launches) == (fwd + 1, m + 1)
    _close(out, head_conv_reference(y, s, k))
    _close(mm, head_m_reference(y, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_gradients_match_plain_autograd(cuda_device, no_tf32, dtype):
    """Gradients of y, s and k through the autograd Function against
    autograd through the plain version, in fp32."""
    y, s, k, dy = _head_inputs((4, 16, 33, 47), dtype, cuda_device, seed=2)
    yk, sk, kk = (t.clone().requires_grad_() for t in (y, s, k))
    (fused_se_conv_head(yk, sk, kk) * dy).sum().backward()
    yp, sp, kp = (t.float().clone().requires_grad_() for t in (y, s, k))
    (head_conv_reference(yp, sp, kp) * dy).sum().backward()
    assert (yk.grad.dtype, sk.grad.dtype) == (dtype, dtype)
    # dy_y and ds are rounded to the inputs' dtype once: compare them in
    # that dtype's precision; dk comes back fp32 from fp32 M: 1e-5 always
    assert kk.grad.dtype == torch.float32
    rounded = 1e-5 if dtype == torch.float32 else 2**-8
    for got, want, tol in ((yk.grad, yp.grad, rounded),
                           (sk.grad, sp.grad, rounded),
                           (kk.grad, kp.grad, 1e-5)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * scale)
