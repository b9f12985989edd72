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
