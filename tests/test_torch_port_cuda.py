"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where no GPU is present.  The
file imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

from pathlib import Path

import pytest
import torch
import yaml

from betavae_tpu_torch.ops.elbo import (fused_reparam_kl, philox_normal,
                                        reparam_kl_backward,
                                        reparam_kl_backward_reference,
                                        reparam_kl_forward,
                                        reparam_kl_reference)
from betavae_tpu_torch.ops.gn import _DTYPE_CODES as _GN_CODES
from betavae_tpu_torch.ops.gn import _backward_launch as _gn_backward_launch
from betavae_tpu_torch.ops.gn import _library as _gn_library
from betavae_tpu_torch.ops.gn import (fused_gn_relu_pool, gn_backward,
                                      gn_backward_reference, gn_forward,
                                      gn_forward_reference, gn_path,
                                      gn_relu_pool_reference)
from betavae_tpu_torch.ops.head import _library as _head_library
from betavae_tpu_torch.ops.head import (fused_se_conv_head, head_conv_reference,
                                        head_forward, head_m, head_m_reference,
                                        tma_path)
from betavae_tpu_torch.ops import upsample as _upsample
from betavae_tpu_torch.ops.upsample import (bilinear_upsample_x2,
                                            upsample2x_backward,
                                            upsample2x_backward_reference,
                                            upsample2x_forward,
                                            upsample2x_reference,
                                            upsample_path)
from betavae_tpu_torch.train.chunks import CAPTURE_WARMUP


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64), (65536, 64), (16, 16)])
def test_kernel_matches_plain_version(cuda_device, shape):
    """z and kl within 1e-5 relative of the plain version given the
    kernel's ε; ε bitwise the plain Philox + Box–Muller stream (the stream
    every earlier build of the kernel drew).  [16, 16] is the demo
    notebook's batch and latent."""
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
    assert torch.equal(eps, philox_normal(shape, 115, 7, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,world", [(16, 2), (8, 4)])
def test_kernel_start_draws_the_rows_of_the_whole_batch(cuda_device, rows,
                                                        world):
    """A data-parallel rank's launch with ``start = r·rows·64`` gives rows
    ``[r·rows, (r+1)·rows)`` of the whole batch's launch bitwise (ε, z and
    KL) and its ε is the plain Philox stream from ``start``; ``start = 0``
    is the launch without it, bitwise."""
    shape = (rows * world, 64)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    mu = torch.randn(shape, generator=g, device=cuda_device)
    logvar = torch.randn(shape, generator=g, device=cuda_device).clamp(-10, 5)
    full = reparam_kl_forward(mu, logvar, 115, 7)
    zero = reparam_kl_forward(mu, logvar, 115, 7, 0)
    assert all(torch.equal(a, b) for a, b in zip(full, zero))
    for r in range(world):
        sl = slice(r * rows, (r + 1) * rows)
        start = r * rows * 64
        part = reparam_kl_forward(mu[sl], logvar[sl], 115, 7, start)
        assert all(torch.equal(a, b[sl]) for a, b in zip(part, full))
        assert torch.equal(part[2], philox_normal(
            (rows, 64), 115, 7, device=cuda_device, start=start))
        z_ref, kl_ref = reparam_kl_reference(mu[sl], logvar[sl], part[2])
        torch.testing.assert_close(part[0], z_ref, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(part[1], kl_ref, rtol=1e-5, atol=1e-6)


def _close(got, want):
    """1e-5 relative plus 1e-5 of the largest |value|: fp32 sums of the
    same products in another order."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,broadcast", [
    ((32, 64), False), ((32, 64), True), ((65536, 64), False),
    ((3, 5, 7), False), ((16, 16), False)])
def test_backward_kernel_matches_closed_form(cuda_device, shape, broadcast):
    """The backward kernel against the plain closed form on the same
    residuals and gradients, one launch a call: contiguous gradients, a g_kl
    broadcast along the latent dim as capacity mode's per-sample sum hands
    it over (strides (1, 0), read in place), a large shape, and a 3-D one."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    mu, logvar, eps, g_z = (torch.randn(shape, generator=g, device=cuda_device)
                            for _ in range(4))
    logvar = logvar.clamp(-10, 5)
    if broadcast:
        g_kl = torch.randn(shape[0], 1, generator=g,
                           device=cuda_device).expand(shape)
        assert g_kl.stride() == (1, 0)
    else:
        g_kl = torch.randn(shape, generator=g, device=cuda_device)
    before = reparam_kl_backward.launches
    got = reparam_kl_backward(mu, logvar, eps, g_z, g_kl)
    torch.cuda.synchronize()
    assert reparam_kl_backward.launches == before + 1
    want = reparam_kl_backward_reference(mu, logvar, eps, g_z, g_kl)
    for a, b in zip(got, want):
        assert a.shape == b.shape == shape
        _close(a, b)


@pytest.mark.cuda
def test_kernel_gradients_match_plain_autograd(cuda_device):
    """The autograd Function (forward and backward kernels) against
    autograd through the plain version with the kernel's ε: 1e-5 relative
    of the gradient's scale, one launch of each kernel."""
    shape = (32, 64)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    mu = torch.randn(shape, generator=g, device=cuda_device)
    logvar = torch.randn(shape, generator=g, device=cuda_device).clamp(-10, 5)
    g_z = torch.randn(shape, generator=g, device=cuda_device)
    g_kl = torch.randn(shape, generator=g, device=cuda_device)
    _, _, eps = reparam_kl_forward(mu, logvar, 3, 0)

    before = (fused_reparam_kl.launches, reparam_kl_backward.launches)
    mu_k, lv_k = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    zk, klk = fused_reparam_kl(mu_k, lv_k, 3, 0)
    ((zk * g_z).sum() + (klk * g_kl).sum()).backward()
    assert (fused_reparam_kl.launches, reparam_kl_backward.launches) == (
        before[0] + 1, before[1] + 1)
    mu_p, lv_p = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
    zp, klp = reparam_kl_reference(mu_p, lv_p, eps)
    ((zp * g_z).sum() + (klp * g_kl).sum()).backward()
    for got, want in ((mu_k.grad, mu_p.grad), (lv_k.grad, lv_p.grad)):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
def test_forward_waits_for_the_kernel_that_writes_its_inputs(cuda_device):
    """The race check of programmatic dependent launch: 1000 times, two
    kernels write μ and logσ² in place (the second a reduction, the
    forward's immediate predecessor, as the logvar clamp is in the model),
    the forward follows on the same stream, and copies of μ and logσ² are
    taken after it.  Every z and kl equals the plain version on the copied inputs and
    the kernel's ε; a forward that read before the writer finished would
    see the previous iteration's values."""
    shape, iters = (32, 64), 1000
    g = torch.Generator(device=cuda_device).manual_seed(7)
    mu_src = torch.randn((iters, *shape), generator=g, device=cuda_device)
    lv_src = 0.1 * torch.randn((iters, 16, *shape), generator=g,
                               device=cuda_device)
    mu = torch.empty(shape, device=cuda_device)
    logvar = torch.empty(shape, device=cuda_device)
    outs, seen = [], []
    for i in range(iters):
        torch.neg(mu_src[i], out=mu)
        torch.sum(lv_src[i], dim=0, out=logvar)
        outs.append(reparam_kl_forward(mu, logvar, 5, i))
        seen.append((mu.clone(), logvar.clone()))
    torch.cuda.synchronize()
    z = torch.stack([o[0] for o in outs])
    kl = torch.stack([o[1] for o in outs])
    eps = torch.stack([o[2] for o in outs])
    mus = torch.stack([m for m, _ in seen])
    lvs = torch.stack([lv for _, lv in seen])
    z_ref, kl_ref = reparam_kl_reference(mus, lvs, eps)
    assert torch.equal(mus, -mu_src)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_one_forward_and_one_backward_launch_per_train_step(cuda_device,
                                                            tmp_path):
    """Three steps of a small flagship-shaped config (capacity objective,
    FFL) through ``train_steps``, replays of a captured step: each launches
    the forward kernel once and the backward kernel once, and so does each
    of the warm-up steps run before the capture."""
    from betavae_tpu_torch.config import reset_config_cache
    from betavae_tpu_torch.data.demo import generate_demo_data
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    root = Path(__file__).resolve().parent.parent
    cfg = yaml.safe_load(open(root / "configs" / "beta_vae_se.yaml"))
    cfg["paths"].update(processed_dir=str(tmp_path / "processed"),
                        outputs_dir=str(tmp_path / "outputs"))
    cfg["data"]["image_size"] = 32
    cfg["model"].update(base_channels=8, latent_dim=8, num_blocks=2)
    cfg["training"]["batch_size"] = 8
    cfg["logging"].update(log_to_file=False, log_every_n_steps=100)
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    generate_demo_data(tmp_path / "processed", train_per_class=4,
                       test_per_class=1, size=32)
    fused_reparam_kl.launches = reparam_kl_backward.launches = 0
    reset_config_cache()
    reset_logger()
    try:
        out = train_steps(str(path), 3, device="cuda")
    finally:
        reset_logger()
        reset_config_cache()
    assert out["steps"] == 3 and out["dispatch"] == "cuda_graph"
    assert out["launches_per_replay"]["fused_reparam_kl"] == out[
        "launches_per_replay"]["reparam_kl_backward"] == 1
    assert (fused_reparam_kl.launches, reparam_kl_backward.launches) == (
        3 + CAPTURE_WARMUP, 3 + CAPTURE_WARMUP)


def _head_inputs(shape, dtype, device, seed=0):
    b, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(shape, generator=g, device=device).to(dtype)
    s = torch.rand(b, c, generator=g, device=device).to(dtype)
    k = torch.randn(c, 3, 3, generator=g, device=device)
    dy = torch.randn(b, h, w, generator=g, device=device)
    return y, s, k, dy


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
    ((2, 6, 13, 136), torch.bfloat16, True),
    # the TMA path's edges: H at a 32-row band and one either side
    ((2, 8, 31, 128), torch.bfloat16, False),
    ((2, 8, 32, 128), torch.float32, False),
    ((2, 8, 33, 128), torch.bfloat16, False),
    # one work item (fewer than the SMs), and more than one sweep of the
    # persistent grid (320 forward and 640 M items)
    ((1, 3, 16, 128), torch.bfloat16, False),
    ((40, 64, 256, 128), torch.bfloat16, False),
    # a row of exactly 16 bytes, rows either side of the 16-byte rule
    # (bf16 136 and 128 values: TMA; 132 and 130: generic; fp32 260: TMA
    # over three column tiles; 6: generic), and C not a multiple of a
    # stage's channel group (4 bf16, 2 fp32)
    ((2, 5, 9, 8), torch.bfloat16, False),
    ((2, 3, 9, 4), torch.float32, False),
    ((2, 5, 20, 136), torch.bfloat16, False),
    ((2, 5, 20, 132), torch.bfloat16, False),
    ((2, 3, 20, 260), torch.float32, False),
    ((2, 3, 20, 6), torch.float32, False),
    ((3, 7, 33, 64), torch.float32, False)])
def test_head_kernels_match_plain_versions(cuda_device, no_tf32, shape,
                                           dtype, misaligned):
    """Forward and M kernels against the plain versions computed in fp32
    from the same (bf16) values: the flagship shape, ragged ones, widths
    past one 128-column tile that do and do not allow 16-byte loads, a
    contiguous y that does not start on a 16-byte boundary, and the TMA
    path's edges (band height, item count, row bytes, channel group)."""
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
@pytest.mark.parametrize("shape,dtype,misaligned,tma", [
    ((32, 64, 128, 128), torch.bfloat16, False, True),
    ((32, 64, 128, 128), torch.float32, False, True),
    ((3, 64, 37, 53), torch.float32, False, False),
    ((2, 6, 13, 136), torch.bfloat16, True, False),
    ((2, 5, 20, 130), torch.bfloat16, False, False)])
def test_head_kernels_take_the_path_their_rows_allow(cuda_device, shape,
                                                     dtype, misaligned, tma):
    """The flagship's y takes the TMA path in both dtypes, misaligned and
    ragged rows the generic one: the wrapper's per-path launch counts say
    so, and its rule is the library's."""
    y, s, k, dy = _head_inputs(shape, dtype, cuda_device)
    if misaligned:
        flat = torch.empty(y.numel() + 1, dtype=dtype, device=cuda_device)
        y = flat[1:].view(shape).copy_(y)
    path = "tma" if tma else "generic"
    fwd, m = (dict(f.launches_by_path) for f in (head_forward, head_m))
    head_forward(y, s, k)
    head_m(y, dy)
    torch.cuda.synchronize()
    for wrapper, before in ((head_forward, fwd), (head_m, m)):
        after = dict(before, **{path: before[path] + 1})
        assert wrapper.launches_by_path == after
    lib = _head_library()
    code = 1 if dtype == torch.bfloat16 else 0
    assert tma_path(y) == tma_path(y, dy) == tma
    assert lib.betavae_head_tma_path(y.data_ptr(), None, shape[3], code) == tma
    assert lib.betavae_head_tma_path(y.data_ptr(), dy.data_ptr(), shape[3],
                                     code) == tma


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((32, 64, 128, 128), torch.bfloat16), ((32, 64, 128, 128), torch.float32),
    ((3, 64, 37, 53), torch.float32), ((40, 64, 256, 128), torch.bfloat16)])
def test_head_kernels_give_the_same_bits_twice(cuda_device, shape, dtype):
    """Two launches of each kernel give equal bits: fixed summation order,
    no atomics, on both paths and over more than one sweep of the grid."""
    y, s, k, dy = _head_inputs(shape, dtype, cuda_device, seed=5)
    first = (head_forward(y, s, k), head_m(y, dy))
    second = (head_forward(y, s, k), head_m(y, dy))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _gn_inputs(shape, dtype, device, seed=0):
    b, c, _, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = (2.0 * torch.randn(shape, generator=g, device=device) + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g, device=device)
    beta = 0.1 * torch.randn(c, generator=g, device=device)
    gy = torch.randn(shape, generator=g, device=device).to(dtype)
    gp = torch.randn(b, c, generator=g, device=device)
    return x, gamma, beta, gy, gp


def _close_in(got, want, dtype):
    """fp32: 1e-5 relative plus 1e-5 of the largest |value| (fp32 sums in
    another order); a bf16 result also carries one bf16 rounding, 2⁻⁸."""
    tol = 1e-5 if dtype == torch.float32 else 2**-8
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,misaligned,path", [
    # flagship blocks: enc0/dec2, enc1/dec1, enc2/dec0, enc3 (cluster of
    # 4), dec3 (generic), the largest in fp32 (generic)
    ((32, 64, 64, 64), torch.bfloat16, False, "cluster"),
    ((32, 128, 32, 32), torch.bfloat16, False, "cluster"),
    ((32, 256, 16, 16), torch.bfloat16, False, "cluster"),
    ((32, 512, 8, 8), torch.bfloat16, False, "cluster"),
    ((32, 64, 128, 128), torch.bfloat16, False, "generic"),
    ((4, 64, 128, 128), torch.float32, False, "generic"),
    # the bench canary's fp32 sample, a cluster of 8
    ((2, 64, 32, 32), torch.float32, False, "cluster"),
    # ragged planes (one value a unit), with and without 16-byte rows
    ((3, 5, 37, 53), torch.float32, False, "cluster"),
    ((2, 6, 9, 130), torch.bfloat16, False, "cluster"),
    ((2, 8, 64, 66), torch.bfloat16, False, "cluster"),
    # a contiguous x that does not start on a 16-byte boundary, both paths
    ((2, 8, 64, 66), torch.bfloat16, True, "cluster"),
    ((2, 6, 16, 16), torch.float32, True, "cluster"),
    ((3, 64, 128, 128), torch.bfloat16, True, "generic"),
    # C not a multiple of k (13 channels over 8 CTAs), B = 1, B = 33
    ((2, 13, 16, 16), torch.bfloat16, False, "cluster"),
    ((1, 64, 32, 32), torch.float32, False, "cluster"),
    ((33, 128, 32, 32), torch.bfloat16, False, "cluster")])
def test_gn_kernels_match_plain_versions(cuda_device, shape, dtype,
                                         misaligned, path):
    """Forward (y, pooled, m, rstd) and backward (dx, per-sample dγ and
    dβ, from the kernel's own m and rstd) against the plain versions on
    both paths: flagship block shapes, the canary's, ragged planes, a
    contiguous x that does not start on a 16-byte boundary, channels split
    unevenly over a cluster, B = 1 and B = 33.  Each call launches once,
    the backward on the path :func:`gn_path` names and the forward on the
    generic one, and two launches give the same bits."""
    _check_gn_against_plain(cuda_device, shape, dtype, misaligned, path)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,path", [
    ((256, 64, 128, 128), ("generic", 0)),       # enc0, dec3
    ((256, 128, 64, 64), ("generic", 0)),        # enc1, dec2
    ((256, 256, 32, 32), ("cluster", 8)),        # enc2, dec1
    ((256, 512, 16, 16), ("cluster", 4)),        # enc3, dec0
    ((256, 1024, 8, 8), ("cluster", 3)),         # enc4
    ((256, 64, 256, 256), ("generic", 0))],      # dec4
    ids=["enc0-dec3", "enc1-dec2", "enc2-dec1", "enc3-dec0", "enc4", "dec4"])
def test_gn_kernels_match_plain_versions_at_the_scaled_blocks(cuda_device,
                                                              shape, path):
    """The scaled configuration's 10 blocks (256 px, base 64, 5 blocks) at
    its batch of 256 in bf16, 6 shapes: each block's conv output takes the
    path named, and the kernels hold the plain versions both ways, as at
    the flagship's shapes."""
    assert gn_path(shape, torch.bfloat16) == path
    _check_gn_against_plain(cuda_device, shape, torch.bfloat16, False,
                            path[0])


def _check_gn_against_plain(cuda_device, shape, dtype, misaligned, path):
    x, gamma, beta, gy, gp = _gn_inputs(shape, dtype, cuda_device)
    if misaligned:
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
        x = flat[1:].view(shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert gn_path(shape, dtype)[0] == path
    fwd, bwd = (dict(f.launches_by_path) for f in (gn_forward, gn_backward))
    n_fwd, n_bwd = gn_forward.launches, gn_backward.launches
    y, pooled, m, rstd = gn_forward(x, gamma, beta)
    dx, dgamma, dbeta = gn_backward(x, gamma, beta, m, rstd, gy, gp)
    torch.cuda.synchronize()
    assert (gn_forward.launches, gn_backward.launches) == (n_fwd + 1,
                                                           n_bwd + 1)
    assert gn_forward.launches_by_path == {"generic": fwd["generic"] + 1}
    assert gn_backward.launches_by_path == dict(bwd,
                                                **{path: bwd[path] + 1})
    assert (y.dtype, dx.dtype, pooled.dtype) == (dtype, dtype, torch.float32)
    y_ref, pooled_ref, m_ref, rstd_ref = gn_forward_reference(x, gamma, beta)
    _close_in(y, y_ref, dtype)
    # pooled is the mean of the y it comes back with: against the plain
    # version's it carries y's rounding (a bf16 y may differ by one
    # rounding where the two sets of statistics differ in their last bit)
    _close_in(pooled, y.float().mean(dim=(2, 3)), torch.float32)
    _close_in(pooled, pooled_ref, dtype)
    for got, want in ((m, m_ref), (rstd, rstd_ref)):
        _close_in(got, want, torch.float32)
    dx_ref, dgamma_ref, dbeta_ref = gn_backward_reference(
        x, gamma, beta, m, rstd, gy, gp)
    _close_in(dx, dx_ref, dtype)
    _close_in(dgamma, dgamma_ref, torch.float32)
    _close_in(dbeta, dbeta_ref, torch.float32)
    again = gn_forward(x, gamma, beta) + gn_backward(x, gamma, beta, m, rstd,
                                                     gy, gp)
    for first, second in zip((y, pooled, m, rstd, dx, dgamma, dbeta), again):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((32, 64, 64, 64), torch.bfloat16), ((32, 512, 8, 8), torch.bfloat16),
    ((32, 64, 128, 128), torch.bfloat16), ((256, 1024, 8, 8), torch.bfloat16),
    ((256, 64, 256, 256), torch.bfloat16), ((3, 5, 37, 53), torch.float32),
    ((2, 64, 32, 32), torch.float32), ((3, 4, 8, 8), torch.float32)])
def test_gn_forward_is_pytorchs_groupnorm_bit_for_bit(cuda_device, shape,
                                                      dtype):
    """The kernels' m and rstd are PyTorch's GroupNorm's on the card
    (``native_group_norm`` over the fp32 values, as autocast runs it), and
    y is the ReLU of its output rounded to x's dtype, bit for bit: both
    paths, the flagship's and the scaled config's blocks, a ragged plane,
    and a sample of under 512 values (a warp of chains)."""
    x, gamma, beta, _, _ = _gn_inputs(shape, dtype, cuda_device)
    y, _, m, rstd = gn_forward(x, gamma, beta)
    b, c, h, w = shape
    out, m_t, r_t = torch.ops.aten.native_group_norm(
        x.float(), gamma, beta, b, c, h * w, 1, 1e-6)
    assert torch.equal(m, m_t.view(-1)) and torch.equal(rstd, r_t.view(-1))
    assert torch.equal(y, torch.relu(out.to(dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((32, 64, 64, 64), torch.bfloat16), ((32, 128, 32, 32), torch.bfloat16),
    ((32, 256, 16, 16), torch.bfloat16), ((32, 512, 8, 8), torch.bfloat16),
    ((32, 64, 128, 128), torch.bfloat16), ((32, 64, 128, 128), torch.float32),
    ((3, 5, 37, 53), torch.float32), ((2, 64, 32, 32), torch.float32),
    ((2, 8, 64, 66), torch.bfloat16),
    ((1, 8, 1, 36852), torch.bfloat16), ((1, 8, 1, 36853), torch.bfloat16),
    ((64, 64, 32, 32), torch.bfloat16), ((64, 64, 64, 64), torch.bfloat16),
    ((33, 128, 32, 32), torch.bfloat16), ((2, 13, 16, 16), torch.bfloat16)])
def test_gn_path_rule_is_the_librarys(cuda_device, shape, dtype):
    """``gn_path`` and ``betavae_gn_path`` state one rule: k for a cluster
    path, -1 for the generic one."""
    kind, n = gn_path(shape, dtype)
    want = n if kind == "cluster" else -1
    assert _gn_library().betavae_gn_path(*shape, _GN_CODES[dtype]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 17, 65])
def test_gn_refused_cluster_launch_raises(cuda_device, k):
    """A backward cluster launch the library does not take raises and
    never falls back to the generic path: at [2, 64, 32, 32] fp32, one CTA
    would hold the whole 256 KiB sample (over budget), 17 CTAs pass the
    launch's 16, 65 pass the 64 channels."""
    x, gamma, beta, gy, gp = _gn_inputs((2, 64, 32, 32), torch.float32,
                                        cuda_device)
    _, _, m, rstd = gn_forward(x, gamma, beta)
    before = dict(gn_backward.launches_by_path)
    with pytest.raises(RuntimeError, match="GN backward kernel launch"):
        _gn_backward_launch(x, gamma, beta, m, rstd, gy, gp, 0,
                            ("cluster", k))
    assert gn_backward.launches_by_path == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_gradients_match_plain_autograd(cuda_device, dtype):
    """Gradients of x, γ and β through both outputs of the autograd
    Function (the backward kernels) against autograd through the plain
    version, y passed on in x's dtype and pooled its mean, as the blocks
    use them (so autograd sums y's two gradients in x's dtype, as the
    kernels do); dx is rounded once to x's dtype."""
    x, gamma, beta, gy, gp = _gn_inputs((4, 16, 33, 47), dtype, cuda_device,
                                        seed=3)

    def plain(xg, gg, bg):
        y = gn_relu_pool_reference(xg, gg, bg)[0].to(xg.dtype)
        return y, y.float().mean(dim=(2, 3))

    def grads(fn):
        xg, gg, bg = (t.clone().requires_grad_() for t in (x, gamma, beta))
        y, pooled = fn(xg, gg, bg)
        ((y.float() * gy.float()).sum() + (pooled * gp).sum()).backward()
        return xg.grad, gg.grad, bg.grad

    before = gn_backward.launches
    got = grads(fused_gn_relu_pool)
    assert gn_backward.launches == before + 1
    want = grads(plain)
    assert got[0].dtype == dtype
    _close_in(got[0], want[0], dtype)
    _close_in(got[1], want[1], torch.float32)
    _close_in(got[2], want[2], torch.float32)


@pytest.mark.cuda
def test_checkpoint_pull_holds_the_state_at_save_time(cuda_device):
    """A snapshot's pull to the host (a side stream into pinned memory),
    started after the training stream has queued in-place changes to the
    originals, gives the values at the snapshot's take."""
    from betavae_tpu_torch.train.callbacks import StateSnapshot, _pull_finish
    from betavae_tpu_torch.train.optim import build_optimizer

    torch.manual_seed(0)
    model = torch.nn.Linear(1024, 4096).to(cuda_device)
    optimizer = build_optimizer(model.parameters())
    want = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    snap = StateSnapshot(model, optimizer)
    snap.take()
    with torch.no_grad():
        for _ in range(20):               # queued after the take
            for p in model.parameters():
                p.mul_(-3.0).add_(1.0)
    got = _pull_finish(*snap.pull())["model_state"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(torch.from_numpy(got[k]), v), k


@pytest.mark.cuda
def test_sampling_on_the_card_equals_the_cpu(cuda_device, no_tf32):
    """``sample_forward`` and ``sample_prior`` of a small fp32 model with
    the fused head: the card (reparam+KL forward and head forward kernels)
    equals the CPU (their plain versions) to 1e-5, ε bitwise the same
    Philox stream, and each call launches the kernels."""
    import copy

    from betavae_tpu_torch.models.beta_vae import (BetaVAEModule,
                                                   init_weights,
                                                   sample_forward)

    cpu = BetaVAEModule(image_size=32, in_channels=1, latent_dim=8,
                        base_channels=8, num_blocks=2, se_reduction=2,
                        fused_head=True)
    init_weights(cpu, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda_device)
    x = torch.rand(5, 1, 32, 32, generator=torch.Generator().manual_seed(1))
    fused_reparam_kl.launches = head_forward.launches = 0
    got = sample_forward(gpu, x.to(cuda_device), seed=9, offset=4)
    want = sample_forward(cpu, x, seed=9, offset=4)
    assert (fused_reparam_kl.launches, head_forward.launches) == (1, 1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
    eps = philox_normal(want[1].shape, 9, 4)
    torch.testing.assert_close(got[3].cpu(), reparam_kl_reference(
        got[1].cpu(), got[2].cpu(), eps)[0], rtol=1e-5, atol=1e-6)
    prior = gpu.sample_prior(6, 11)
    assert (fused_reparam_kl.launches, head_forward.launches) == (2, 2)
    torch.testing.assert_close(prior.cpu(), cpu.sample_prior(6, 11),
                               rtol=1e-5, atol=1e-5)


def _small_flagship(tmp_path, **training) -> str:
    """The flagship config cut to 32 px, 2 blocks, base 8, latent 8, batch
    8, fused head, over seeded demo data, with ``training`` overrides."""
    from betavae_tpu_torch.data.demo import generate_demo_data

    root = Path(__file__).resolve().parent.parent
    cfg = yaml.safe_load(open(root / "configs" / "beta_vae_se.yaml"))
    cfg["paths"].update(processed_dir=str(tmp_path / "processed"),
                        outputs_dir=str(tmp_path / "outputs"))
    cfg["data"]["image_size"] = 32
    cfg["model"].update(base_channels=8, latent_dim=8, num_blocks=2)
    cfg["training"].update(batch_size=8, fused_head=True, **training)
    cfg["logging"].update(log_to_file=False, log_every_n_steps=100)
    name = "_".join(f"{k}-{v}" for k, v in training.items()) or "base"
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    if not (tmp_path / "processed").exists():
        generate_demo_data(tmp_path / "processed", train_per_class=8,
                           test_per_class=1, size=32)
    return str(path)


def _few_steps(path: str, steps: int) -> list:
    from betavae_tpu_torch.config import reset_config_cache
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.train.loop import train_steps

    reset_config_cache()
    reset_logger()
    try:
        return train_steps(path, steps, device="cuda")["totals"]
    finally:
        reset_logger()
        reset_config_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [16, 1])
def test_host_feed_on_the_card_gives_the_resident_batches(cuda_device,
                                                          tmp_path, depth):
    """A split fed from the host (``depth`` batches an upload, gathered
    into one of two pinned buffers and copied to the static device buffer
    in one copy, queued behind the gathers of the last upload): every
    batch of two epochs bitwise the one the resident split gathers; and a
    few steps of the trainer fed so (replays of the captured step): the
    first step's total bitwise the resident split's.  (A rerun's later
    steps are held by ``test_train_steps_replay_bitwise_on_the_card``.)"""
    import numpy as np

    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.data.dataset import load_split
    from betavae_tpu_torch.data.pipeline import (BatchPlan, DeviceData,
                                                 gather_batch)

    path = _small_flagship(tmp_path)
    reset_config_cache()
    try:
        get_config(path)
        ds = load_split("train")
    finally:
        reset_config_cache()
    host = DeviceData.from_dataset(ds, cuda_device, max_device_bytes=0,
                                   depth=depth)
    resident = DeviceData.from_dataset(ds, cuda_device)
    plan = [idx for epoch in (1, 2) for idx, _ in
            BatchPlan(len(ds), 4, shuffle=True, seed=0).batches(epoch)]
    source = host.source(4)

    def on_card(idx):
        return torch.from_numpy(np.asarray(idx, np.int64)).to(cuda_device)

    equal = torch.zeros((), dtype=torch.int64, device=cuda_device)
    for at in range(0, len(plan), depth):
        part = plan[at:at + depth]
        for i, j in zip(host.stage(part), part):
            equal += (gather_batch(source, on_card(i))
                      == gather_batch(resident.images, on_card(j))).all()
    assert host.host_feed and int(equal) == len(plan)

    device_fed = _few_steps(path, 2)
    host_fed = _few_steps(_small_flagship(
        tmp_path, max_device_dataset_mb=0,
        host_feed_chunk_mb=32 * 32 * 8 * depth / 2**20), 2)
    assert host_fed[0] == device_fed[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["decoder", True])
def test_remat_on_the_card_under_bf16(cuda_device, tmp_path, mode):
    """``training.remat`` with bf16 autocast and the fused head on the
    card: the first total bitwise the no-remat one (the forward does not
    change) and the launches of a step unchanged (reparam+KL forward and
    backward, head forward and M, once each, in the 4 steps and in the
    warm-up steps before the capture)."""
    wrappers = (fused_reparam_kl, reparam_kl_backward, head_forward, head_m)
    runs = []
    for remat in (False, mode):
        for w in wrappers:
            w.launches = 0
        runs.append(_few_steps(_small_flagship(
            tmp_path, mixed_precision=True, remat=remat), 4))
        assert [w.launches for w in wrappers] == [4 + CAPTURE_WARMUP] * 4
    assert runs[1][0] == runs[0][0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["decoder", True])
def test_remat_gradients_on_the_card(cuda_device, tmp_path, mode):
    """One backward from the same weights and batch, fp32 with TF32 off
    (a backward's own run-to-run spread stays near 1e-7 there): the loss
    bitwise and the gradients within 1e-5 relative (norm over every
    parameter) of the no-remat backward's."""
    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.models.beta_vae import (model_from_config,
                                                   resolve_remat)
    from betavae_tpu_torch.models.losses import loss_spec_from_config
    from betavae_tpu_torch.train.step import _forward_losses

    reset_config_cache()
    try:
        cfg = get_config(_small_flagship(tmp_path, mixed_precision=False))
        model = model_from_config(cfg).train()
        spec = loss_spec_from_config(cfg)
    finally:
        reset_config_cache()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((8, 1, 32, 32), generator=g, device=cuda_device)
    mask = torch.ones(8, device=cuda_device)
    sched = {"beta": 1.0, "capacity": 30.0, "capacity_weight": 1.0,
             "free_bits": 0.0, "lr": 5e-4}
    runs = []
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for remat in (False, mode):
            model.remat = resolve_remat(remat)
            model.zero_grad(set_to_none=True)
            losses = _forward_losses(model, x, mask, sched, spec=spec,
                                     use_capacity=True, seed=1, offset=1)
            losses["total"].backward()
            runs.append((losses["total"].detach(), torch.cat(
                [p.grad.flatten() for p in model.parameters()])))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    (loss0, grad0), (loss1, grad1) = runs
    assert torch.equal(loss1, loss0)
    assert float((grad1 - grad0).norm() / grad0.norm()) <= 1e-5


# ---------------------------------------------------------------------------
# the ×2 upsample
# ---------------------------------------------------------------------------

def _paths(wrapper) -> dict:
    return dict(wrapper.launches_by_path)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,path", [
    ((32, 512, 8, 8), torch.bfloat16, "vector"),
    ((32, 64, 64, 64), torch.bfloat16, "vector"),
    ((32, 256, 16, 16), torch.float32, "vector"),
    ((3, 5, 37, 53), torch.float32, "generic"),
    ((3, 5, 37, 53), torch.bfloat16, "generic"),
    ((2, 3, 1, 1), torch.float32, "generic"),
    ((2, 3, 5, 16), torch.bfloat16, "vector"),
    ((3, 2, 7, 8), torch.float32, "vector"),
    ((1, 2, 3, 256), torch.bfloat16, "vector"),
    ((1, 2, 3, 24), torch.bfloat16, "generic"),
    ((16, 64, 8, 8), torch.float32, "vector"),
    ((16, 32, 16, 16), torch.float32, "vector"),
    ((16, 16, 32, 32), torch.float32, "vector")])
def test_upsample_kernels_match_plain_versions(cuda_device, shape, dtype,
                                               path):
    """Forward and gather backward bitwise their plain versions on the
    path the rule gives and on each path forced (the vector path where the
    rule allows it, else the kernel refuses it), each launch counted once
    and on its path, two launches bitwise equal (the backward has no
    atomics), and the autograd Function's value and gradient the
    kernels'.  The small vector shapes have a partial last band, rows of
    one 16-byte unit and a row of a whole warp; the last three are the
    demo notebook's decoder inputs (``configs/demo_notebook.yaml``: B 16,
    fp32)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, c, h, w = shape
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn((b, c, 2 * h, 2 * w), generator=g,
                     device=cuda_device).to(dtype)
    assert upsample_path(shape, dtype, 16) == path
    before = (_paths(upsample2x_forward), _paths(upsample2x_backward))
    y, dx = upsample2x_forward(x), upsample2x_backward(dy)
    torch.cuda.synchronize()
    for wrapper, was in zip((upsample2x_forward, upsample2x_backward),
                            before):
        assert {k: v - was[k] for k, v in _paths(wrapper).items()} == {
            p: int(p == path) for p in ("vector", "generic")}
    want_y, want_dx = upsample2x_reference(x), upsample2x_backward_reference(dy)
    for got, want in ((y, want_y), (dx, want_dx)):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert torch.equal(y, upsample2x_forward(x))
    assert torch.equal(dx, upsample2x_backward(dy))
    for forced in ("vector", "generic"):
        if forced == "vector" and path != "vector":
            with pytest.raises(RuntimeError, match="vector path"):
                _upsample._launch(x, backward=False, path=forced)
            continue
        assert torch.equal(_upsample._launch(x, False, forced), want_y)
        assert torch.equal(_upsample._launch(dy, True, forced), want_dx)
    xr = x.clone().requires_grad_()
    yr = bilinear_upsample_x2(xr)
    yr.backward(dy)
    assert torch.equal(yr, y) and torch.equal(xr.grad, dx)


@pytest.mark.cuda
def test_upsample_path_rule_is_the_kernels(cuda_device):
    """``upsample_path`` and ``betavae_upsample_path`` in
    ``csrc/upsample.cu`` agree over shapes, dtypes and alignments."""
    lib = _upsample._library()
    for shape in ((32, 512, 8, 8), (256, 64, 128, 128), (3, 5, 37, 53),
                  (2, 3, 5, 24), (1, 1, 1, 4), (1, 1, 2, 8), (2, 3, 1, 1),
                  (1, 2, 3, 256), (1, 2, 3, 512), (2**15, 2**10, 64, 64)):
        b, c, h, w = shape
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for align in (2, 4, 8, 16, 32):
                want = upsample_path(shape, dtype, align) == "vector"
                assert lib.betavae_upsample_path(b * c, h, w, code,
                                                 align) == int(want)


@pytest.mark.cuda
def test_upsample_misaligned_input_takes_the_generic_path(cuda_device):
    """A bf16 x one value past a 16-byte boundary: the generic path,
    bitwise the plain version."""
    shape = (2, 4, 8, 16)
    n = 2 * 4 * 8 * 16
    x = torch.randn(n + 1, device=cuda_device).to(torch.bfloat16)[1:]
    x = x.view(shape)
    was = _paths(upsample2x_forward)
    y = upsample2x_forward(x)
    assert _paths(upsample2x_forward)["generic"] == was["generic"] + 1
    assert torch.equal(y, upsample2x_reference(x))


@pytest.mark.cuda
def test_upsample_kernels_refuse_other_dtypes(cuda_device):
    x = torch.zeros((1, 1, 4, 4), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upsample2x_forward(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upsample2x_backward(torch.zeros((1, 1, 8, 8), dtype=torch.float16,
                                        device=cuda_device))


@pytest.mark.cuda
def test_train_steps_replay_bitwise_on_the_card(cuda_device, tmp_path):
    """Four bf16 steps of the small flagship-shaped config with the fused
    head, twice from the same seed: every total bitwise equal, and the
    upsample kernels launched once a decoder block a step each way (the
    warm-up steps before the capture too)."""
    path = _small_flagship(tmp_path, mixed_precision=True)
    runs = []
    for _ in range(2):
        upsample2x_forward.launches = upsample2x_backward.launches = 0
        runs.append(_few_steps(path, 4))
        assert (upsample2x_forward.launches,
                upsample2x_backward.launches) == (
                    2 * (4 + CAPTURE_WARMUP), 2 * (4 + CAPTURE_WARMUP))
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_fp32_train_steps_replay_bitwise_on_the_card(cuda_device, tmp_path):
    """Four fp32 steps (TF32 off) of the small flagship-shaped config with
    the fused head, twice from the same seed: every total bitwise equal
    (the trainer runs cuDNN's deterministic algorithms), and the cuDNN
    flags as they were after each run."""
    path = _small_flagship(tmp_path, mixed_precision=False)
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.enabled,
             cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = [_few_steps(path, 4) for _ in range(2)]
        assert (cudnn.deterministic, cudnn.benchmark,
                cudnn.enabled) == flags[:3]
    finally:
        cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags[3:]
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_device_offset_kernel_replayed_in_a_graph_draws_each_offset(
        cuda_device):
    """The forward, its offset in device memory, captured once in a CUDA
    graph and replayed with 3 offsets written there: each replay's ε is
    bitwise the plain Philox stream at its offset (an offset fixed at the
    capture would repeat the capture's), z and KL within 1e-5 of the plain
    version given that ε, with and without programmatic dependent launch;
    an int offset, written to device memory by the wrapper, draws bitwise
    the same as the tensor."""
    from betavae_tpu_torch.ops.elbo import _launch

    g = torch.Generator(device=cuda_device).manual_seed(4)
    mu = torch.randn((32, 64), generator=g, device=cuda_device)
    logvar = torch.randn((32, 64), generator=g,
                         device=cuda_device).clamp(-10, 5)
    for pdl in (True, False):
        offset = torch.zeros((), dtype=torch.int64, device=cuda_device)
        _launch(mu, logvar, 115, offset, pdl)          # load the module
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            z, kl, eps = _launch(mu, logvar, 115, offset, pdl)
        for off in (3, 2**31 + 7, 2**40 + 1):
            offset.fill_(off)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(eps, philox_normal((32, 64), 115, off,
                                                  device=cuda_device))
            z_ref, kl_ref = reparam_kl_reference(mu, logvar, eps)
            torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(kl, kl_ref, rtol=1e-5, atol=1e-6)
            for got, want in zip(_launch(mu, logvar, 115, off, pdl),
                                 (z, kl, eps)):
                assert torch.equal(got, want)


def _chunk_flagship(tmp_path, k: int) -> str:
    """``_small_flagship`` with 8 steps an epoch (64 train images) and
    ``scan_chunk_steps`` ``k``, under ``tmp_path/k<k>``."""
    from betavae_tpu_torch.data.demo import generate_demo_data

    data = tmp_path / "chunk_data"
    if not data.exists():
        generate_demo_data(data, train_per_class=16, test_per_class=1,
                           size=32)
    (tmp_path / f"k{k}").mkdir(exist_ok=True)
    path = Path(_small_flagship(tmp_path / f"k{k}", scan_chunk_steps=k))
    cfg = yaml.safe_load(path.read_text())
    cfg["paths"]["processed_dir"] = str(data)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.cuda
def test_captured_step_replayed_8_times_is_8_eager_steps(cuda_device,
                                                         tmp_path):
    """``train_steps`` of the small fused flagship (bf16, capacity, FFL,
    augmentation), 8 steps: one chunk of 8 replays of the captured step
    against ``scan_chunk_steps: 1`` (eager), from one seed: every total
    and every final weight bitwise; each kernel's launches a replay are
    the eager step's (reparam+KL forward and backward once, the head's
    two once, the upsample's twice each), and the counts the eager run's
    plus the capture's warm-up steps (8 + 2 of each)."""
    from betavae_tpu_torch.config import reset_config_cache
    from betavae_tpu_torch.logging_utils import reset_logger
    from betavae_tpu_torch.ops import kernel_wrappers
    from betavae_tpu_torch.train.loop import train_steps

    runs = {}
    for k in (1, 8):
        for w in kernel_wrappers().values():
            w.launches = 0
        reset_config_cache()
        reset_logger()
        try:
            out = train_steps(_chunk_flagship(tmp_path, k), 8, device="cuda")
        finally:
            reset_logger()
            reset_config_cache()
        runs[k] = (out, {n: w.launches for n, w in kernel_wrappers().items()})
    (eager, eager_n), (graph, graph_n) = runs[1], runs[8]
    assert eager["dispatch"] == "eager: scan_chunk_steps 1"
    assert graph["dispatch"] == "cuda_graph"
    assert graph["chunk_k"] == 8 and graph["capture_seconds"] > 0
    assert graph["totals"] == eager["totals"] and len(eager["totals"]) == 8
    for (name, a), b in zip(eager["model"].state_dict().items(),
                            graph["model"].state_dict().values()):
        assert torch.equal(a, b), name
    per_replay = graph["launches_per_replay"]
    assert per_replay["fused_reparam_kl"] == per_replay[
        "reparam_kl_backward"] == 1
    assert per_replay["head_forward"] == per_replay["head_m"] == 1
    assert per_replay["upsample_forward"] == per_replay[
        "upsample_backward"] == 2
    assert graph_n == {name: n + CAPTURE_WARMUP * per_replay[name]
                       for name, n in eager_n.items()}
    assert eager_n["fused_reparam_kl"] == eager_n["head_m"] == 8
    assert graph_n["fused_reparam_kl"] == 8 + CAPTURE_WARMUP


@pytest.mark.cuda
def test_device_launched_graph_runs_before_the_streams_next_work(
        cuda_device):
    """``train/chunks.py::CudaGraphs``' graph, launched from the device
    (``csrc/graph_launch.cu``): 20000 captured in-place adds, a copy queued
    behind one launch reads all of them (the stream's next work waits for
    the tail-launched graph), a second launch adds as many again, and the
    host's launch returns before the graph has run."""
    import time

    from betavae_tpu_torch.train.chunks import CudaGraphs

    graphs = CudaGraphs(cuda_device)
    x = torch.zeros(1024, device=cuda_device)
    graphs.warm_up(lambda: x.add_(1.0))
    x.zero_()
    graph = graphs.capture(lambda: [x.add_(1.0) for _ in range(20000)])
    graphs.synchronize()
    assert float(x[0]) == 0.0
    t0 = time.perf_counter()
    graph.replay()
    host = time.perf_counter() - t0
    first = x.clone()
    graph.replay()
    second = x.clone()
    t1 = time.perf_counter()
    graphs.synchronize()
    device = time.perf_counter() - t1
    assert torch.equal(first, torch.full_like(x, 20000.0))
    assert torch.equal(second, torch.full_like(x, 40000.0))
    assert host < device, (host, device)


@pytest.mark.cuda
def test_device_launched_graph_is_traced_under_the_profiler(cuda_device):
    """While ``torch.profiler`` traces, a ``DeviceLaunched`` graph goes
    from the host, so the trace holds its kernels (captured adds; a window
    can miss some, not all); launched from the device again after the
    profiler stops (the graph instantiated anew, as the tracing the
    profiler attaches fails a device launch of a graph instantiated before
    it), it computes on."""
    from torch.profiler import ProfilerActivity, profile

    from betavae_tpu_torch.train.chunks import CudaGraphs

    graphs = CudaGraphs(cuda_device)
    x = torch.zeros(1024, device=cuda_device)
    graphs.warm_up(lambda: x.add_(1.0))
    x.zero_()
    graph = graphs.capture(lambda: [x.add_(1.0) for _ in range(50)])
    graph.replay()
    graphs.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            graph.replay()
        graphs.synchronize()
    graph.replay()
    graphs.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    assert 0 < len(kernels) <= 250
    assert torch.equal(x, torch.full_like(x, 350.0))


@pytest.mark.cuda
def test_device_launched_graph_runs_through_a_scheduled_profiler(
        cuda_device):
    """Launches of a ``DeviceLaunched`` graph (captured adds) in every step
    of a ``torch.profiler`` ``schedule(wait=1, warmup=1, active=1)``, whose
    warm-up step has the profiler's CUDA tracing attached before it
    records, then after it; then a profiler window around other work, and
    launches after it: each launch adds its 50, none fails, and a
    session makes the graph instantiated anew before its next launch from
    the device (the tracing, once attached, fails a launch from the device
    of a graph instantiated before it)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from betavae_tpu_torch.train.chunks import CudaGraphs
    from betavae_tpu_torch.utils.profiling import SPANS

    graphs = CudaGraphs(cuda_device)
    x = torch.zeros(1024, device=cuda_device)
    graphs.warm_up(lambda: x.add_(1.0))
    x.zero_()
    graph = graphs.capture(lambda: [x.add_(1.0) for _ in range(50)])
    graph.replay()
    graphs.synchronize()
    redone = SPANS.counter("graphs.reinstantiations")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(4):
            for _ in range(3):
                graph.replay()
            prof.step()
        graphs.synchronize()
    for _ in range(3):
        graph.replay()
    graphs.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=cuda_device).sum().item()
    for _ in range(3):
        graph.replay()
    graphs.synchronize()
    assert torch.equal(x, torch.full_like(x, 19 * 50.0))
    assert SPANS.counter("graphs.reinstantiations") > redone


def _flagship_chunks(device, k: int):
    """The bench's fused flagship step (128 px, batch 32, capacity, FFL,
    augmentation) in ``TrainChunks`` of ``k`` steps over 1024 seeded
    images: ``(chunks, images, steps)``, ``steps(c)`` chunk ``c``'s."""
    import numpy as np

    from betavae_tpu_torch.bench import FLAGSHIP_CONFIG, flagship_model
    from betavae_tpu_torch.config import get_config
    from betavae_tpu_torch.models.losses import LossSpec
    from betavae_tpu_torch.train.chunks import TrainChunks
    from betavae_tpu_torch.train.optim import build_optimizer
    from betavae_tpu_torch.train.step import make_train_step

    b, n = 32, 1024
    model = flagship_model(device=device)
    optimizer = build_optimizer(model.parameters(),
                                get_config(str(FLAGSHIP_CONFIG)))
    aug = {"use_flip": True, "degrees": 10.0, "brightness_range": 0.1}
    step = make_train_step(
        model, optimizer, LossSpec(recon_loss_type="mse", use_ffl=True,
                                   ffl_weight=0.5, ffl_alpha=1.0),
        aug_kwargs=aug, use_capacity=True, seed=1)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (n, 128, 128, 1), np.uint8)).to(device)
    sched = dict(beta=1.0, capacity=30.0, capacity_weight=1.0,
                 free_bits=0.0, lr=5e-4)
    mask = np.ones(b, np.float32)

    def steps(chunk: int) -> list:
        return [(np.arange(s * b % (n - b), s * b % (n - b) + b), mask,
                 sched, s + 1) for s in range(chunk * k, (chunk + 1) * k)]

    def chunks():
        return TrainChunks(step, model, optimizer, k=k, batch=b,
                           device=device, seed=1, aug_kwargs=aug, graphs=True)

    return chunks, images, steps


# the flagship's 8 blocks' conv outputs at batch 32, bf16: enc0 … enc3,
# dec0 … dec3
FLAGSHIP_BLOCK_SHAPES = [(32, 64, 64, 64), (32, 128, 32, 32),
                         (32, 256, 16, 16), (32, 512, 8, 8),
                         (32, 256, 16, 16), (32, 128, 32, 32),
                         (32, 64, 64, 64), (32, 64, 128, 128)]


@pytest.mark.cuda
def test_flagship_captured_step_runs_the_gn_kernels_and_replays_bitwise(
        cuda_device):
    """The flagship train step (bf16, batch 32) captured in a graph: its
    GN backward calls by path are ``gn_path``'s choice at each of its 8
    block shapes (7 cluster, dec3 generic), its forward calls all generic;
    two launches from the same state give bitwise the same metrics row and
    parameters; each launch adds its GN kernel launches to the counters
    ``gn.cluster_launches`` (a backward cluster call's one kernel) and
    ``gn.generic_launches`` (two kernels a forward call and a backward
    generic call)."""
    from collections import Counter

    import numpy as np

    from betavae_tpu_torch.device import deterministic_cudnn
    from betavae_tpu_torch.utils.profiling import SPANS

    paths = Counter(gn_path(s, torch.bfloat16)[0]
                    for s in FLAGSHIP_BLOCK_SHAPES)
    want = {"cluster": paths["cluster"], "generic": paths["generic"]}
    assert want == {"cluster": 7, "generic": 1}
    make, images, steps = _flagship_chunks(cuda_device, 1)
    with deterministic_cudnn():
        run = make()
        run.prepare(images)
        per = run.captured.per_replay
        assert per["gn_forward"] == (8, {"generic": 8})
        assert per["gn_backward"] == (8, want)
        snapshot = run.snapshot
        snapshot.take()
        before = {p: SPANS.counter(f"gn.{p}_launches") for p in want}
        got = []
        for _ in range(2):
            snapshot.restore()
            rows = run.dispatch(images, steps(0)).rows().copy()
            got.append((rows, [p.detach().clone()
                               for p in run.model.parameters()]))
        run.queue.fence()
    assert {p: SPANS.counter(f"gn.{p}_launches") - before[p]
            for p in want} == {"cluster": 2 * 7, "generic": 2 * (16 + 2)}
    assert np.isfinite(got[0][0]).all()
    assert np.array_equal(got[0][0], got[1][0])
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_host_launched_dispatch_returns_at_once_behind_a_running_chunk(
        cuda_device, monkeypatch):
    """The path of one of several ranks on one card
    (``chunks._several_ranks`` patched true: the step's graph launched from
    the host, each dispatch a job of the dispatcher thread): a 182-step
    chunk's dispatch behind a running one returns in under 0.05 s with its
    job still to run (``CUDAGraph.replay`` drops the GIL while it waits for
    room in the launch queue), and both chunks' rows are bitwise those the
    device-launched chunks give from the same state."""
    import time

    import numpy as np

    from betavae_tpu_torch.device import deterministic_cudnn
    from betavae_tpu_torch.train import chunks as chunks_mod

    k = 182
    make, images, steps = _flagship_chunks(cuda_device, k)
    with deterministic_cudnn():
        device = make()
        device.prepare(images)
        snapshot = device.snapshot
        snapshot.take()
        want = [j.rows().copy()
                for j in [device.dispatch(images, steps(c)) for c in (0, 1)]]
        snapshot.restore()
        monkeypatch.setattr(chunks_mod, "_several_ranks", lambda: True)
        host = make()
        try:
            host.prepare(images)
            torch.cuda.synchronize()
            assert host.queue.threaded
            assert not isinstance(host.captured.graph,
                                  chunks_mod.DeviceLaunched)
            first = host.dispatch(images, steps(0))
            t0 = time.perf_counter()
            second = host.dispatch(images, steps(1))
            seconds = time.perf_counter() - t0
            queued = not second.done
            got = [first.rows().copy(), second.rows().copy()]
        finally:
            host.queue.close()
    assert seconds < 0.05 and queued, seconds
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1])
def test_dispatcher_runs_on_the_callers_device_and_stream(cuda_device, index):
    """A threaded ``DeviceQueue`` runs its jobs on the caller's device (a
    new thread starts on device 0) and its current stream: on ``cuda:0``
    under a side stream, and on ``cuda:1`` where a second card exists; a
    tensor a job makes on ``"cuda"`` lands there, and its work is ordered
    on the caller's stream."""
    from betavae_tpu_torch.device import DeviceQueue

    if index >= torch.cuda.device_count():
        pytest.skip(f"needs {index + 1} cards")
    dev = torch.device("cuda", index)
    stream = torch.cuda.Stream(dev)
    x = torch.zeros(1 << 20, device=dev)

    def job():
        y = torch.ones(4, device="cuda")
        x.add_(1.0)
        return (torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream, y.device.index)

    with torch.cuda.device(dev):
        queue = DeviceQueue(torch.device("cuda"), threaded=True)
    try:
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            got = queue.submit(job).result()
            # behind the job's add on the same stream
            total = x.sum()
    finally:
        queue.close()
    stream.synchronize()
    assert got == (index, stream.cuda_stream, index)
    assert float(total) == float(1 << 20)


@pytest.mark.cuda
def test_dispatch_chunk_span_agrees_with_events_around_the_dispatch(
        cuda_device):
    """A dispatched flagship chunk of 32 steps: its ``dispatch.chunk``
    span's device interval, read from the registry's events and anchor,
    is within 1 % of CUDA events the test records on the stream around the
    same dispatch, and lies on the host clock between the host's reads
    before the dispatch and after its rows (the anchor's skew aside)."""
    import time

    from betavae_tpu_torch.device import deterministic_cudnn
    from betavae_tpu_torch.utils.profiling import CHUNK, SPANS

    make, images, steps = _flagship_chunks(cuda_device, 32)
    with deterministic_cudnn():
        chunks = make()
        chunks.prepare(images)
        chunks.dispatch(images, steps(0)).rows()
        torch.cuda.synchronize()
        SPANS.settle(cuda_device)
        before, after = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        before.record()
        job = chunks.dispatch(images, steps(1))
        after.record()
        job.rows()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        chunks.queue.close()
    SPANS.settle(cuda_device)
    rec = SPANS.chunks[-1]
    assert rec.name == CHUNK and rec.steps == 32 and not rec.traced
    span_ms = 1e3 * (rec.d1 - rec.d0)
    events_ms = before.elapsed_time(after)
    assert abs(span_ms - events_ms) <= 0.01 * events_ms, (span_ms,
                                                          events_ms)
    assert t0 - 1e-3 <= rec.d0 < rec.d1 <= t1 + 2e-3, (t0, rec.d0, rec.d1,
                                                       t1)


@pytest.mark.cuda
def test_spans_never_synchronise_and_graphs_launch_from_the_device(
        cuda_device, monkeypatch):
    """With no profiler open: two dispatched chunks of 8 steps launch
    every graph from the device (``graphs.host_launches`` stays 0,
    ``graphs.device_launches`` counts 16), no span calls a synchronising
    entry of ``torch.cuda`` (counted through wrappers while a span opens
    or closes), and spans of device work allocate no device memory."""
    from betavae_tpu_torch.device import deterministic_cudnn
    from betavae_tpu_torch.utils import profiling
    from betavae_tpu_torch.utils.profiling import SPANS

    inside, calls = [False], []

    def counting(owner, name):
        real = getattr(owner, name)

        def wrapper(*args, **kwargs):
            if inside[0]:
                calls.append(name)
            return real(*args, **kwargs)
        monkeypatch.setattr(owner, name, wrapper)

    def flagged(name):
        real = getattr(profiling.Spans, name)

        def wrapper(*args, **kwargs):
            inside[0] = True
            try:
                return real(*args, **kwargs)
            finally:
                inside[0] = False
        monkeypatch.setattr(profiling.Spans, name, wrapper)

    make, images, steps = _flagship_chunks(cuda_device, 8)
    with deterministic_cudnn():
        chunks = make()
        chunks.prepare(images)
        torch.cuda.synchronize()
        counting(torch.cuda, "synchronize")
        counting(torch.cuda.Event, "synchronize")
        counting(torch.cuda.Stream, "synchronize")
        flagged("_open")
        flagged("_close")
        host = SPANS.counter("graphs.host_launches")
        device = SPANS.counter("graphs.device_launches")
        jobs = [chunks.dispatch(images, steps(c)) for c in (0, 1)]
        for job in jobs:
            job.rows()
        allocated = torch.cuda.memory_allocated(cuda_device)
        for _ in range(100):
            with SPANS.span("probe", device=cuda_device):
                pass
        assert torch.cuda.memory_allocated(cuda_device) == allocated
        chunks.queue.close()
    assert calls == []
    assert SPANS.counter("graphs.host_launches") == host
    assert SPANS.counter("graphs.device_launches") - device == 16
