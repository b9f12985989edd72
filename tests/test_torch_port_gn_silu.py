"""The GroupNorm → swish op (``ops/gn_silu.py``) on the CPU: its plain
version against the library composition it replaces in the kl-f8 model,
``F.silu(F.group_norm(x.float(), G, γ, β, 1e-6).to(x.dtype))``, what it
saves for the backward, its path rule and the model's calls of it.  The
kernels themselves run on the card (``tests/test_torch_port_cuda.py -k
gn_silu``)."""

import pytest
import torch
import torch.nn.functional as F

from betavae_tpu_torch.models.autoencoder_kl import AutoencoderKL
from betavae_tpu_torch.ops.gn_silu import (gn_silu, gn_silu_path,
                                           gn_silu_reference)

# (B, C, H, W, G): 4, 8 and 16 channels a group, odd H·W
SHAPES = [(2, 16, 7, 9, 4), (3, 64, 5, 11, 4), (2, 32, 9, 9, 4)]
# the kl-f8 autoencoder's norms at batch 12: (C, side)
KLF8_NORMS = [(512, 32), (128, 256), (512, 64), (256, 128), (128, 128),
              (256, 64), (512, 128), (256, 256)]


def _inputs(shape, dtype, seed: int = 0):
    b, c, h, w, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, c, h, w, generator=g) * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g) * 0.5 + 1
    beta = torch.randn(c, generator=g) * 0.3
    dy = torch.randn(b, c, h, w, generator=g).to(dtype)
    return x, gamma, beta, dy


def _composition(x, gamma, beta, groups, swish):
    z = F.group_norm(x.float(), groups, gamma, beta, 1e-6).to(x.dtype)
    return F.silu(z) if swish else z


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_is_the_composition_given_its_statistics(shape, dtype,
                                                         swish):
    """Given ``nn.GroupNorm``'s own mean and rstd, the plain version's
    output is the composition's, bit for bit."""
    x, gamma, beta, _ = _inputs(shape, dtype)
    b, c, h, w, groups = shape
    _, m, rstd = torch.native_group_norm(x.float(), gamma, beta, b, c, h * w,
                                         groups, 1e-6)
    y, _, _ = gn_silu_reference(x, gamma, beta, groups, 1e-6, swish,
                                stats=(m, rstd))
    assert y.dtype == x.dtype
    assert torch.equal(y, _composition(x, gamma, beta, groups, swish))


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_autograd_of_the_composition(shape, dtype, swish):
    """y, dx, dγ and dβ of the op against autograd of the composition.
    The statistics are summed in another order (float64 here), and the
    backward's sums too: in fp32 every gap is within 1e-5 of the largest
    value (seen: 2e-6); in bf16 y and dx within one bf16 step of the
    largest value (2⁻⁸ of it; seen: 1e-5 and 0) and dγ, dβ, summed in
    fp32, within 1e-5 (seen: 3e-6)."""
    x, gamma, beta, dy = _inputs(shape, dtype)
    groups = shape[-1]
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    mine = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    want = _composition(*leaves, groups, swish)
    want.backward(dy)
    got = gn_silu(*mine, groups, 1e-6, swish)
    got.backward(dy)
    act = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    for what, g, w, rel in (("y", got, want, act),
                            ("dx", mine[0].grad, leaves[0].grad, act),
                            ("dgamma", mine[1].grad, leaves[1].grad, 1e-5),
                            ("dbeta", mine[2].grad, leaves[2].grad, 1e-5)):
        assert g.dtype == w.dtype, what
        g, w = g.detach().float(), w.detach().float()
        scale, gap = float(w.abs().max()), float((g - w).abs().max())
        assert gap <= rel * scale, f"{what}: {gap} of {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_it_saves_x_and_the_statistics_only(dtype):
    """The op saves x in its own dtype (x itself) and two ``[B, G]`` fp32
    tensors, and nothing else: no fp32 copy of x and no z."""
    shape = SHAPES[0]
    x, gamma, beta, dy = _inputs(shape, dtype)
    x.requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = gn_silu(x, gamma.requires_grad_(), beta.requires_grad_(),
                    shape[-1])
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [
        (dtype, tuple(x.shape)), (torch.float32, (shape[0], shape[-1])),
        (torch.float32, (shape[0], shape[-1]))]
    assert saved[0].data_ptr() == x.data_ptr()
    y.backward(dy)
    assert x.grad is not None and gamma.grad is not None


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_the_small_klf8_model_calls_it_once_a_norm(mixed_precision):
    """The small kl-f8 model's forward (32 px, ``ch`` 64, ``ch_mult`` [1,
    2], one res block a level, attention at 16²) calls the op once for each
    of its 27 norms: 22 with the swish, and without it the 5 that feed an
    attention block; under autocast each takes x in bf16."""
    torch.manual_seed(0)
    model = AutoencoderKL(image_size=32, in_channels=3, ch=64, ch_mult=[1, 2],
                          num_res_blocks=1, z_channels=4, norm_groups=32,
                          attn_resolutions=[16],
                          mixed_precision=mixed_precision)
    before = dict(gn_silu.calls)
    with torch.no_grad():
        recon, *_ = model(torch.rand(2, 3, 32, 32), deterministic=True)
    calls = {k: n - before[k] for k, n in gn_silu.calls.items()}
    assert calls == {"swish": 22, "norm": 5}
    assert torch.isfinite(recon).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_path_rule_at_klf8s_norms(dtype):
    """At batch 12 every bf16 norm of kl-f8 takes the cluster path, and
    every fp32 one but the widest (256@256², 2 MiB a row); a row whose
    channels are not whole 16-byte units, or hold no multiple of 32 of
    them, takes the generic path."""
    paths = {(c, s): gn_silu_path((12, c, s, s), 32, dtype)
             for c, s in KLF8_NORMS}
    wide = (256, 256) if dtype == torch.float32 else None
    for key, (kind, k) in paths.items():
        assert (kind == "generic") == (key == wide), (key, kind)
        assert (k == 0) == (kind == "generic") and k <= 8
    assert gn_silu_path((12, 128, 33, 33), 32, dtype) == ("generic", 0)
    assert gn_silu_path((12, 128, 8, 8), 32, dtype) == ("generic", 0)


def test_it_raises_on_what_it_does_not_take():
    x, gamma, beta, _ = _inputs(SHAPES[0], torch.float32)
    with pytest.raises(ValueError, match="dividing"):
        gn_silu(x, gamma, beta, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        gn_silu(x.half(), gamma, beta, 4)
    with pytest.raises(ValueError, match="gamma"):
        gn_silu(x, gamma.double(), beta, 4)
