"""Stable Diffusion's autoencoder (``model.architecture: autoencoder_kl``)
against its plain reference (``tests/plain_autoencoder_kl.py``), fp32 on
the CPU.

At a small size (32 px, ``ch`` 64, ``ch_mult`` [1, 2], one res block a
level, 32 groups, attention at 16², the last level's side, besides the mid
blocks) on seeded random weights: the forward, the loss, every leaf's
gradient and three Adam steps at betas (0.5, 0.9) through the port's own
train step.  Both sides are fp32 on the CPU and differ in the order they
sum: the port's attention is ``F.scaled_dot_product_attention`` over
``F.linear`` q, k, v where the reference multiplies with ``bmm`` after 1×1
convolutions, and its KL and loss are summed per dimension first.  Each
tolerance is written where it is used, with the gap seen beside it (7× to
600× below it).  Also: the
parameter count at the published widths (built on the meta device), the
seeded initialisation (bitwise the reference's ``initial_weights``), two
short epochs of ``train()``, the β-VAE as the default architecture, the
library calls the model counts, and the benchmark's frozen copy of the
reference.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.models.autoencoder_kl import AutoencoderKL
from betavae_tpu_torch.models.beta_vae import BetaVAEModule, model_from_config
from betavae_tpu_torch.models.losses import compute_loss, loss_spec_from_config
from betavae_tpu_torch.ops.gn_silu import gn_silu
from betavae_tpu_torch.ops.reparam import reparameterize_and_kl
from betavae_tpu_torch.train import optim
from betavae_tpu_torch.train.loop import train
from betavae_tpu_torch.train.step import make_train_step
from betavae_tpu_torch.utils.profiling import LIBRARY_CALLS

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
import plain_autoencoder_kl as ref  # noqa: E402

from benchmark import flops_klf8  # noqa: E402

CONFIG = ROOT / "configs" / "sd_vae_kl_f8.yaml"
SEED = 115
BATCH = 4


def _small_cfg(**training) -> dict:
    cfg = yaml.safe_load(CONFIG.read_text())
    cfg["data"]["image_size"] = 32
    cfg["model"].update(ch=64, ch_mult=[1, 2], num_res_blocks=1,
                        attn_resolutions=[16], latent_dim=4 * 16 * 16)
    cfg["training"].update(batch_size=BATCH, mixed_precision=False,
                           **training)
    return cfg


def _frozen(cfg: dict, tmp_path: Path):
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    reset_config_cache()
    return get_config(str(path))


def _random_weights(spec, seed: int) -> dict:
    """Every leaf redrawn, so biases and norm affines carry information:
    N(0, 0.3²), GroupNorm scales around 1."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in ref.parameters(spec):
        out[name] = torch.randn(shape, generator=g) * 0.3 + (
            1.0 if kind == "gn_weight" else 0.0)
    return out


@pytest.fixture
def small(tmp_path):
    """``(cfg dict, port model with random weights, reference spec, the
    weights)``."""
    cfg = _small_cfg()
    model = model_from_config(_frozen(cfg, tmp_path), device="cpu")
    spec = ref.Spec.from_config(cfg)
    P = _random_weights(spec, 0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(P[n])
    yield cfg, model, spec, P
    reset_config_cache()


def _inputs(spec, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(BATCH, spec.in_channels, spec.image_size, spec.image_size,
                   generator=g)
    return x, torch.randn(BATCH, spec.latent, generator=g)


def _close(got, want, rel: float, what: str) -> None:
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= rel * max(scale, 1e-30), f"{what}: {gap} of {scale}"


def _port_loss(model, cfg, x, eps):
    """The port's loss of ``x`` with the noise ``eps``, as the step
    computes it (β mode)."""
    mu, logvar = model.encode(x)
    z, kl_elem = reparameterize_and_kl(mu, logvar, eps=eps)
    recon = model.decode(z)
    beta = float(cfg["beta_schedule"]["end_beta"])
    return compute_loss((recon, mu, logvar, z, kl_elem), x,
                        spec=loss_spec_from_config(), beta=beta,
                        mask=torch.ones(x.shape[0]))


def test_forward_matches_the_plain_reference(small):
    """μ, logσ² and the reconstruction (in [−1, 1]) within 1e-4 of the
    largest value: fp32 sums in different orders (the gap seen: ~4e-6)."""
    cfg, model, spec, P = small
    x, eps = _inputs(spec)
    want, mu_ref, lv_ref = ref.forward(P, x, eps, spec,
                                       ref._Ops("fp32", "cpu", 32))
    with torch.no_grad():
        mu, logvar = model.encode(x)
        recon = model.decode(mu + eps * torch.exp(0.5 * logvar))
    assert mu.shape == (BATCH, spec.latent) == logvar.shape
    _close(mu, mu_ref, 1e-4, "mu")
    _close(logvar, lv_ref, 1e-4, "logvar")
    _close(recon * 2.0 - 1.0, want, 1e-4, "recon")


def test_loss_and_every_gradient_match_the_plain_reference(small):
    """The loss within 1e-5 relative (a sum of 12 288 absolute values, its
    order differs), and each leaf's gradient within 1e-3 in norm of the
    larger of its own norm and the median leaf's: the L1 loss's gradient
    is a sign, so a pixel whose difference is near 0 can take the other
    sign on the other side; and a leaf whose gradient is nought but for
    rounding (each attention's k bias: the softmax over the keys does not
    see a shift common to a query's scores) is held to the median leaf's
    scale, as the benchmark's check holds it (gaps seen: the loss 2e-7,
    the worst leaf 5.5e-5)."""
    cfg, model, spec, P = small
    x, eps = _inputs(spec)
    total = _port_loss(model, cfg, x, eps)["total"]
    total.backward()
    want, grads = ref._gradients({n: p.clone() for n, p in P.items()}, x,
                                 eps, torch.ones(BATCH), spec,
                                 ref._Ops("fp32", "cpu", 32))
    assert math.isclose(float(total.detach()), float(want), rel_tol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    floor = float(np.median(list(norms.values())))
    for n, g in grads.items():
        gap = float(torch.linalg.vector_norm(named[n].grad - g))
        assert gap <= 1e-3 * max(norms[n], floor), (n, gap, norms[n], floor)


def test_three_adam_steps_of_the_ports_step_match_the_plain_reference(
        small):
    """Three steps of ``make_train_step`` (its ε the reparam+KL kernel's
    plain Philox stream, Adam at the configuration's betas (0.5, 0.9))
    against the reference's: each step's loss within 1e-4 relative, and
    each leaf's change within 2e-2 of the largest change of any leaf, with
    the median leaf's within 1e-3 of its own: Adam's first updates are near
    lr·sign(g), so a gradient near nought moves its weight by ±lr on
    either side's rounding (gaps seen: losses ≤ 1.2e-7, the worst leaf
    2.8e-3 of the largest change, the median leaf 1.6e-6)."""
    cfg, model, spec, P = small
    opt = optim.build_optimizer(model.parameters(), get_config())
    assert opt.betas == (0.5, 0.9) == spec.betas
    step = make_train_step(model, opt, loss_spec_from_config(),
                           aug_kwargs={"use_flip": False}, use_capacity=False,
                           seed=SEED)
    g = torch.Generator().manual_seed(7)
    images = torch.randint(0, 256, (16, 32, 32, 3), dtype=torch.uint8,
                           generator=g)
    lr = float(cfg["optimization"]["lr"])
    sched = {"beta": spec.beta, "capacity": 0.0, "capacity_weight": 1.0,
             "free_bits": 0.0, "lr": lr}
    batches, losses = [], []
    for s in range(1, 4):
        idx = torch.arange(4 * (s - 1), 4 * s)
        losses.append(float(step(images, idx, torch.ones(BATCH), sched, s,
                                 torch.zeros(3, BATCH))["total"]))
        b = ref.prepare_batch(images, idx, SEED, s, spec.latent)
        b.update(mask=torch.ones(BATCH), sched={"lr": lr})
        batches.append(b)
    want = ref.train(P, batches, spec, precision="fp32")
    for got, w in zip(losses, want["losses"]):
        assert math.isclose(got, w, rel_tol=1e-4), (got, w)
    change = {n: float(torch.linalg.vector_norm(p.detach() - P[n]))
              for n, p in model.named_parameters()}
    largest = max(want["change_norms"].values())
    gaps = {n: abs(change[n] - w) for n, w in want["change_norms"].items()}
    assert max(gaps.values()) <= 2e-2 * largest, max(gaps, key=gaps.get)
    rel = sorted(gaps[n] / max(w, 1e-30)
                 for n, w in want["change_norms"].items())
    assert rel[len(rel) // 2] <= 1e-3


def test_published_widths_have_the_references_parameters():
    """At the published widths (256 px RGB, ch 128, ch_mult [1, 2, 4, 4],
    2 res blocks, z 4, 32 groups) the port's model, built on the meta
    device, has the reference's parameters, by name and shape: 83 653 863,
    kl-f8's count."""
    cfg = yaml.safe_load(CONFIG.read_text())
    spec = ref.Spec.from_config(cfg)
    m, d = cfg["model"], cfg["data"]
    with torch.device("meta"):
        model = AutoencoderKL(
            image_size=d["image_size"], in_channels=3, ch=m["ch"],
            ch_mult=m["ch_mult"], num_res_blocks=m["num_res_blocks"],
            z_channels=m["z_channels"], norm_groups=m["norm_groups"],
            attn_resolutions=m["attn_resolutions"])
    shapes = {n: tuple(s) for n, s, _ in ref.parameters(spec)}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == shapes
    count = sum(p.numel() for p in model.parameters())
    assert count == sum(map(math.prod, shapes.values())) == 83_653_863
    assert model.latent_dim == spec.latent == m["latent_dim"] == 4096


def test_seeded_build_is_the_references_initial_weights(tmp_path):
    """``model_from_config`` draws PyTorch's default initialisation from
    ``data.seed`` in the order the modules are made: bitwise the
    reference's ``initial_weights``."""
    cfg = _small_cfg()
    model = model_from_config(_frozen(cfg, tmp_path), device="cpu")
    want = ref.initial_weights(ref.Spec.from_config(cfg), SEED, "cpu")
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    assert all(torch.equal(got[n], want[n]) for n in want)
    reset_config_cache()


def test_the_default_architecture_is_the_beta_vae(tmp_path):
    """A configuration without ``model.architecture`` builds today's β-VAE
    and compares images in [0, 1]; an unknown one raises."""
    cfg = yaml.safe_load((ROOT / "configs" / "beta_vae_se.yaml").read_text())
    assert "architecture" not in cfg["model"]
    c = _frozen(cfg, tmp_path)
    assert isinstance(model_from_config(c, device="cpu"), BetaVAEModule)
    assert loss_spec_from_config(c).image_range == (0.0, 1.0)
    assert optim.build_optimizer(
        [torch.zeros(1, requires_grad=True)], c).betas == (0.9, 0.999)
    cfg["model"]["architecture"] = "unet"
    with pytest.raises(ValueError, match="architecture"):
        model_from_config(_frozen(cfg, tmp_path), device="cpu")
    reset_config_cache()


def test_the_model_counts_its_library_calls(small):
    """A forward calls the port's GroupNorm → swish op once a GroupNorm
    (``gn_silu.calls``; the library's GroupNorm no more) and counts one
    ``attn.<backend>`` call an attention block: the layer counts the
    benchmark's ``flops_klf8`` lists."""
    cfg, model, spec, _ = small
    before = dict(LIBRARY_CALLS)
    norms = sum(gn_silu.calls.values())
    with torch.no_grad():
        model(_inputs(spec)[0], deterministic=True)
    delta = {k: n - before.get(k, 0) for k, n in LIBRARY_CALLS.items()
             if n != before.get(k, 0)}
    attn = {k: n for k, n in delta.items() if k.startswith("attn.")}
    assert (sum(gn_silu.calls.values()) - norms
            == len(flops_klf8.norm_shapes(cfg)) == 27)
    assert sum(attn.values()) == len(flops_klf8.attention_calls(cfg)) == 5
    assert set(delta) == {*attn}


@pytest.mark.parametrize("key,value", [("training.remat", True),
                                       ("training.fused_head", True),
                                       ("model.latent_dim", 64)])
def test_keys_it_cannot_honour_raise(tmp_path, key, value):
    cfg = _small_cfg()
    sec, name = key.split(".")
    cfg[sec][name] = value
    with pytest.raises(ValueError, match=name):
        model_from_config(_frozen(cfg, tmp_path), device="cpu")
    reset_config_cache()


def test_two_epochs_of_train(tmp_path):
    """``train()`` on the architecture over RGB images: two epochs of two
    steps with validation (its 1024-wide μ rows), probes, checkpoints and
    the panel, every loss finite, and the ``latest`` checkpoint holds the
    published parameter names."""
    cfg = _small_cfg(epochs=2, scan_chunk_steps=2)
    cfg["paths"].update(
        processed_dir=str(tmp_path / "processed"),
        outputs_dir=str(tmp_path / "outputs"),
        models_dir=str(tmp_path / "outputs" / "models"),
        figures_dir=str(tmp_path / "outputs" / "figures"),
        tables_dir=str(tmp_path / "outputs" / "tables"), run_id="run")
    cfg["logging"]["log_to_file"] = False
    generate_demo_data(tmp_path / "processed", train_per_class=2,
                       test_per_class=1, size=32)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    reset_config_cache()
    reset_logger()
    try:
        out = train(str(path), device="cpu")
    finally:
        reset_logger()
        reset_config_cache()
    assert out["epoch"] == 2 and out["total_steps"] == 4
    assert isinstance(out["model"], AutoencoderKL)
    assert all(np.isfinite(float(p.detach().sum()))
               for p in out["model"].parameters())
    shards = sorted((tmp_path / "outputs" / "models").glob("run_latest_*"))
    assert shards
    assert list((tmp_path / "outputs" / "figures").glob("recon_epoch*.png"))


def test_the_benchmarks_copy_is_this_reference_frozen():
    """``benchmark/reference/autoencoder_kl.py`` is this file but for the
    import of the noise streams."""
    here = (ROOT / "tests" / "plain_autoencoder_kl.py").read_text()
    frozen = (ROOT / "benchmark" / "reference" / "autoencoder_kl.py").read_text()
    assert here.replace("from benchmark.reference import streams",
                        "from . import streams") == frozen
