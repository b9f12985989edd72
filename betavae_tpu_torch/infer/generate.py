"""Generation: prior samples, a factor edit and an interpolation.

``python -m betavae_tpu_torch.infer.generate --config CONFIG [--weights
best|latest] [--num-samples N] [--seed S] [--device cuda|cpu]``, the
port's ``betavae_tpu/infer/generate.py``:

- :func:`sample_random`: a seeded grid of prior samples → ``samples.png``
  (z from the reparam+KL forward's Philox stream: the kernel on the card;
  the JAX package's ``jax.random.normal`` draws other values of the same
  distribution),
- :func:`edit_tumor_factor`: a sweep of ``inference.tumor_latent_index``
  → ``edit_dim{d}.png``,
- :func:`interpolate`: a μ-space line between image 0 of the first two
  test batches → ``interpolation.png``.

Every sweep decodes in one call.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import get_config
from ..data.dataset import build_datasets
from ..device import resolve_device
from ..eval.run_evaluation import load_model
from ..io.artifacts import save_image_grid
from ..models.beta_vae import (BetaVAEModule, decode_latents, encode_split,
                               to_numpy_images)


def sample_random(model: BetaVAEModule, n: int, out_dir, seed=None):
    imgs = to_numpy_images(model.sample_prior(n, seed if seed is not None
                                              else 0))
    save_image_grid(imgs, os.path.join(out_dir, "samples.png"),
                    nrow=max(1, int(np.sqrt(n))), normalize=True)


def edit_tumor_factor(model: BetaVAEModule, images, dim, steps, span,
                      out_dir):
    """Sweep dim ``dim`` of the μ of the first of the packed ``images``."""
    base = encode_split(model, images[:1], 1)[0]
    zs = np.repeat(base, steps, axis=0)
    zs[:, dim] = np.linspace(-span, span, steps)
    save_image_grid(decode_latents(model, zs),
                    os.path.join(out_dir, f"edit_dim{dim}.png"), nrow=steps,
                    normalize=True)


def interpolate(model: BetaVAEModule, img_a, img_b, steps, out_dir):
    """A μ-space line from packed image ``img_a [1, H, W, C]`` to
    ``img_b``."""
    mu = encode_split(model, np.concatenate([img_a, img_b]), 2)[0]
    alphas = np.linspace(0, 1, steps)[:, None]
    zs = (1 - alphas) * mu[0:1] + alphas * mu[1:2]
    save_image_grid(decode_latents(model, zs),
                    os.path.join(out_dir, "interpolation.png"), nrow=steps,
                    normalize=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.infer.generate",
        description="Generate samples/traversals from a trained Beta-VAE.")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to YAML config")
    parser.add_argument("--weights", type=str, default="best",
                        help="Checkpoint tag (best or latest)")
    parser.add_argument("--num-samples", type=int, default=None,
                        help="Number of prior samples to generate")
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed for sampling latent codes")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    _, test_ds = build_datasets()
    model = load_model(args.weights, device=device)
    out_dir = cfg.paths.figures_dir
    os.makedirs(out_dir, exist_ok=True)
    n = args.num_samples or int(cfg.inference.sample_grid_size)
    sample_random(model, n, out_dir, seed=args.seed)

    steps = int(cfg.evaluation.traversal_steps)
    tumor_dim = cfg.inference.tumor_latent_index
    imgs = test_ds.images
    bs = int(cfg.training.batch_size)
    if tumor_dim is not None and len(test_ds) > 0:
        edit_tumor_factor(model, imgs[:bs], int(tumor_dim), steps=steps,
                          span=3.0, out_dir=out_dir)
    if len(test_ds) > bs:  # the reference takes image 0 of batches 1 and 2
        interpolate(model, imgs[:1], imgs[bs:bs + 1], steps, out_dir)


if __name__ == "__main__":
    main()
