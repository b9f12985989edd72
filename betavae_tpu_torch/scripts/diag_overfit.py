"""Overfit diagnostic: train and val MSE and latent statistics of ``latest``.

``python -m betavae_tpu_torch.scripts.diag_overfit [--config CONFIG]
[--device cuda|cpu]``, the port's ``scripts/diag_overfit.py``: the run's
``latest`` checkpoint, the splits cut to ``debug.train_samples`` /
``debug.test_samples``, the mean over batches of each batch's MSE
(``training.batch_size`` images a batch) for each split, then μ, z, logσ²
and the input and output ranges of the first train batch, printed as JSON
(and returned).

Each forward is the evaluation's (``models/beta_vae.py::sample_forward``):
z = μ under ``model.deterministic_overfit``, else z drawn by the reparam+KL
forward, the kernel on the card, with key ``data.seed`` and offsets
counted over the run's forwards: train batch ``i`` at offset ``i``, val
batch ``j`` at ``n_train_batches + j``, the statistics batch at
``n_train_batches + n_val_batches``.  The JAX script splits a
``jax.random`` key a batch instead, so the numbers that hang on ε (z, the
MSEs, the output range) agree with it in distribution only.  The default
device is the card; it raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import get, get_config
from ..data.dataset import build_datasets, images_to_tensor
from ..device import resolve_device
from ..eval.run_evaluation import load_checkpoint_model
from ..models.beta_vae import sample_forward


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.diag_overfit",
        description="Overfit diagnostic")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    train_ds, test_ds = build_datasets(
        train_limit=get(cfg.debug, "train_samples", None),
        test_limit=get(cfg.debug, "test_samples", None))
    model = load_checkpoint_model(
        os.path.join(cfg.paths.models_dir, f"{cfg.paths.run_id}_latest.pt"),
        device)

    bs = int(cfg.training.batch_size)
    seed = int(cfg.data.seed)
    offset = 0

    def forward(images):
        nonlocal offset
        x = images_to_tensor(images, device)
        out = sample_forward(model, x, seed, offset)
        offset += 1
        return x, out

    def full_mse(ds):
        mses = []
        for s in range(0, len(ds), bs):
            x, (r, *_) = forward(ds.images[s:s + bs])
            mses.append(torch.mean((r - x) ** 2))
        return (sum(float(m) for m in torch.stack(mses).cpu())
                / max(1, len(mses))) if mses else 0.0

    train_mse = full_mse(train_ds)
    val_mse = full_mse(test_ds)

    x, out = forward(train_ds.images[:bs])
    x, r, mu, logvar, z = (t.float().cpu().numpy() for t in (x, *out))
    stats = {
        "train_mse_mean": train_mse,
        "val_mse_mean": val_mse,
        "mu_mean": float(mu.mean()), "mu_std": float(mu.std()),
        "z_mean": float(z.mean()), "z_std": float(z.std()),
        "logvar_mean": float(logvar.mean()), "logvar_std": float(logvar.std()),
        "x_min": float(x.min()), "x_max": float(x.max()),
        "r_min": float(r.min()), "r_max": float(r.max()),
    }
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
