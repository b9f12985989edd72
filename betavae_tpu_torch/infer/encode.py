"""Batch latent encoding: a split → μ / logσ² arrays and an embeddings CSV.

``python -m betavae_tpu_torch.infer.encode --config CONFIG [--weights
best|latest] [--device cuda|cpu]``, the port's
``betavae_tpu/infer/encode.py``: encodes the train and test splits and
writes ``{train,test}_latents_mu.npy``, ``..._logvar.npy`` and
``..._embeddings.csv`` (columns path, label, z0..zK) into the tables dir.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from ..config import get_config
from ..data.dataset import ArrayDataset, build_datasets
from ..device import resolve_device
from ..eval.run_evaluation import load_model
from ..models.beta_vae import BetaVAEModule, encode_split


def encode_dataset(model: BetaVAEModule, ds: ArrayDataset):
    """``(mu, logvar, labels, paths)`` of every sample of ``ds``."""
    mu, logvar = encode_split(model, ds.images,
                              int(get_config().training.batch_size))
    return mu, logvar, list(ds.labels), list(ds.paths)


def write_embeddings(Z, LV, labels, paths, prefix: str) -> str:
    out_dir = get_config().paths.tables_dir
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{prefix}_mu.npy"), Z)
    np.save(os.path.join(out_dir, f"{prefix}_logvar.npy"), LV)
    csv_path = os.path.join(out_dir, f"{prefix}_embeddings.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "label"] + [f"z{i}" for i in range(Z.shape[1])])
        for i in range(Z.shape[0]):
            w.writerow([paths[i], labels[i]] + list(Z[i]))
    return csv_path


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.infer.encode",
        description="Encode splits to latents")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--weights", type=str, default="best")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    get_config(args.config)
    train_ds, test_ds = build_datasets()
    model = load_model(args.weights, device=device)
    write_embeddings(*encode_dataset(model, train_ds), "train_latents")
    write_embeddings(*encode_dataset(model, test_ds), "test_latents")


if __name__ == "__main__":
    main()
