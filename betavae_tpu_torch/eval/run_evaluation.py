"""Evaluation entry point: checkpoint → metrics → figures → traversals.

``python -m betavae_tpu_torch.eval.run_evaluation --config CONFIG
[--device cuda|cpu]``, the port's ``betavae_tpu/eval/run_evaluation.py``:
resolve the ``best`` checkpoint (falling back to ``latest``, shard-aware),
then ``evaluate_full`` → ``generate_latent_visualizations`` →
``run_traversals``.  Where a ``latent_analysis`` run left
``latent_ranking_summary.json`` behind, its ``traversal_order_auc`` picks
the traversal dims, cut to ``min(latent_dim, evaluation.traversal_steps)``:
the reference's ``traversal_steps`` doubling as a dim count, kept.

:func:`load_model` reads checkpoints of either package (torch names or
flax paths) and the reference's torch-pickle shards (``io/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from ..config import get_config
from ..data.dataset import build_datasets
from ..device import resolve_device
from ..io.checkpoint import discover_shards, load_sharded_checkpoint
from ..models.beta_vae import BetaVAEModule, model_from_config
from ..train.callbacks import load_model_state
from .latent_viz import generate_latent_visualizations
from .recon_metrics import evaluate_full
from .traversal import run_traversals


def _checkpoint_exists(base: str) -> bool:
    """True if the base file or any of its shard files is on disk."""
    return os.path.exists(base) or bool(discover_shards(base))


def load_model(weights: str = "best",
               device: str | torch.device = "cuda") -> BetaVAEModule:
    """The config's model on ``device`` in ``eval()`` mode, with the weights
    of ``<models_dir>/<run_id>_<weights>.pt``, falling back to ``latest``
    where that checkpoint is absent."""
    cfg = get_config()

    def tag_path(tag):
        return os.path.join(cfg.paths.models_dir,
                            f"{cfg.paths.run_id}_{tag}.pt")

    path = tag_path(weights)
    if not _checkpoint_exists(path):
        path = tag_path("latest")
    model = model_from_config(cfg, device=device)
    load_model_state(model, load_sharded_checkpoint(path)["model_state"])
    return model.eval()


def _ranked_traversal_dims(cfg, latent_dim: int):
    """Dim order from ``latent_ranking_summary.json``, if the analysis
    ran."""
    summary_path = Path(cfg.paths.outputs_dir) / "latent_ranking_summary.json"
    if not summary_path.exists():
        return None
    ranking = json.loads(summary_path.read_text()).get("traversal_order_auc")
    if ranking is None:
        return None
    return ranking[: min(latent_dim, int(cfg.evaluation.traversal_steps))]


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.eval.run_evaluation",
        description="Run full evaluation for Beta-VAE")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to YAML config file")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    train_ds, test_ds = build_datasets()
    model = load_model("best", device=device)
    evaluate_full(model, train_ds, test_ds)
    generate_latent_visualizations(model, test_ds)
    run_traversals(model, test_ds,
                   indices=_ranked_traversal_dims(cfg, model.latent_dim))


if __name__ == "__main__":
    main()
