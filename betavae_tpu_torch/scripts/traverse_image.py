"""Latent traversals around one image the user gives.

``python -m betavae_tpu_torch.scripts.traverse_image --image PATH
[--config CONFIG] [--checkpoint best|latest|PATH] [--indices 0,3]
[--span S] [--steps N] [--device cuda|cpu]``, the port's
``scripts/traverse_image.py``: the checkpoint (``best`` and ``latest``
name ``<models_dir>/<run_id>_<tag>.pt``, anything else is a base path),
the image decoded as the trainer's data at ``data.image_size``, then
``eval/traversal.py::run_traversals(images_override=...)``:
``traversal_dim{d}.png`` for each dim (``--indices``, else
``inference.traversal_latent_indices``, else the first four) and
``traversal_tumor_{class}.png`` for each tumor class direction, under
``paths.figures_dir``.  ``--span`` and ``--steps`` default to
``inference.edit_span`` and ``evaluation.traversal_steps``.

On the card (the default device; it raises without a GPU) the encoder
gives μ, so no reparam+KL kernel runs, and with ``training.fused_head:
true`` every sweep's decode runs the head forward kernel.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import get_config
from ..data.dataset import build_datasets, load_image
from ..device import resolve_device
from ..eval.run_evaluation import load_checkpoint_model
from ..eval.traversal import run_traversals
from ..io.artifacts import ensure_dirs


def _resolve_checkpoint(tag: str) -> Path:
    """``best``/``latest`` → the run's path under ``models_dir``; anything
    else is a path."""
    cfg = get_config()
    if tag not in ("best", "latest"):
        return Path(tag)
    return Path(cfg.paths.models_dir) / f"{cfg.paths.run_id}_{tag}.pt"


def load_model(checkpoint_tag: str, device):
    path = _resolve_checkpoint(checkpoint_tag)
    try:
        return load_checkpoint_model(str(path), device)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"Checkpoint not found at {path} (base file or shards).") from e


def _parse_dim_list(raw: str | None):
    if not raw:
        return None
    try:
        return [int(tok) for tok in raw.split(",") if tok.strip()]
    except ValueError:
        print("--indices is not a comma-separated int list; "
              "falling back to defaults.")
        return None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.traverse_image",
        description="Latent traversals for one input image.")
    flag = parser.add_argument
    flag("--config", type=str, default=None,
         help="YAML config to activate for this run.")
    flag("--image", type=str, required=True,
         help="Input image to encode and traverse around.")
    flag("--checkpoint", type=str, default="best",
         help="'best', 'latest', or a checkpoint base path.")
    flag("--indices", type=str, default=None,
         help="Latent dims to sweep, comma-separated.")
    flag("--span", type=float, default=None,
         help="Sweep half-width; config edit_span if omitted.")
    flag("--steps", type=int, default=None,
         help="Sweep sample count; config value if omitted.")
    flag("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    ensure_dirs()

    model = load_model(args.checkpoint, device)
    img = load_image(args.image, cfg.data.grayscale,
                     size=int(cfg.data.image_size))[None]
    _, test_ds = build_datasets()

    run_traversals(
        model, test_ds,
        indices=_parse_dim_list(args.indices),
        steps=int(cfg.evaluation.traversal_steps
                  if args.steps is None else args.steps),
        span=float(cfg.inference.edit_span
                   if args.span is None else args.span),
        images_override=img)
    print(f"Traversal figures written under {cfg.paths.figures_dir}")


if __name__ == "__main__":
    main()
