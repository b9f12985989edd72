"""Export a checkpoint to the reference's torch-pickle shard format.

``python -m betavae_tpu_torch.io.export_torch_checkpoint --config C
--checkpoint best|latest|<base> --output X.pt [--num-shards 2]
[--include-optimizer]``, the port's ``scripts/export_torch_checkpoint.py``:
reads a checkpoint of either package (or the reference's own) and writes
``X_shard{i}.pt`` in the reference's layout
(``io/checkpoint.py::save_torch_reference_checkpoint``), which the
reference's loader, both packages' resume and every evaluation CLI read.
With ``--include-optimizer`` the Adam state goes with it as an
``Adam.state_dict()`` payload whose ``param_groups`` carry the lr the
reference would have saved at that epoch (:func:`lr_at_save`), so the
reference's ``--resume`` continues this run's optimizer.
"""

from __future__ import annotations

import argparse
import os

from ..config import get, get_config
from ..io.artifacts import model_checkpoint_path
from ..train.schedules import lr_at, resolve_total_epochs
from .checkpoint import load_sharded_checkpoint, save_torch_reference_checkpoint
from .weights import export_adam_optim_state


def lr_at_save(cfg, epoch: int, total_steps: int) -> float:
    """The lr the reference's optimizer holds when it saves ``epoch``: it
    steps its cosine schedule at the end of an epoch's training, before the
    save, so a checkpoint of epoch e carries cosine position e + 1's lr
    (StepLR steps per batch)."""
    scheduler = str(cfg.optimization.scheduler).lower()
    return lr_at(epoch + (1 if scheduler == "cosine" else 0), total_steps,
                 base_lr=float(cfg.optimization.lr), scheduler=scheduler,
                 total_epochs=resolve_total_epochs(cfg))


def _base_path(path: str) -> str:
    """``path`` with the default ``.pt`` extension when it has none."""
    return path if os.path.splitext(path)[1] else path + ".pt"


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.io.export_torch_checkpoint",
        description="Export a checkpoint as reference-style torch shards.")
    parser.add_argument("--config", default=None,
                        help="YAML config whose run paths and optimizer "
                             "settings apply.")
    parser.add_argument("--checkpoint", default="best",
                        help="'best', 'latest', or a checkpoint base path.")
    parser.add_argument("--output", required=True,
                        help="Base path of the torch shards (run_best.pt "
                             "-> run_best_shard{0,1}.pt beside it).")
    parser.add_argument("--num-shards", type=int, default=2,
                        help="Shard count (default 2, the reference's own).")
    parser.add_argument("--include-optimizer", action="store_true",
                        help="Also export the Adam state, so the reference's "
                             "--resume continues this run's optimizer.")
    args = parser.parse_args(argv)
    cfg = get_config(args.config)

    if args.checkpoint in ("best", "latest"):
        src = model_checkpoint_path(args.checkpoint)
    else:
        src = _base_path(args.checkpoint)
    payload = load_sharded_checkpoint(src)

    optim_state = None
    if args.include_optimizer:
        optim_flat = (payload.get("optim_state")
                      or payload.get("reference_optim_state"))
        if optim_flat:
            optim_state = export_adam_optim_state(
                optim_flat, payload["model_state"],
                lr=lr_at_save(cfg, int(payload.get("epoch", 0)),
                              int(payload.get("total_steps", 0))),
                weight_decay=float(get(cfg.optimization, "weight_decay",
                                       0.0) or 0.0))
        else:
            print("WARNING: checkpoint carries no optim_state; exporting "
                  "without optimizer")

    paths = save_torch_reference_checkpoint(
        _base_path(args.output), payload, num_shards=args.num_shards,
        optim_state=optim_state)
    note = " (+ Adam optimizer state)" if optim_state is not None else ""
    print(f"Exported {src} -> {len(paths)} torch shard(s){note}:")
    print("\n".join(f"  - {p}" for p in paths))
    return paths


if __name__ == "__main__":
    main()
