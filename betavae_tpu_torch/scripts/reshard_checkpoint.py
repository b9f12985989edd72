"""Rewrite a checkpoint with more shards than it has.

``python -m betavae_tpu_torch.scripts.reshard_checkpoint [--config CONFIG]
[--checkpoint best|latest|PATH] --num-shards N [--output PATH]``, the
port's ``scripts/reshard_checkpoint.py``: the same flags and the same rule
(the count must grow, else ``ValueError`` "would not grow").  The shards
are merged by ``io/checkpoint.py::load_sharded_checkpoint`` and written in
the package's zip format, which either package reads; a set of the
reference's torch-pickle shards comes out in that format too, its Adam
state kept as ``reference_optim_state``.  Host only.
"""

from __future__ import annotations

import argparse

from ..config import get_config
from ..io.artifacts import model_checkpoint_path
from ..io.checkpoint import (checkpoint_shard_count, discover_shards,
                             load_sharded_checkpoint, normalize_base_path,
                             save_sharded_checkpoint)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.reshard_checkpoint",
        description="Increase the shard count of a saved checkpoint.")
    ap.add_argument("--config", default=None,
                    help="YAML config to activate before resolving run paths.")
    ap.add_argument("--checkpoint", default="latest",
                    help="'best', 'latest', or a checkpoint base path.")
    ap.add_argument("--num-shards", type=int, required=True,
                    help="Target shard count; must be larger than what exists.")
    ap.add_argument("--output", default=None,
                    help="Base path for the resharded files (default: in place).")
    args = ap.parse_args(argv)
    get_config(args.config)

    if args.checkpoint in ("best", "latest"):
        src_base = model_checkpoint_path(tag=args.checkpoint)
    else:
        src_base = normalize_base_path(args.checkpoint)
    dst_base = normalize_base_path(args.output) if args.output else src_base

    have = checkpoint_shard_count(src_base)
    if args.num_shards <= have:
        raise ValueError(
            f"--num-shards={args.num_shards} would not grow the checkpoint: "
            f"{have} shard(s) already exist at {src_base}")

    existing = discover_shards(src_base)
    if existing:
        print(f"Merging {len(existing)} input shard(s):")
        print("\n".join(f"  - {p}" for p in existing))
    else:
        print(f"Input is a single unsharded file: {src_base}")

    payload = load_sharded_checkpoint(src_base, num_shards=have)
    written = save_sharded_checkpoint(dst_base, payload,
                                      num_shards=args.num_shards)
    print(f"\nWrote {len(written)} shard(s):")
    print("\n".join(f"  - {p}" for p in written))
    return written


if __name__ == "__main__":
    main()
