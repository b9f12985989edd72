"""Build the processed train/test tree from the raw tree (thin CLI).

``python -m betavae_tpu_torch.scripts.preprocess_data [--config CONFIG]
[--normalization minmax|global_z] [--overwrite]``, the port's
``scripts/preprocess_data.py``; the logic is ``data/preprocess.py``'s.
Three stages, in order:

1. ``split_from_raw``: a pre-split ``Training/Testing`` tree is copied
   through, else each class folder under ``paths.raw_dir`` is split 80/20
   by ``data.seed``;
2. ``preprocess_dataset``: an in-place resize to ``data.image_size``
   (``minmax``), or a z-score with the train split's statistics first
   (``global_z``);
3. ``verify_processed``.

``main`` prints and returns each stage's seconds.  Host only.
"""

from __future__ import annotations

import argparse
import time

from ..config import get_config
from ..data import preprocess


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.preprocess_data",
        description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=None,
                        help="Path to YAML config (default resolution order "
                             "applies).")
    parser.add_argument("--normalization", default="minmax",
                        choices=("minmax", "global_z"))
    parser.add_argument("--overwrite", action="store_true",
                        help="Rebuild the processed dir from scratch.")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    print(f"raw: {cfg.paths.raw_dir} -> processed: {cfg.paths.processed_dir} "
          f"(normalization={args.normalization}; classes auto-detected from "
          "raw subfolders)")
    seconds = {}
    t0 = time.perf_counter()
    preprocess.split_from_raw(overwrite=args.overwrite)
    seconds["split"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess.preprocess_dataset(
        compute_stats=args.normalization == "global_z",
        normalization_mode=args.normalization)
    seconds["preprocess"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess.verify_processed()
    seconds["verify"] = time.perf_counter() - t0
    print("Preprocessing complete. Seconds by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return seconds


if __name__ == "__main__":
    main()
