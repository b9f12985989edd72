"""Write the seeded synthetic 4-class dataset under ``paths.processed_dir``.

``python -m betavae_tpu_torch.scripts.generate_demo_data [--config CONFIG]
[--train-per-class N] [--test-per-class N]``, the port's
``scripts/generate_demo_data.py``: ``data/demo.py``'s class patterns at
``data.image_size``, the same bytes as the JAX package writes.  Host only.
"""

from __future__ import annotations

import argparse

from ..config import get_config
from ..data.demo import CLASSES, generate_demo_data


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.generate_demo_data",
        description="Write the seeded synthetic 4-class demo dataset.")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config to activate for this run.")
    parser.add_argument("--train-per-class", type=int, default=24,
                        help="Train-split image count per class.")
    parser.add_argument("--test-per-class", type=int, default=12,
                        help="Test-split image count per class.")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    generate_demo_data(
        cfg.paths.processed_dir,
        train_subdir=cfg.data.train_subdir,
        test_subdir=cfg.data.test_subdir,
        train_per_class=args.train_per_class,
        test_per_class=args.test_per_class,
        size=cfg.data.image_size,
        classes=CLASSES,
    )
    print(f"Demo dataset ready under {cfg.paths.processed_dir} "
          f"({cfg.data.train_subdir}/ + {cfg.data.test_subdir}/).")


if __name__ == "__main__":
    main()
