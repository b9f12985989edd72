"""``python -m betavae_tpu_torch.train --config CONFIG --max-steps N``."""

from __future__ import annotations

import argparse

from .loop import train_steps


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m betavae_tpu_torch.train")
    parser.add_argument("--config", required=True)
    parser.add_argument("--max-steps", type=int, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    train_steps(args.config, args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
