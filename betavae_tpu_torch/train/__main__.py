"""``python -m betavae_tpu_torch.train --config CONFIG [--resume
best|latest|none] [--device cuda|cpu] [--max-steps N]``.

Runs the full trainer, :func:`.loop.train`; with ``--max-steps`` the
few-step trainer :func:`.loop.train_steps` instead.
"""

from __future__ import annotations

import argparse

from .loop import train, train_steps


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m betavae_tpu_torch.train")
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default="none",
                        choices=("none", "best", "latest"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max-steps", type=int, default=None)
    args = parser.parse_args(argv)
    if args.max_steps is not None:
        if args.resume != "none":
            parser.error("--max-steps runs the few-step trainer, which does "
                         "not resume")
        train_steps(args.config, args.max_steps, device=args.device)
    else:
        train(args.config, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
