"""Log repair: give val-phase records the preceding train step (thin CLI).

``python -m betavae_tpu_torch.scripts.fix_steps input.log output.log``,
the port's ``scripts/fix_steps.py``: ``eval/logs.py::rewrite_val_steps``;
prints how many val lines it rewrote.  Host only.
"""

from __future__ import annotations

import sys

from ..eval.logs import rewrite_val_steps


def fix_steps(input_path: str, output_path: str) -> int:
    return rewrite_val_steps(input_path, output_path)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) != 2:
        print("usage: python -m betavae_tpu_torch.scripts.fix_steps "
              "input.log output.log")
        return 1
    n = fix_steps(*args)
    print(f"Rewrote {n} val-phase step value(s) -> {args[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
