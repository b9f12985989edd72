"""Convert the official LPIPS (AlexNet) torch weights to the ``.npz`` the
LPIPS term loads.

``python -m betavae_tpu_torch.scripts.convert_lpips_weights --alexnet
alexnet-owt-7be5be79.pth --linear alex.pth [--out weights/lpips_alex.npz]``,
the port's ``scripts/convert_lpips_weights.py``: ``ops/lpips.py::convert``
writes the same keys and layout (kernels HWIO, ``lin{i}`` flat), which
either package reads through ``loss.lpips_weights_path`` or
``$LPIPS_WEIGHTS``.  Nothing is downloaded.  Host only.
"""

from __future__ import annotations

import argparse

from ..ops.lpips import convert


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.scripts.convert_lpips_weights",
        description="Convert official LPIPS torch weights to npz.")
    parser.add_argument("--alexnet", required=True,
                        help="torchvision AlexNet state dict (.pth)")
    parser.add_argument("--linear", required=True,
                        help="lpips alex.pth linear-head state dict")
    parser.add_argument("--out", default="weights/lpips_alex.npz")
    args = parser.parse_args(argv)
    out = convert(args.alexnet, args.linear, args.out)
    print(f"Wrote {out}; set loss.lpips_weights_path: {out} "
          "(or LPIPS_WEIGHTS env) to use it.")
    return out


if __name__ == "__main__":
    main()
