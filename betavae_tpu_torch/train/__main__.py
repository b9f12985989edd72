"""``python -m betavae_tpu_torch.train --config CONFIG [--resume
best|latest|none] [--device cuda|cpu] [--max-steps N] [--data-parallel N]``.

Runs the full trainer, :func:`.loop.train`; with ``--max-steps`` the
few-step trainer :func:`.loop.train_steps` instead.  ``--data-parallel N``
trains data-parallel over N ranks, one process and one device each, as
``scripts/train.py --data-parallel`` does over a JAX mesh: the first N
CUDA devices over NCCL (``-1``: every visible one; more than are visible
raises), or with ``--device cpu`` N ranks on the CPU over gloo.  The
command exits non-zero when any rank fails.
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
    parser.add_argument("--data-parallel", type=int, default=0, metavar="N",
                        help="train data-parallel over N ranks (0: one "
                             "process; -1: every visible CUDA device)")
    args = parser.parse_args(argv)
    if args.max_steps is not None and args.resume != "none":
        parser.error("--max-steps runs the few-step trainer, which does "
                     "not resume")
    if args.data_parallel:
        from ..parallel.launch import run_on_mesh, train_rank
        from ..parallel.mesh import mesh_devices

        devices = mesh_devices(args.data_parallel, args.device)
        print(f"[MESH] data-parallel over {len(devices)} device(s): "
              f"{', '.join(devices)}", flush=True)
        run_on_mesh(train_rank, devices, (args.config, args.resume,
                                          args.device, args.max_steps))
    elif args.max_steps is not None:
        train_steps(args.config, args.max_steps, device=args.device)
    else:
        train(args.config, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
