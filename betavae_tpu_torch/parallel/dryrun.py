"""One data-parallel train step of the flagship, checked against one process.

    python -m betavae_tpu_torch.parallel.dryrun N [--backend gloo]
        [--device cuda|cpu] [--devices cuda:0,cuda:0] [--image-size 128]

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``
(``_one_sharded_step``, ``_assert_replicas_identical``).  The flagship at
full width (128 px, latent 64, base 64, 4 SE blocks, GroupNorm(1), bf16
autocast, MSE + FFL 0.5, capacity objective, flip / 10° / brightness 0.1
augmentation), weights from seed 0, takes one step over an N-rank mesh on
a seeded batch (32 images on the card, 2 a rank on the CPU), and

- every replica's parameters after the update must be bitwise equal (a
  SHA-256 of the parameters' bytes from each rank),
- the mesh's loss must match one process's step on the same batch from
  the same weights within 2e-3 relative (the JAX dry run's tolerance
  under bf16: the two sum in another order, and the rank's batch of B / N
  may take other convolution algorithms).

The step runs eagerly, over NCCL too: a run of one step has K = min(K,
1) = 1 in the trainers' chunk plan, and the JAX dry run's step is one
call, not a scanned chunk.

It prints one JSON line and exits non-zero on a failed check.  The default
devices are the first N CUDA devices over NCCL; ``--device cpu`` runs N
CPU ranks over gloo; ``--devices`` names each rank's device, and ranks
that share a card need ``--backend gloo``.

:func:`run_steps` is the rank function behind it: it runs a
:class:`Case` (the flagship, or a config file) for a few steps, built by
:func:`case_step` and driven by :func:`take_steps`, which the tests use
to look inside a step.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

LOSS_RTOL = 2e-3
FLAGSHIP_SCHED = {"beta": 1.0, "capacity": 30.0, "capacity_weight": 1.0,
                  "free_bits": 0.0, "lr": 5e-4}
FLAGSHIP_AUG = {"use_flip": True, "degrees": 10.0, "brightness_range": 0.1}


@dataclass
class Case:
    """Steps to run: ``images`` uint8 ``(N, H, W, 1)``, global ``(idx,
    mask)`` numpy batches and a schedule dict each.  The model, loss and
    optimizer are the config file's at ``config`` (with its
    ``loss.lpips_weights_path`` when LPIPS is on), else the flagship at
    ``image_size`` with the flagship config's optimizer."""

    images: np.ndarray
    batches: list
    scheds: list
    config: str | None = None
    image_size: int = 128
    seed: int = 1
    device: str = "cpu"


def _parts(case: Case, device: torch.device):
    """``(model, optimizer, spec, aug_kwargs, use_capacity, lpips_fn)``."""
    from ..bench import FLAGSHIP_CONFIG, flagship_model
    from ..config import get, get_config, reset_config_cache
    from ..data.augment import augment_config_kwargs
    from ..models.beta_vae import model_from_config
    from ..models.losses import LossSpec, loss_spec_from_config
    from ..ops.lpips import build_lpips_fn
    from ..train.optim import build_optimizer
    from ..train.schedules import resolve_total_epochs, schedules_from_config

    reset_config_cache()
    if case.config is None:
        model = flagship_model(case.image_size, mixed_precision=True,
                               device=device)
        optimizer = build_optimizer(model.parameters(),
                                    get_config(str(FLAGSHIP_CONFIG)))
        spec = LossSpec(recon_loss_type="mse", use_ffl=True, ffl_weight=0.5,
                        ffl_alpha=1.0)
        return model, optimizer, spec, FLAGSHIP_AUG, True, None
    cfg = get_config(case.config)
    model = model_from_config(cfg, device=device)
    optimizer = build_optimizer(model.parameters(), cfg)
    spec = loss_spec_from_config(cfg)
    loss_cfg = get(cfg, "loss", None)
    lpips_fn = None
    if spec.use_lpips and spec.lpips_weight > 0:
        lpips_fn = build_lpips_fn(get(loss_cfg, "lpips_weights_path", None),
                                  device)
    _, cap_sched = schedules_from_config(
        cfg, total_epochs=resolve_total_epochs(cfg))
    use_capacity = (cap_sched.enabled
                    and get(loss_cfg, "capacity_weight", None) is not None)
    return (model, optimizer, spec, augment_config_kwargs(cfg), use_capacity,
            lpips_fn)


def case_step(mesh, case: Case):
    """``(model, optimizer, step)``: ``case``'s model and optimizer on this
    rank's device (``case.device`` without a mesh) and its train step over
    ``mesh``."""
    from ..train.step import make_train_step

    device = torch.device(case.device) if mesh is None else mesh.device
    model, optimizer, spec, aug, use_capacity, lpips_fn = _parts(case, device)
    step = make_train_step(model, optimizer, spec, aug_kwargs=aug,
                           use_capacity=use_capacity, seed=case.seed,
                           lpips_fn=lpips_fn, mesh=mesh)
    return model, optimizer, step


def _aug_kwargs(case: Case) -> dict:
    """``case``'s augmentation: the flagship's, or its config file's."""
    from ..config import get_config
    from ..data.augment import augment_config_kwargs

    if case.config is None:
        return FLAGSHIP_AUG
    return augment_config_kwargs(get_config(case.config))


def take_steps(mesh, case: Case, step) -> list:
    """Each of ``case``'s steps through ``step``, on this rank's rows of
    its batch under ``mesh``: the metrics of each, as floats."""
    from ..train.step import draw_step_augment

    device = torch.device(case.device) if mesh is None else mesh.device
    images = torch.from_numpy(case.images).to(device)
    aug, generator = _aug_kwargs(case), torch.Generator(device=device)
    metrics = []
    for k, ((idx, mask), sched) in enumerate(zip(case.batches, case.scheds)):
        draws = draw_step_augment(generator, case.seed, k + 1, len(idx), aug)
        if mesh is not None:
            rows = mesh.rows(len(idx))
            idx, mask = idx[rows], mask[rows]
        out = step(images, torch.from_numpy(np.asarray(idx, np.int64))
                   .to(device), torch.from_numpy(mask).to(device), sched,
                   k + 1, draws)
        metrics.append({name: float(v) for name, v in out.items()})
    return metrics


def run_steps(mesh, case: Case) -> dict:
    """Run ``case`` on this rank of ``mesh`` (one process when None):
    ``totals`` a step and the ``checksum`` of the parameters after."""
    from .launch import param_checksum

    model, _, step = case_step(mesh, case)
    totals = [m["total"] for m in take_steps(mesh, case, step)]
    return {"totals": totals, "checksum": param_checksum(model)}


def flagship_case(batch: int, image_size: int = 128,
                  device: str = "cpu") -> Case:
    """One step of the flagship over ``batch`` seeded images."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2 * batch, image_size, image_size, 1),
                          np.uint8)
    return Case(images=images,
                batches=[(np.arange(batch, dtype=np.int32),
                          np.ones(batch, np.float32))],
                scheds=[dict(FLAGSHIP_SCHED)], image_size=image_size,
                device=device)


def dryrun_case(devices, batch: int | None = None,
                image_size: int = 128) -> Case:
    """The dry run's step: the flagship over ``batch`` images (default 32
    on the card, 2 a rank on the CPU)."""
    on_card = torch.device(str(devices[0])).type == "cuda"
    batch = batch or (32 if on_card else 2 * len(devices))
    return flagship_case(batch, image_size, device=str(devices[0]))


def dryrun_check(ranks: list, case: Case, devices, backend: str) -> dict:
    """The dry run's line from the ranks' :func:`run_steps` of ``case``
    and the single process's; raises ``RuntimeError`` on a failed check."""
    single = run_steps(None, case)
    sums = [r["checksum"] for r in ranks]
    total, total_1 = ranks[0]["totals"][0], single["totals"][0]
    rel = abs(total - total_1) / max(abs(total_1), 1e-9)
    line = {"dryrun": "data_parallel", "devices": [str(d) for d in devices],
            "backend": backend, "image_size": case.image_size,
            "global_batch": len(case.batches[0][0]),
            "loss": total, "single_process_loss": total_1,
            "loss_rel": rel, "loss_rtol": LOSS_RTOL,
            "replicas_bitwise_equal": len(set(sums)) == 1,
            "rank_totals": [r["totals"][0] for r in ranks]}
    if not (np.isfinite(total) and line["replicas_bitwise_equal"]
            and rel < LOSS_RTOL):
        raise RuntimeError(f"data-parallel dry run failed: {line}")
    return line


def dryrun(devices, backend: str | None = None,
           image_size: int = 128) -> dict:
    """The dry run over ``devices`` (one rank each): returns its line and
    raises ``RuntimeError`` on a failed check."""
    from .launch import run_on_mesh
    from .mesh import resolve_backend

    devices = [str(d) for d in devices]
    backend = resolve_backend([torch.device(d) for d in devices], backend)
    case = dryrun_case(devices, image_size=image_size)
    ranks = run_on_mesh(run_steps, devices, (case,), backend=backend)
    return dryrun_check(ranks, case, devices, backend)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m betavae_tpu_torch.parallel.dryrun")
    parser.add_argument("n", type=int, help="ranks")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--devices", default=None,
                        help="comma-separated device of each rank")
    parser.add_argument("--image-size", type=int, default=128)
    args = parser.parse_args(argv)
    from .mesh import mesh_devices

    devices = (args.devices.split(",") if args.devices
               else mesh_devices(args.n, args.device))
    if len(devices) != args.n:
        parser.error(f"{args.n} ranks but {len(devices)} devices named")
    line = dryrun(devices, args.backend, args.image_size)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as err:
        print(err, file=sys.stderr)
        sys.exit(1)
