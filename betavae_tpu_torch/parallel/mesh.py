"""The data-parallel mesh: a rank's place in its process group.

Counterpart of ``betavae_tpu/parallel/mesh.py``.  The JAX package builds a
1-D ``data`` mesh over the local devices; one program runs over the batch
sharded along it (``P("data")``) and XLA inserts the collectives.  Here
each rank is a process with one device, and :func:`data_parallel_mesh`
joins it to the group: the default process group of ``torch.distributed``,
NCCL over one CUDA device a rank, gloo on the CPU, set up through a
``FileStore`` (no network).  The rows of the global batch are split as
``P("data")`` splits them, contiguously: rank ``r`` of ``W`` holds rows
``[r·B/W, (r+1)·B/W)`` (:meth:`DataParallelMesh.rows`).  Parameters and
optimizer state are replicated; the train step forms every batch
reduction over the group and averages the gradients with one all-reduce
(:mod:`.reduce`).

Ranks are started by :func:`.launch.launch`, which names each rank and
its rendezvous; a one-rank mesh is joined in the calling process.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

# how long a rank waits in a collective for the others before raising
TIMEOUT = timedelta(minutes=10)


@dataclass
class DataParallelMesh:
    """Rank ``rank`` of ``world``, on ``device``; ``group`` is the process
    group."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: object
    # the FileStore's directory when this process made it (a one-rank mesh)
    store_dir: str | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, panels and logs."""
        return self.rank == 0

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        if batch_size % self.world:
            raise ValueError(
                f"training.batch_size ({batch_size}) must divide evenly over "
                f"the {self.world}-device data mesh")
        b = batch_size // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def close(self) -> None:
        """Leave the group (the default process group is destroyed)."""
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None


def _resolve_devices(n_devices, devices) -> list:
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("devices= names no device")
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             f"devices were named")
        return devices
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None or n_devices < 0 else int(n_devices)
    if n > visible or n < 1:
        # never truncate, never move to the CPU: the caller believes it runs
        # n-way data parallel with B/n rows a device
        raise ValueError(
            f"requested a {n}-device data mesh but only {visible} CUDA "
            f"device(s) are visible; name the devices (devices=[...]) to run "
            f"ranks on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def resolve_backend(devices: list, backend) -> str:
    """``backend`` checked against ``devices`` (``torch.device`` each), or
    the default for them: NCCL on distinct CUDA devices, gloo on the
    CPU; ranks sharing a CUDA device must name gloo."""
    kinds = {d.type for d in devices}
    if not kinds <= {"cuda", "cpu"} or len(kinds) != 1:
        raise ValueError(f"a data mesh runs on CUDA devices or on the CPU, "
                         f"not {[str(d) for d in devices]}")
    shared = len({(d.type, d.index) for d in devices}) < len(devices)
    if backend is None:
        if "cpu" in kinds:
            return "gloo"
        if shared:
            names = [str(d) for d in devices]
            raise ValueError(
                f"ranks that share a CUDA device ({names}) need "
                f"backend='gloo' named by the caller: NCCL refuses two ranks "
                f"on one GPU")
        return "nccl"
    if backend == "nccl" and ("cpu" in kinds or shared):
        raise ValueError(f"NCCL takes one CUDA device a rank, got "
                         f"{[str(d) for d in devices]}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    return backend


def data_parallel_mesh(n_devices: int | None = None, devices=None,
                       backend: str | None = None, *, rank: int | None = None,
                       init_method: str | None = None) -> DataParallelMesh:
    """Join this process to a data mesh as rank ``rank`` and return it.

    ``devices`` names each rank's device in rank order (``cuda:0``, or
    ``cpu``); by default the first ``n_devices`` visible CUDA devices (all
    of them when ``n_devices`` is None or negative), and asking for more
    than are visible raises.  ``backend`` defaults to NCCL on CUDA devices
    and gloo on the CPU; ranks that share one CUDA device need
    ``backend="gloo"``.  A rank of a mesh of several is named by
    ``rank`` and meets the others at ``init_method`` (a ``file://`` path),
    as :func:`.launch.launch` passes them; a one-rank mesh needs neither
    and makes a store of its own.
    """
    devices = _resolve_devices(n_devices, devices)
    world = len(devices)
    backend = resolve_backend(devices, backend)
    own_store = world == 1 and init_method is None
    if own_store:
        rank = 0 if rank is None else rank
    elif rank is None or init_method is None:
        raise RuntimeError(
            f"a {world}-rank data mesh is joined from each rank's own "
            f"process, with its rank= and init_method=: start the ranks "
            f"with betavae_tpu_torch.parallel.launch.launch")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a {world}-rank mesh")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group: "
                           "close() the earlier mesh first")
    store_dir = None
    if own_store:
        # a store of one's own, in a fresh directory under $TMPDIR
        store_dir = tempfile.mkdtemp(prefix="betavae_dp_")
        init_method = "file://" + os.path.join(store_dir, "store")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return DataParallelMesh(rank=rank, world=world, device=device,
                            backend=backend, group=dist.group.WORLD,
                            store_dir=store_dir)


def mesh_devices(n: int, device: str = "cuda") -> list:
    """The devices of an ``n``-rank mesh for a command line's
    ``--data-parallel n --device device``: the first ``n`` CUDA devices
    (all of them for ``n`` < 0; more than are visible raises), or ``n``
    ranks on the CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        if n < 1:
            raise ValueError(f"--data-parallel {n} on the CPU: name a rank "
                             f"count of at least 1")
        return ["cpu"] * n
    return [str(d) for d in _resolve_devices(None if n < 0 else n, None)]
