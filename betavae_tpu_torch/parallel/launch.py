"""Start the ranks of a data mesh, one process each, and collect them.

:func:`launch` runs ``fn(mesh, *args)`` in ``world`` spawned processes,
each joined to the mesh through a ``FileStore`` in a fresh directory under
``$TMPDIR``, and returns the ranks' results in rank order.  A rank that
raises fails the launch: the others are stopped (a peer left waiting in a
collective would never return) and the rank's traceback is raised here.
The CUDA kernels are built once in the calling process first, so that the
ranks do not start one ``nvcc`` each.  ``fn`` must be importable by name
(a module-level function), since a spawned rank imports it afresh.  :func:`run_on_mesh` runs a one-rank mesh in the calling
process instead, and :func:`train_rank` is the trainers' rank function.
SIGTERM to the launcher is passed on to the ranks, whose trainers drain
rank 0's checkpoint writer before they exit.
"""

from __future__ import annotations

import hashlib
import os
import queue as queue_mod
import shutil
import signal
import tempfile
import threading
import traceback

import torch
import torch.multiprocessing as mp

from .mesh import data_parallel_mesh

# how often the launcher looks at its ranks while it waits for results
_POLL_SECONDS = 0.5
# how long the launcher waits for ranks to drain after SIGTERM
_DRAIN_SECONDS = 120.0


def _forward_sigterm(procs: list):
    """On the main thread, make SIGTERM reach every rank and raise
    ``KeyboardInterrupt`` here; returns the handler to put back."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def on_sigterm(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)
        raise KeyboardInterrupt("SIGTERM")

    return signal.signal(signal.SIGTERM, on_sigterm)


def _rank_main(rank: int, devices: list, backend, init: str, threads,
               fn, args: tuple, results) -> None:
    mesh = None
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = data_parallel_mesh(devices=devices, backend=backend, rank=rank,
                                  init_method=init)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            mesh.close()


def launch(fn, devices, args: tuple = (), *,
           backend: str | None = None) -> list:
    """``[fn(mesh_r, *args) for each rank r]``, each in its own process.

    ``devices`` names each rank's device, in rank order (``["cuda:0",
    "cuda:1"]``, ``["cpu", "cpu"]``); ``backend`` as in
    :func:`.mesh.data_parallel_mesh`, which checks both in every rank.
    CPU ranks share this process's cores (with more threads than cores,
    each rank's step waits on the others' spinning threads).  Results
    cross back pickled: return numbers and numpy arrays, not tensors (a
    tensor would cross through shared memory that the rank takes with it
    when it exits).
    """
    devices = [str(d) for d in devices]
    threads = None
    if any(torch.device(d).type == "cuda" for d in devices):
        from .. import _build

        _build.build()
    else:
        threads = max(1, len(os.sched_getaffinity(0)) // len(devices))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="betavae_dp_")
    init = "file://" + os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main, name=f"betavae-dp-rank{r}",
                         args=(r, devices, backend, init, threads, fn, args,
                               results), daemon=False)
             for r in range(len(devices))]
    outs, error = {}, None
    old_sigterm = _forward_sigterm(procs)
    try:
        for p in procs:
            p.start()
        while len(outs) < len(procs) and error is None:
            try:
                rank, ok, value = results.get(timeout=_POLL_SECONDS)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    error = (f"rank process {dead[0].name} exited with code "
                             f"{dead[0].exitcode} before reporting")
                continue
            if ok:
                outs[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
        if error is None:
            for p in procs:
                p.join()
                if p.exitcode != 0:
                    error = (f"rank process {p.name} exited with code "
                             f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive() and error is not None:
                p.terminate()
            p.join(_DRAIN_SECONDS)
            if p.is_alive():
                p.kill()
                p.join()
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"data-parallel launch over {devices}: {error}")
    return [outs[r] for r in range(len(procs))]


def run_on_mesh(fn, devices, args: tuple = (), *,
                backend: str | None = None) -> list:
    """:func:`launch`, but a one-rank mesh runs ``fn`` in this process
    (no spawn; its result may then be any value)."""
    if len(devices) != 1:
        return launch(fn, devices, args, backend=backend)
    mesh = data_parallel_mesh(devices=[str(d) for d in devices],
                              backend=backend, rank=0)
    try:
        return [fn(mesh, *args)]
    finally:
        mesh.close()


def param_checksum(model: torch.nn.Module) -> str:
    """SHA-256 of the parameters' bytes: equal on two replicas only when
    every parameter is bitwise equal."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_launches() -> dict:
    """This process's launch counts of the hand-written kernels (a spawned
    rank's count is its run's), the head's and the upsample's by path."""
    from ..ops.elbo import fused_reparam_kl, reparam_kl_backward
    from ..ops.gn import gn_backward, gn_forward
    from ..ops.head import head_forward, head_m
    from ..ops.upsample import upsample2x_backward, upsample2x_forward

    wrappers = {"fused_reparam_kl": fused_reparam_kl,
                "reparam_kl_backward": reparam_kl_backward,
                "head_forward": head_forward, "head_m": head_m,
                "gn_forward": gn_forward, "gn_backward": gn_backward,
                "upsample_forward": upsample2x_forward,
                "upsample_backward": upsample2x_backward}
    out = {name: w.launches for name, w in wrappers.items()}
    for key, names in (("head_by_path", ("head_forward", "head_m")),
                       ("upsample_by_path", ("upsample_forward",
                                             "upsample_backward"))):
        out[key] = {name: dict(wrappers[name].launches_by_path)
                    for name in names}
    return out


def train_rank(mesh, config_path: str, resume: str = "none",
               device: str = "cuda", max_steps: int | None = None) -> dict:
    """One rank of ``python -m betavae_tpu_torch.train --data-parallel N``:
    :func:`..train.loop.train` (or :func:`..train.loop.train_steps` with
    ``max_steps``) over ``mesh``, with the config and the logger read
    afresh.  Returns the run's host numbers, the parameters' checksum and
    the process's kernel launches."""
    from ..config import reset_config_cache
    from ..logging_utils import reset_logger
    from ..train.loop import train, train_steps

    reset_config_cache()
    reset_logger()
    try:
        if max_steps is not None:
            out = train_steps(config_path, max_steps, device=device,
                              mesh=mesh)
            summary = {k: out[k] for k in ("steps", "totals", "timed_steps",
                                           "timed_seconds", "batch_size")}
        else:
            out = train(config_path, resume=resume, device=device, mesh=mesh)
            summary = {"epoch": out["epoch"],
                       "total_steps": out["total_steps"],
                       "checkpoint_writes": out["checkpoint_writes"]}
        return {**summary, "checksum": param_checksum(out["model"]),
                "launches": kernel_launches()}
    finally:
        reset_logger()
        reset_config_cache()

