"""Rank functions of ``test_torch_port_parallel.py`` that look inside a step.

A spawned rank imports its function by module name, so this module imports
the port alone, never JAX or the JAX package.  :func:`record_steps` runs a
``parallel.dryrun.Case`` as the dry run does and keeps, from its first
step, the rank's augmented rows and ε (the step's own calls, looked at on
their way) and the gradients after the sync, before the clip.
"""

import contextlib
from unittest import mock

from betavae_tpu_torch.ops import elbo
from betavae_tpu_torch.parallel.dryrun import case_step, take_steps
from betavae_tpu_torch.parallel.launch import param_checksum, train_rank
from betavae_tpu_torch.train import step as step_module


@contextlib.contextmanager
def _recording(record: dict):
    """Keep the first step's augmented images and ε in ``record``."""
    augment, fused = step_module.apply_augment, step_module.fused_reparam_kl

    def augment_rec(*args, **kw):
        x = augment(*args, **kw)
        record.setdefault("x", x.detach().cpu().numpy())
        return x

    def fused_rec(mu, logvar, seed, offset, start=0):
        if "eps" not in record:
            record["eps"] = elbo.reparam_kl_forward(
                mu.detach(), logvar.detach(), seed, offset, start)[2] \
                .cpu().numpy()
        return fused(mu, logvar, seed, offset, start)

    with mock.patch.object(step_module, "apply_augment", augment_rec), \
            mock.patch.object(step_module, "fused_reparam_kl", fused_rec):
        yield


def record_steps(mesh, case) -> dict:
    """``case`` on this rank of ``mesh`` (one process when None): ``totals``
    a step, the first step's ``metrics``, ``grads`` (by parameter name),
    ``x`` and ``eps`` (this rank's rows), the final ``state`` (parameters
    and buffers) and ``checksum``."""
    model, optimizer, step = case_step(mesh, case)
    names = {p: n for n, p in model.named_parameters()}
    record: dict = {}
    update = optimizer.step

    def update_recording(lr: float) -> None:
        if "grads" not in record:
            record["grads"] = {names[p]: p.grad.detach().float().cpu()
                               .numpy().copy()
                               for p in names if p.grad is not None}
        update(lr)

    optimizer.step = update_recording
    with _recording(record):
        metrics = take_steps(mesh, case, step)
    return {"totals": [m["total"] for m in metrics], "metrics": metrics[0],
            **record,
            "state": {k: v.detach().float().cpu().numpy()
                      for k, v in model.state_dict().items()},
            "checksum": param_checksum(model)}


@contextlib.contextmanager
def host_launched(threads: set):
    """The path of one of several NCCL ranks, on gloo CPU ranks:
    ``dispatch_way`` says ``cuda_graph`` and a stand-in takes the place of
    ``chunks.CudaGraphs``, whose launch runs the captured body's Python
    (the gloo collectives inside) with the kernel counts put back, so
    that the run's queue of device work runs on its dispatcher thread (two
    ranks).  ``threads`` gathers the names of the threads that launch."""
    import threading

    from betavae_tpu_torch.train import chunks, loop

    class Graph:
        def __init__(self, body):
            self.body = body

        def replay(self):
            threads.add(threading.current_thread().name)
            before = chunks._counts()
            self.body()
            chunks._set_counts(before)

    class StubGraphs:
        def __init__(self, device):
            pass

        def warm_up(self, run):
            run()

        def capture(self, body):
            body()
            return Graph(body)

        def synchronize(self):
            pass

    with mock.patch.object(loop, "dispatch_way",
                           lambda *args, **kwargs: "cuda_graph"), \
            mock.patch.object(chunks, "CudaGraphs", StubGraphs):
        yield


def record_and_train(mesh, cases: list, trains: list) -> tuple:
    """One launch's work on a rank: :func:`record_steps` of each of
    ``cases``, then ``train_rank`` of each ``(config, resume,
    host_launched)`` of ``trains`` on the CPU, on the path of
    :func:`host_launched` where that is true (with the names of the
    threads that launched, ``launch_threads``)."""
    outs = []
    for path, resume, launched in trains:
        threads = set()
        with (host_launched(threads) if launched
              else contextlib.nullcontext()):
            out = train_rank(mesh, path, resume, "cpu")
        outs.append({**out, "launch_threads": sorted(threads)})
    return [record_steps(mesh, case) for case in cases], outs
