"""K train steps a dispatch, and a validation pass a dispatch, as launches
of one captured step that return at once.

Counterpart of ``make_train_multi_step`` and ``make_eval_multi_step`` in
``betavae_tpu/train/loop.py``, where ``lax.scan`` runs K steps (or every
validation batch) in one XLA program and ``dispatch_chunk`` launches it as
one asynchronous call.  On the GPU one host dispatch of many steps is a
CUDA graph: :class:`TrainChunks` captures one train step that reads its
inputs from slot ``j`` of static device buffers, ``j`` a device counter the
step itself advances, and launches it once a step.  For a chunk of n ≤ K
steps the host

- writes the n steps' batch indices, masks, schedule rows ``(β, C,
  C-weight, free bits, lr)`` and ε offsets (the step numbers) into one
  pinned record buffer and uploads it in one copy,
- draws the n steps' augmentation uniforms on the card, each from the
  generator seeded from ``(seed, step)`` as the eager step seeds it, into a
  ``[K, 3, B]`` slot buffer (a graph replays one seed and offset of a
  generator, so these small launches go ahead of the steps),
- launches the graph n times, and copies the n rows of metrics it wrote
  (the 10 scalar metrics of ``step.scalar_metrics`` and the epoch's running
  sums after the step) to the host in one copy, read once, when the caller
  drains the chunk.

None of these waits for the card, so a chunk's dispatch returns while the
chunks before it run, as the JAX loop's does.  For that the graph is
launched from the device (:class:`DeviceLaunched`,
``csrc/graph_launch.cu``): a host launch of a graph of ~820 kernels waits
for room in the launch queue once the queue is full (behind a running
chunk, 182 host launches of the step hold the host until the device has
run most of them: ``chip_smoke.py``'s ``one_launch``), where the one-kernel
graph that tail-launches it is queued at once.  A process that is one of
several ranks launches from the host (:func:`_several_ranks`): its step
holds NCCL's kernels, which a graph instantiated for device launch
refuses.  There the launches wait for room in the launch queue on a
dispatcher thread, not on the caller's: each dispatch is a job of the
run's FIFO queue of device work (:class:`..device.DeviceQueue`, made by
:func:`device_queue`), :meth:`TrainChunks.dispatch` its chunk's host-fed
staging, upload, draws, launches and copy to the host, the trainer's
validation pass its staging, launches, all-gather and copy; one thread
runs the jobs in order, and the dispatch returns at once, as JAX's host
call queues its program and returns.  Elsewhere a job runs at once on the
caller's thread, and nothing changes.  PyTorch's ``CUDAGraph.replay``
drops the GIL while it waits for room (its binding releases it), so the
caller runs on meanwhile: ``chip_smoke.py``'s ``one_launch`` times a
dispatch behind a running chunk with the dispatcher still launching, and
no C entry of ours is needed for the host launch.

The ordering rule.  Device work that the caller enqueues before it
submits a job stays ahead of that job's (the epoch's
:meth:`TrainChunks.reset_running`, the panel forward,
:meth:`StateSnapshot.take <.callbacks.StateSnapshot.take>`).  Device work
that it enqueues after a submit first waits for the queue to drain
(:meth:`..device.DeviceQueue.fence`), unless it touches nothing that a
queued job reads or writes: :meth:`Pending.rows` of an earlier job and
``StateSnapshot.pull`` (a side stream behind the take's event) do not
fence; ``StateSnapshot.restore`` (the snapshot's fence), the eager
collectives of ``parallel/reduce.py`` (:func:`..device.
fence_device_queues`: NCCL needs every rank to issue its collectives on a
communicator in one order, and two threads issuing them in turn hang the
mesh), ``StepProfiler.maybe_start`` and ``stop`` (both synchronise the
device), :meth:`TrainChunks.prepare` and :meth:`EvalChunks.prepare` (a
capture), and the trainers' ends (``DeviceQueue.close``, on SIGTERM too)
do.  A job's failure is raised from the next fence, read or submit, and
from the trainer; no later job runs.

:class:`EvalChunks` does the same for the validation pass: one captured
batch, launched once a batch, and one read of every batch's metrics and μ.

A chunk's dispatch is the span ``dispatch.chunk`` of
:data:`..utils.profiling.SPANS`, with a pair of CUDA events on its stream,
and its parts the host spans ``dispatch.stage``, ``dispatch.upload``,
``dispatch.draws`` and ``dispatch.launch``; every launch of a captured
graph is counted (``graphs.device_launches``, ``graphs.host_launches``),
and so are the kernel launches it holds by path, of each wrapper that
gives its kernels a call on each path (``kernels_by_path``), as
``<module>.<path>_launches``: ``gn.cluster_launches`` and
``gn.generic_launches``, the GN kernels of ``ops/gn.py`` that the capture
recorded, each launch of the graph adding them; and the calls of a
library's kernels that the model counts (``utils/profiling.py::
library_call``), as ``<key>_launches``: ``gn.library_launches``, the
GroupNorms that the port's GN kernels do not run, and
``attn.<backend>_launches``, the attention calls by the backend that ran.

The captured step is the eager step (``make_train_step`` with its slot's
values as device tensors), so a chunk computes bitwise what the steps one by
one do.  It gathers its images from one tensor, the resident split or, fed
from the host, the static buffer each chunk's batches are uploaded to
(``data/pipeline.py``); over an NCCL mesh its collectives (the gradient
all-reduce, the global sums) are kernels inside the graph.
``graphs=False`` runs the same slots eagerly, one step after the other,
with no graph: on the CPU, with ``training.scan_chunk_steps: 1``, and over
a gloo mesh, whose collectives are host calls.  A capture or launch that
fails raises: there is no fallback to eager steps.

Capture (:meth:`TrainChunks.prepare`, :meth:`EvalChunks.prepare`) runs the
body a few times on a side stream first (cuDNN and cuBLAS handles, the
optimizer's state, the kernel libraries, NCCL's communicator), then puts
back every parameter, buffer, optimizer moment and step count from
:attr:`TrainChunks.snapshot`, so the warm-up leaves no trace in the
training state, and captures under the caller's cuDNN setting
(``device.deterministic_cudnn``).
The kernel wrappers count their launches in Python, which a launch of the
graph does not run, and which a capture runs without launching anything:
each wrapper's count, by path, is read before and after the capture, put
back to what it was before, and the difference is added at each launch.
The warm-up's launches ran on the card and stay counted: a captured run
launches each kernel ``CAPTURE_WARMUP`` steps' worth more than its steps
do.
"""

from __future__ import annotations

import ctypes
import functools
import time
import weakref

import numpy as np
import torch

from .. import _build
from ..device import DeviceQueue, Job, raw_stream
from ..ops import kernel_wrappers
from ..utils.profiling import LIBRARY_CALLS, _Tracing, count, span
from .callbacks import StateSnapshot
from .step import draw_step_augment

SCHED_KEYS = ("beta", "capacity", "capacity_weight", "free_bits", "lr")
# step.scalar_metrics' keys; the first six are the epoch's running sums
METRIC_KEYS = ("total", "recon", "recon_base", "recon_lpips", "recon_ffl",
               "kl_mean", "kl_effective", "kl_per_dim_mean", "mu_mean_batch",
               "z_std_batch")
RUNNING_KEYS = METRIC_KEYS[:6]
# the eager runs of the step before its capture
CAPTURE_WARMUP = 2


def chunk_plan(n_steps: int, k_cfg: int) -> tuple:
    """``(K, sizes)`` of an epoch of ``n_steps`` steps, as the JAX loop
    plans it: K = max(1, min(k_cfg, n_steps)), as many chunks of K as fit,
    and the remainder one step a chunk (the JAX loop's single-step
    program)."""
    k = max(1, min(int(k_cfg), int(n_steps)))
    return k, [k] * (n_steps // k) + [1] * (n_steps % k)


def _counts() -> dict:
    return {name: (w.launches, dict(getattr(w, "launches_by_path", {})))
            for name, w in kernel_wrappers().items()}


def _set_counts(counts: dict) -> None:
    for name, w in kernel_wrappers().items():
        w.launches = counts[name][0]
        if hasattr(w, "launches_by_path"):
            w.launches_by_path.update(counts[name][1])


def _count_delta(before: dict, after: dict) -> dict:
    return {name: (after[name][0] - before[name][0],
                   {p: after[name][1][p] - before[name][1].get(p, 0)
                    for p in after[name][1]})
            for name in after}


def _add_counts(delta: dict, times: int) -> None:
    for name, w in kernel_wrappers().items():
        n, paths = delta[name]
        w.launches += n * times
        for p, k in paths.items():
            w.launches_by_path[p] += k * times


class _Slots:
    """``k`` slots of per-step inputs: each slot one record of ``fields``
    (``(name, dtype, shape)``) in a ``[k, record]`` byte buffer on the
    device, with a pinned twin on the host, so that the first n slots
    upload in one copy.  ``self.<name>`` is the device view ``[k, *shape]``
    of a field, ``self.host[<name>]`` the host view."""

    def __init__(self, k: int, fields, device: torch.device):
        offsets, at = {}, 0
        for name, dtype, shape in fields:
            size = torch.empty((), dtype=dtype).element_size()
            nbytes = size * int(np.prod(shape, dtype=np.int64))
            at = -(-at // size) * size
            offsets[name] = (at, nbytes, dtype, shape)
            at += nbytes
        record = -(-at // 8) * 8
        self.device = device
        self.buffer = torch.zeros((k, record), dtype=torch.uint8,
                                  device=device)
        self.staging = torch.zeros((k, record), dtype=torch.uint8,
                                   pin_memory=device.type == "cuda")
        self.host = {}
        for name, (at, nbytes, dtype, shape) in offsets.items():
            setattr(self, name, self._view(self.buffer, at, nbytes, dtype,
                                           shape))
            self.host[name] = self._view(self.staging, at, nbytes, dtype,
                                         shape)
        self._uploaded = None

    @staticmethod
    def _view(buf, at, nbytes, dtype, shape):
        return buf[:, at:at + nbytes].view(dtype).view(buf.shape[0], *shape)

    def writable(self) -> dict:
        """The host views, once the last upload has left the staging
        buffer."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
            self._uploaded = None
        return self.host

    def upload(self, n: int) -> None:
        self.buffer[:n].copy_(self.staging[:n], non_blocking=True)
        if self.device.type == "cuda":
            self._uploaded = torch.cuda.Event()
            self._uploaded.record()


class Pending:
    """Device rows on their way to the host (a dispatched chunk's metrics,
    a validation pass, a panel): copied into pinned memory behind the work
    queued so far, with an event; :meth:`rows` waits for that event alone
    and returns them as numpy."""

    def __init__(self, rows: torch.Tensor, meta=None):
        self.meta = meta
        self._event = None
        if rows.device.type == "cuda":
            self._host = torch.empty(rows.shape, dtype=rows.dtype,
                                     pin_memory=True)
            self._host.copy_(rows, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = rows.clone()

    def rows(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()


def _graph_library():
    """The C entries of ``csrc/graph_launch.cu``, with their argtypes."""
    lib = _build.load("graph_launch")
    ptr = ctypes.c_void_p
    lib.betavae_graph_device_instantiate.argtypes = [
        ptr, ctypes.POINTER(ptr), ctypes.POINTER(ptr)]
    lib.betavae_graph_launch.argtypes = [ptr, ptr]
    lib.betavae_graph_destroy.argtypes = [ptr, ptr]
    return lib


def _destroy(device: torch.device, target, launcher) -> None:
    with torch.cuda.device(device):
        rc = _graph_library().betavae_graph_destroy(target, launcher)
    if rc != 0:
        raise RuntimeError(f"destroying a device-launched graph failed "
                           f"with code {rc}")


class DeviceLaunched:
    """A captured graph launched from the device (``csrc/graph_launch.cu``):
    :meth:`replay` is one host launch of a one-kernel graph that
    tail-launches ``graph``, so it returns at once however full the launch
    queue is, and the stream's next work waits for ``graph`` to run.
    ``graph`` (``keep_graph=True``, captured) keeps the memory pool its
    nodes use.  The counter ``graphs.device_launches`` of
    :data:`..utils.profiling.SPANS` counts the launches from the device,
    ``graphs.host_launches`` every launch of a captured graph from the
    host.

    ``torch.profiler`` records no kernel of a graph launched from the
    device, and its CUDA tracing, once attached, fails a launch from the
    device of a graph instantiated before it (the context's next
    synchronising call reports an unspecified launch failure).  So while a
    session is open, from its preparation to its end
    (:class:`..utils.profiling._Tracing`),
    :meth:`replay` launches ``graph`` from the host (PyTorch's ``replay``,
    instantiated at its first call): the same kernels in the same order;
    and after a session, each graph is instantiated for device launch
    again before its next launch from the device (the counter
    ``graphs.reinstantiations`` and the span ``graphs.reinstantiate``)."""

    def __init__(self, graph, device: torch.device):
        self.graph, self.device = graph, device
        self._finalizer = None
        self._instantiate()

    def _instantiate(self) -> None:
        if self._finalizer is not None:
            self._finalizer()
        target, launcher = ctypes.c_void_p(), ctypes.c_void_p()
        self._generation = _Tracing.generation
        with torch.cuda.device(self.device):
            rc = _graph_library().betavae_graph_device_instantiate(
                ctypes.c_void_p(self.graph.raw_cuda_graph()),
                ctypes.byref(target), ctypes.byref(launcher))
        if rc != 0:
            raise RuntimeError(f"instantiating a graph for device launch "
                               f"failed with code {rc}")
        self._launcher = launcher
        self._finalizer = weakref.finalize(self, _destroy, self.device,
                                           target, launcher)

    def replay(self) -> None:
        if _Tracing.open or torch._C._autograd._profiler_enabled():
            self.graph.replay()
            count("graphs.host_launches")
            return
        if self._generation != _Tracing.generation:
            with span("graphs.reinstantiate"):
                self._instantiate()
            count("graphs.reinstantiations")
        rc = _graph_library().betavae_graph_launch(
            self._launcher, ctypes.c_void_p(raw_stream(self.device)))
        if rc != 0:
            raise RuntimeError(f"launching a device-launched graph failed "
                               f"with code {rc}")
        count("graphs.device_launches")


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream of ``device`` that every warm-up and capture runs on:
    each stream that runs a cuBLAS call gets a workspace of its own, which
    PyTorch keeps for the life of the process, so a new stream a trainer
    left memory allocated behind each captured run."""
    return torch.cuda.Stream(device)


def _several_ranks() -> bool:
    """Whether this process is one of several ranks of a data mesh.  Its
    captured step then holds NCCL's kernels between the ranks (a gloo mesh
    captures nothing), and instantiating such a graph for device launch
    fails (``cudaErrorInvalidValue`` on four H100s, ``chip_smoke.py
    --mesh``), so it is launched from the host."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def device_queue(device: torch.device, graphs: bool) -> DeviceQueue:
    """A run's queue of device work: run by a dispatcher thread where
    captured graphs launch from the host (``graphs`` in one of several
    ranks), else each job at once on the caller's thread."""
    return DeviceQueue(device, threaded=graphs and _several_ranks())


class CudaGraphs:
    """The CUDA graph calls of a chunked run on ``device``: a body run on a
    side stream, a body captured into a graph launched from the device
    (:class:`DeviceLaunched`) or, in one of several ranks, from the host
    (PyTorch's graph; ``replay()`` launches either), the device
    synchronised.  The CPU tests put a stand-in in its place."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        # the index the launches' stream is looked up by
        self.device = torch.device("cuda", torch.cuda.current_device()
                                   if device.index is None else device.index)
        self.side = _side_stream(self.device)

    def warm_up(self, run) -> None:
        """``run()`` on the side stream, then a device sync."""
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(self.side)
        self.synchronize()

    def capture(self, body):
        """A graph of one ``body()``, captured on the side stream."""
        from_host = _several_ranks()
        graph = torch.cuda.CUDAGraph(keep_graph=not from_host)
        with torch.cuda.graph(graph, stream=self.side,
                              capture_error_mode="thread_local"):
            body()
        return graph if from_host else DeviceLaunched(graph, self.device)

    def synchronize(self) -> None:
        torch.cuda.synchronize(self.device)


class _Captured:
    """A captured graph, each wrapper's launches a replay of it, and the
    seconds its capture took."""

    def __init__(self, graph, per_replay: dict, seconds: float,
                 library: dict | None = None):
        self.graph, self.per_replay, self.seconds = graph, per_replay, seconds
        # the kernel launches a replay holds by path, of the wrappers that
        # say how many kernels a call launches on each path, and the
        # library calls it holds
        self.kernel_launches = {f"{key}_launches": n
                                for key, n in (library or {}).items()}
        for name, w in kernel_wrappers().items():
            for path, k in getattr(w, "kernels_by_path", {}).items():
                key = f"{w.__module__.rsplit('.', 1)[-1]}.{path}_launches"
                self.kernel_launches[key] = self.kernel_launches.get(
                    key, 0) + k * per_replay[name][1][path]

    def replay(self, times: int) -> None:
        for _ in range(times):
            self.graph.replay()
        if not isinstance(self.graph, DeviceLaunched):
            count("graphs.host_launches", times)
        for key, n in self.kernel_launches.items():
            if n:
                count(key, n * times)
        _add_counts(self.per_replay, times)

    def launches(self) -> dict:
        """Each wrapper's launches a replay."""
        return {name: n for name, (n, _) in self.per_replay.items()}


class _Chunked:
    """What a chunked train run and a chunked validation pass share: ``k``
    slots of (batch indices, mask, schedule row, noise offset) uploaded in
    one copy, a ``[k, width]`` row a slot for the results, the slot
    counter ``j``, and with ``graphs`` the captured body (``captured``,
    None until :meth:`_capture`); ``queue`` the run's queue of device work
    (:func:`device_queue`'s when None)."""

    def __init__(self, k: int, local: int, width: int, device: torch.device,
                 graphs: bool, queue: DeviceQueue | None = None):
        self.queue = (device_queue(device, graphs) if queue is None
                      else queue)
        self.cuda = CudaGraphs(device) if graphs else None
        self.k, self.device = int(k), device
        self.slots = _Slots(self.k, (
            ("idx", torch.int64, (local,)), ("offset", torch.int64, ()),
            ("mask", torch.float32, (local,)),
            ("sched", torch.float32, (len(SCHED_KEYS),))), device)
        self.out = torch.zeros((self.k, width), device=device)
        self.j = torch.zeros((), dtype=torch.int64, device=device)
        self.captured = None

    @property
    def graphs(self) -> bool:
        return self.cuda is not None

    def _capture(self, images, restore=None) -> float:
        """Run ``CAPTURE_WARMUP`` bodies over ``images`` on the side stream
        (each on slot 0), capture one body and ``restore()`` the state the
        warm-up changed; the kernel counts keep the warm-up's launches and
        not the capture's.  Returns the seconds it all took."""
        t0 = time.perf_counter()

        def body():
            self._body(images, self.j)

        def warm_up():
            for _ in range(CAPTURE_WARMUP):
                self.j.zero_()
                body()

        self.cuda.warm_up(warm_up)
        before, calls = _counts(), dict(LIBRARY_CALLS)
        self.j.zero_()
        graph = self.cuda.capture(body)
        per_replay = _count_delta(before, _counts())
        library = {k: n - calls.get(k, 0) for k, n in LIBRARY_CALLS.items()
                   if n > calls.get(k, 0)}
        _set_counts(before)
        if restore is not None:
            restore()
        self.j.zero_()
        self.cuda.synchronize()
        self.captured = _Captured(graph, per_replay, time.perf_counter() - t0,
                                  library)
        return self.captured.seconds

    def _take(self, j, *more):
        """Slot ``j``'s ``(idx, mask, sched dict, offset, *more)``: ``j`` a
        host int (eager), or the device counter (captured)."""
        s = self.slots
        tensors = (s.idx, s.mask, s.sched, s.offset, *more)
        if isinstance(j, int):
            got = [t[j] for t in tensors]
        else:
            got = [t.index_select(0, j.view(1))[0] for t in tensors]
        got[2] = dict(zip(SCHED_KEYS, got[2].unbind(0)))
        return got

    def _write(self, j, row: torch.Tensor) -> None:
        """Slot ``j``'s result row; the device counter moves on."""
        if isinstance(j, int):
            self.out[j].copy_(row)
        else:
            self.out.index_copy_(0, j.view(1), row[None])
            j.add_(1)

    def _upload(self, idx: list, mask: list, sched: list,
                offsets: list) -> int:
        """Write the first n slots (one entry a slot in each list; ``sched``
        rows of ``SCHED_KEYS`` floats) and start their one copy."""
        n = len(idx)
        if not 0 < n <= self.k:
            raise ValueError(f"1 to {self.k} slots, got {n}")
        host = self.slots.writable()
        host["idx"][:n] = torch.from_numpy(np.stack(idx).astype(np.int64))
        host["mask"][:n] = torch.from_numpy(
            np.stack(mask).astype(np.float32))
        host["sched"][:n] = torch.from_numpy(np.array(sched, np.float32))
        host["offset"][:n] = torch.tensor([int(o) for o in offsets],
                                          dtype=torch.int64)
        self.slots.upload(n)
        return n

    def _run(self, images, n: int) -> None:
        """The first n slots: n launches of the graph, or n eager
        bodies."""
        if self.graphs:
            self.j.zero_()
            self.captured.replay(n)
        else:
            for i in range(n):
                self._body(images, i)

    def _body(self, images, j) -> None:
        raise NotImplementedError


class TrainChunks(_Chunked):
    """Up to ``k`` train steps a dispatch through ``step``
    (``make_train_step``'s), over ``model`` and ``optimizer``: launches of
    one captured step with ``graphs``, else the same slots run eagerly.

    ``rows`` is a data-parallel rank's rows of each global batch of
    ``batch`` (None: all); ``seed`` and ``aug_kwargs`` are the step's, from
    which the augmentation uniforms are drawn ahead; ``queue`` the run's
    queue of device work, which runs each dispatch."""

    def __init__(self, step, model, optimizer, *, k: int, batch: int,
                 device: torch.device, seed: int, aug_kwargs: dict,
                 graphs: bool, rows: slice | None = None,
                 queue: DeviceQueue | None = None):
        local = batch if rows is None else rows.stop - rows.start
        super().__init__(k, local, len(METRIC_KEYS) + len(RUNNING_KEYS),
                         device, graphs, queue)
        self.step, self.model, self.optimizer = step, model, optimizer
        self.batch, self.seed, self.aug_kwargs = int(batch), seed, aug_kwargs
        self.draws = torch.zeros((self.k, 3, self.batch), device=device)
        self.running = torch.zeros(len(RUNNING_KEYS), device=device)
        self.generator = torch.Generator(device=device)
        self._snapshot = None

    @property
    def snapshot(self) -> StateSnapshot:
        """The training state's snapshot (``callbacks.StateSnapshot``:
        model, optimizer and the running sums), made at first use, once the
        optimizer's state is the run's (after a resume); its restore
        fences the queue."""
        if self._snapshot is None:
            self._snapshot = StateSnapshot(self.model, self.optimizer,
                                           extra=[self.running],
                                           fence=self.queue.fence)
        return self._snapshot

    def _body(self, images, j) -> None:
        idx, mask, sched, offset, draws = self._take(j, self.draws)
        metrics = self.step(images, idx, mask, sched, offset, draws=draws)
        row = torch.stack([metrics[k].float().reshape(())
                           for k in METRIC_KEYS])
        self.running += row[:len(RUNNING_KEYS)]
        self._write(j, torch.cat([row, self.running]))

    def prepare(self, images: torch.Tensor) -> float:
        """Capture the step over ``images`` (the tensor every step gathers
        from) once; a no-op without ``graphs`` or when captured.  Returns
        the seconds of the warm-up and the capture (0.0 when nothing was
        captured now).  Fences the queue first."""
        self.queue.fence()
        if not self.graphs or self.captured is not None:
            return 0.0
        snapshot = self.snapshot
        snapshot.take()
        return self._capture(images, snapshot.restore)

    def reset_running(self) -> None:
        """Start an epoch's running sums."""
        self.running.zero_()

    def dispatch(self, images, steps: list, meta=None, stage=None) -> Job:
        """Run ``steps``, a list of ``(idx, mask, sched, step_index)`` (numpy
        rows of this rank, a dict of ``SCHED_KEYS`` floats, the step's
        number), at most ``k``, as one job of the queue: ``stage`` (the
        split's ``DeviceData.stage``: the rows into ``images`` for the
        steps' rows, with a host-fed split's upload), the one upload of the
        slots, the draws, the launches and the copy of the rows to the
        host.  Returns the job: its ``rows()`` are ``[n, 16]``,
        ``METRIC_KEYS`` then the running sums after the step, its ``meta``
        ``meta``."""
        if self.graphs and self.captured is None:
            raise RuntimeError("TrainChunks.prepare() must capture the step "
                               "before a chunk is dispatched")

        def job() -> Pending:
            with span("dispatch.chunk", device=self.device) as rec:
                rec.steps = len(steps)
                with span("dispatch.stage"):
                    idx = [s[0] for s in steps]
                    if stage is not None:
                        idx = stage(idx)
                with span("dispatch.upload"):
                    n = self._upload(
                        idx, [s[1] for s in steps],
                        [[s[2][k] for k in SCHED_KEYS] for s in steps],
                        [s[3] for s in steps])
                with span("dispatch.draws"):
                    for i, s in enumerate(steps):
                        draw_step_augment(self.generator, self.seed,
                                          int(s[3]), self.batch,
                                          self.aug_kwargs, out=self.draws[i])
                with span("dispatch.launch"):
                    self._run(images, n)
                return Pending(self.out[:n])

        return self.queue.submit(job, meta)


class EvalChunks(_Chunked):
    """Up to ``v`` validation batches a dispatch through ``eval_step``
    (``make_eval_step``'s): launches of one captured batch with ``graphs``,
    else the same slots eagerly.  :meth:`run` returns the batches' ``[n,
    10 + b·latent]`` device rows, each batch's ``METRIC_KEYS`` and its μ,
    for one read: a whole pass, or, fed from the host, a chunk of it."""

    def __init__(self, eval_step, *, v: int, local_batch: int, latent: int,
                 device: torch.device, graphs: bool,
                 queue: DeviceQueue | None = None):
        super().__init__(v, local_batch,
                         len(METRIC_KEYS) + local_batch * latent, device,
                         graphs, queue)
        self.eval_step = eval_step

    def _body(self, images, j) -> None:
        idx, mask, sched, offset = self._take(j)
        metrics, mu = self.eval_step(images, idx, mask, sched, offset)
        self._write(j, torch.cat([
            torch.stack([metrics[k].float().reshape(())
                         for k in METRIC_KEYS]),
            mu.float().reshape(-1)]))

    def prepare(self, images: torch.Tensor) -> float:
        """Capture the batch over ``images`` (the tensor every batch
        gathers from) once; a no-op without ``graphs`` or when captured.
        Returns the seconds of the warm-up and the capture (0.0 when
        nothing was captured now).  Fences the queue first."""
        self.queue.fence()
        if not self.graphs or self.captured is not None:
            return 0.0
        return self._capture(images)

    def run(self, images, batches: list, sched: dict,
            offsets: list) -> torch.Tensor:
        """``batches`` (``(idx, mask)`` numpy rows of this rank into
        ``images``, at most ``v``), batch j's noise at ``offsets[j]``.  The
        rows returned are overwritten by the next call.  Device work: run
        it in a job of the queue (the trainer's validation pass is one)."""
        if self.graphs and self.captured is None:
            raise RuntimeError("EvalChunks.prepare() must capture the batch "
                               "before a pass is run")
        row = [float(sched[k]) for k in SCHED_KEYS]
        n = self._upload([b[0] for b in batches], [b[1] for b in batches],
                         [row] * len(batches), offsets)
        self._run(images, n)
        return self.out[:n]
