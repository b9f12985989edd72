"""Device resolution (CUDA by default, the CPU only when asked for by
name), the cuDNN setting under which the trainer's runs replay, and the
FIFO queue of a run's device work (:class:`DeviceQueue`), run on a
dispatcher thread where graphs launch from the host."""

from __future__ import annotations

import collections
import contextlib
import threading

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises when CUDA is asked for
    (the default) and no GPU is present.  Nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def raw_stream(device: torch.device) -> int:
    """The current stream's handle on ``device``, for a kernel's C entry.
    ``torch._C._cuda_getCurrentRawStream`` is private, and used because it
    returns the handle without building a ``torch.cuda.Stream``
    (``torch.cuda.current_stream(device).cuda_stream`` took 5–8 µs of host
    time a call on the H100's host, 12–15 % of a GN call;
    ``chip_smoke.py::gn_host_split`` times both)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block, its benchmark
    autotuner off, both put back as found on the way out.  With PyTorch's
    defaults two fp32 backwards of one state on an H100 part by up to ~2e-5
    (``chip_smoke.py`` phase ``cudnn_determinism``), so a run would not
    replay from its seed.  The two attributes are set directly:
    ``torch.backends.cudnn.flags()`` resets every argument it is not given,
    ``enabled`` among them, to False."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


# the queues whose dispatcher thread runs, for fence_device_queues: an eager
# collective receives a process group, not the queue of its rank's run
_THREADED = set()


def _caller_state(device: torch.device):
    """A context manager factory for the thread-local state a job runs
    under, read now on the caller's thread: its current stream on
    ``device``, grad mode and autocast (each is per thread in PyTorch)."""
    grad = torch.is_grad_enabled()
    casts = [(kind, torch.get_autocast_dtype(kind)) for kind in ("cuda", "cpu")
             if torch.is_autocast_enabled(kind)]
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)

    @contextlib.contextmanager
    def enter():
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.set_grad_enabled(grad))
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
            for kind, dtype in casts:
                stack.enter_context(torch.autocast(kind, dtype=dtype))
            yield

    return enter


class Job:
    """A job of a :class:`DeviceQueue` and the caller's ``meta``.
    :meth:`result` waits until the job has run and returns what it
    returned, raising the queue's kept error; :meth:`rows` is
    ``result().rows()``, for a job that returns a ``train.chunks.Pending``:
    it waits for the job to have queued the copy, then for the copy."""

    def __init__(self, queue: "DeviceQueue", fn, meta, enter):
        self.queue, self.fn, self.meta, self.enter = queue, fn, meta, enter
        self.done = False
        self.value = None

    def result(self):
        self.queue._wait(lambda: self.done)
        return self.value

    def rows(self):
        return self.result().rows()


class DeviceQueue:
    """One FIFO queue of a run's device work on ``device``: each job a
    callable that enqueues device work (launches, copies, events) and
    returns what its caller reads later.  With ``threaded`` one dispatcher
    thread runs the jobs in the order submitted, so :meth:`submit` returns
    at once however long a job's launches wait for room in the device's
    launch queue; without it a job runs at once on the caller's thread.

    The dispatcher sets the device first (a new thread starts on device
    0), and runs each job under the caller's current stream, grad mode and
    autocast as they were at its :meth:`submit`.  An exception in a job is
    kept: no later job runs, and it is raised from every later
    :meth:`submit`, :meth:`fence`, :meth:`close` and :meth:`Job.result`.
    :meth:`close` stops the thread; a later submit starts another."""

    def __init__(self, device: torch.device, threaded: bool):
        if threaded and device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self.threaded = device, threaded
        self._jobs = collections.deque()
        self._cond = threading.Condition()
        self._thread = None
        self._closing = False
        self._error = None
        # the threads that submitted: the ones fence_device_queues fences
        self._submitters = set()

    def submit(self, fn, meta=None) -> Job:
        """Queue ``fn()``; returns its :class:`Job`."""
        if not self.threaded:
            job = Job(self, None, meta, None)
            job.value, job.done = fn(), True
            return job
        job = Job(self, fn, meta, _caller_state(self.device))
        with self._cond:
            self._raise()
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._work, daemon=True, name="betavae-dispatch")
                self._thread.start()
                _THREADED.add(self)
            self._submitters.add(threading.get_ident())
            self._jobs.append(job)
            self._cond.notify_all()
        return job

    def fence(self) -> None:
        """Wait until every job submitted so far has run, so that device
        work enqueued after it is queued behind theirs; raises a job's kept
        error."""
        if self.threaded:
            self._wait(lambda: not self._jobs)

    def close(self) -> None:
        """Fence, then stop the dispatcher thread (also when the fence
        raises)."""
        try:
            self.fence()
        finally:
            thread = self._thread
            if thread is not None:
                with self._cond:
                    self._closing = True
                    self._cond.notify_all()
                thread.join()
                _THREADED.discard(self)
                self._thread, self._closing = None, False

    def _raise(self) -> None:
        if self._error is not None:
            raise self._error

    def _wait(self, ready) -> None:
        with self._cond:
            while not ready():
                self._cond.wait()
            self._raise()

    def _work(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                while not self._jobs and not self._closing:
                    self._cond.wait()
                if not self._jobs:
                    return
                job = self._jobs[0]
            if self._error is None:
                try:
                    with job.enter():
                        job.value = job.fn()
                # kept, and raised on the thread that reads the queue
                except BaseException as err:
                    self._error = err
            with self._cond:
                self._jobs.popleft()
                job.done, job.fn = True, None
                self._cond.notify_all()


def fence_device_queues() -> None:
    """Fence every threaded :class:`DeviceQueue` this thread submitted to,
    before an eager collective: NCCL needs every rank to issue its
    collectives on a communicator in one order, and two threads that issue
    them in turn break that order and hang the mesh.  A no-op on a
    dispatcher thread (whose jobs issue the queue's collectives) and where
    no queue is threaded."""
    me = threading.get_ident()
    for queue in list(_THREADED):
        if me in queue._submitters:
            queue.fence()
