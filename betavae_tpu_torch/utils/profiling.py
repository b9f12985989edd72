"""``logging.profile_steps``: a ``torch.profiler`` trace of the first train
steps; and the process's spans and counters (:data:`SPANS`), read with no
profiler.

Counterpart of ``betavae_tpu/utils/profiling.py``.  :class:`StepProfiler`
records the CPU and, on a CUDA device, the CUDA activity of the first
``profile_steps`` train steps and writes each window as a Chrome trace,
``<out_dir>/steps_<first>-<last>.trace.json`` (train steps numbered from 1,
as the METRICS lines number them), for ``utils/trace.py`` or any Chrome
trace viewer.  Nothing is recorded when ``profile_steps`` is 0.  Where the
JAX class drops the trace silently when the profiler cannot start, this
one raises: a key that is set is never ignored.

:class:`Spans` is the port's one registry of spans and counters (the JAX
package has none).  A span is a named stretch of host time on the
``time.perf_counter`` clock (the trainer's ``t_mono`` stamps', and the
benchmark's); a span of device work also records a pair of timing CUDA
events on its stream, which are read later, where the caller waits for the
device anyway, and placed on the same clock by an anchor (:meth:`Spans.
anchor`).  So the device's busy and idle time are read with no profiler,
while every graph launches from the device.  While a ``torch.profiler``
session is open each span is also a ``record_function`` of its name, in the
Chrome trace beside the device's kernels.  The trainer closes an epoch
cycle at each ``epoch_end`` line (:meth:`Spans.end_epoch`) and logs each
cycle's accounting as a ``spans`` METRICS line (:meth:`Spans.account`).
"""

from __future__ import annotations

import collections
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

# the rings of settled epochs and of dispatched chunks a registry keeps
EPOCH_RING = 64
CHUNK_RING = 4096
# the span a chunk's dispatch is, which the chunk ring keeps
CHUNK = "dispatch.chunk"
# an idle gap that no host span was open across
NO_SPAN = "(none)"


class StepProfiler:
    """Trace train steps while ``remaining`` > 0: :meth:`maybe_start`
    before a run of steps, :meth:`after_step` after each, :meth:`stop` at
    its end (the trainers' epoch ends).  ``fence`` (the run's
    ``DeviceQueue.fence``) is called before each device sync, so that the
    sync waits for the steps dispatched so far."""

    def __init__(self, profile_steps: int, out_dir: str, device: torch.device,
                 fence=None):
        self.remaining = int(profile_steps or 0)
        self.out_dir = out_dir
        self.device = device
        self._fence = fence
        self.paths: list = []
        self._prof = None
        self._first = self._last = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_start(self, next_step: int) -> None:
        """Start a window whose first step is ``next_step``, if steps are
        left to trace; raises ``RuntimeError`` if the profiler cannot.  The
        work queued on the device before it is waited for first, so the
        window's device events are its steps' (and what follows them)."""
        if self.remaining <= 0 or self.active:
            return
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        os.makedirs(self.out_dir, exist_ok=True)
        prof = profile(activities=activities)
        try:
            prof.start()
        except Exception as err:
            raise RuntimeError(
                f"logging.profile_steps={self.remaining}: torch.profiler "
                f"could not start on {self.device} ({err!r})") from err
        self._prof = prof
        self._first = self._last = next_step

    def after_step(self, step: int) -> None:
        """Count train step ``step``; the window closes after the last."""
        if not self.active:
            return
        self._last = step
        self.remaining -= 1
        if self.remaining <= 0:
            self.stop()

    def stop(self) -> None:
        """Close the window and write its trace; the device's queued work
        is waited for first, so the trace holds every step's kernels."""
        if not self.active:
            return
        prof, self._prof = self._prof, None
        try:
            self._sync()
        finally:
            prof.stop()
        path = os.path.join(self.out_dir, f"steps_{self._first}-"
                                          f"{self._last}.trace.json")
        prof.export_chrome_trace(path)
        self.paths.append(path)
        print(f"[PROFILE] train steps {self._first}-{self._last} traced: "
              f"{path}")

    def _sync(self) -> None:
        """The fence, then on the card a device sync."""
        if self._fence is not None:
            self._fence()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class _Tracing:
    """``torch.profiler``'s sessions in this process, as
    :func:`_watch_profiler` follows them: ``generation`` counts each
    session's preparation and its end, ``open`` holds from the one to the
    other."""

    watched = False
    generation = 0
    open = False


def _watch_profiler() -> None:
    """Follow every ``torch.profiler`` session in :class:`_Tracing`, once a
    process: wrap ``torch.autograd.profiler``'s calls that prepare a
    session (its CUDA tracing attaches to the process there, before the
    session records anything: a ``schedule``'s warm-up steps) and end it.
    Every profiler of PyTorch that traces the card goes through them."""
    if _Tracing.watched:
        return
    from torch.autograd import profiler as autograd_profiler

    prepare = autograd_profiler._prepare_profiler
    disable = autograd_profiler._disable_profiler

    def prepared(*args, **kwargs):
        _Tracing.generation += 1
        _Tracing.open = True
        return prepare(*args, **kwargs)

    def ended(*args, **kwargs):
        try:
            return disable(*args, **kwargs)
        finally:
            _Tracing.generation += 1
            _Tracing.open = False

    autograd_profiler._prepare_profiler = prepared
    autograd_profiler._disable_profiler = ended
    _Tracing.watched = True


class SpanRecord:
    """One span: its ``name``; ``parent``, the name of the span open around
    it on its thread (None at the top); host start and end ``t0``, ``t1``
    (``time.perf_counter``; ``t1`` None while open); device start and end
    ``d0``, ``d1`` on the same clock (None for a host span, and until its
    events are read); ``steps``, a chunk's train steps; ``traced``, whether
    a profiler session was open at its start."""

    __slots__ = ("name", "parent", "t0", "t1", "d0", "d1", "steps", "traced",
                 "events", "anchor")

    def __init__(self, name: str, parent: str | None = None, t0: float = 0.0,
                 t1: float | None = None, d0: float | None = None,
                 d1: float | None = None, steps: int = 0,
                 traced: bool = False):
        self.name, self.parent, self.t0, self.t1 = name, parent, t0, t1
        self.d0, self.d1, self.steps, self.traced = d0, d1, steps, traced
        # (start, end) CUDA events until read; the anchor before the start
        self.events = self.anchor = None


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Span:
    """The context manager of :meth:`Spans.span`; entered, the record."""

    __slots__ = ("spans", "name", "stream", "device", "record", "annotation")

    def __init__(self, spans, name, stream, device):
        self.spans, self.name, self.stream, self.device = (spans, name,
                                                           stream, device)
        self.record = self.annotation = None

    def __enter__(self) -> SpanRecord:
        self.record, self.annotation = self.spans._open(self.name,
                                                        self.stream,
                                                        self.device)
        return self.record

    def __exit__(self, *exc) -> None:
        self.spans._close(self.record, self.stream, self.annotation)


class Spans:
    """A process's spans and counters.

    :meth:`span` times a named stretch of the calling thread's work on the
    host clock; given a ``stream``, or a CUDA ``device`` (its current
    stream), it also records a timing event on that stream at its start and
    at its end, from a pool of events reused once read.  A span never waits
    for the device and allocates no device memory, and one opened inside a
    CUDA graph capture raises.  :meth:`count` adds to a counter.  Both are
    safe from any thread (the dispatcher thread's jobs open spans).

    The events are read by :meth:`poll` (``Event.query``), :meth:`anchor`
    and :meth:`settle`, at points where the caller waits for the device
    anyway: a chunk's drain, the sync that ends an epoch's train steps, the
    run's end.  Each event is placed on the host clock from an anchor, an
    event recorded, waited for, and followed at once by a host clock read:
    the last anchor before the span's start, else the first one after its
    end.  The anchor's host time is late by what the wait's return takes.

    The epoch cycles of a trainer's run: :meth:`start_epochs` opens the
    first at an anchor, :meth:`end_epoch` closes one at the trainer's
    ``epoch_end`` stamp and opens the next.  A closed cycle is accounted
    (:meth:`account`) once no span that started before its end is open or
    unread; the accounts wait in :meth:`lines` for the trainer to log them,
    and the last :data:`EPOCH_RING` stay in ``epochs``.  ``chunks`` keeps
    the last :data:`CHUNK_RING` records of :data:`CHUNK`."""

    def __init__(self, epochs: int = EPOCH_RING, chunks: int = CHUNK_RING):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pool = []
        self._open_records = {}
        self._unread = []
        self._records = []
        self.chunks = collections.deque(maxlen=chunks)
        self.epochs = collections.deque(maxlen=epochs)
        self.counters = collections.Counter()
        self.host_totals = collections.defaultdict(float)
        # (event, host time after its wait, host time of its record)
        self._anchor = None
        self._cycle = None
        self._closed = []
        self._lines = []

    # -- spans and counters ----------------------------------------------

    def span(self, name: str, stream=None, *, device=None) -> _Span:
        """A context manager timing ``name``; entered, its
        :class:`SpanRecord`.  Device events on ``stream``, or on the
        current stream of ``device`` where that is a CUDA device."""
        return _Span(self, name, stream, device)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def counter(self, name: str) -> int:
        with self._lock:
            return self.counters[name]

    def host_total(self, name: str) -> float:
        """The host seconds of every span ``name`` closed so far."""
        with self._lock:
            return self.host_totals[name]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name, stream, device):
        if torch.cuda.is_initialized() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"span {name!r} opened inside a CUDA graph "
                               f"capture")
        stack = self._stack()
        rec = SpanRecord(name, stack[-1].name if stack else None,
                         traced=_Tracing.open
                         or torch._C._autograd._profiler_enabled())
        if stream is not None or (device is not None
                                  and device.type == "cuda"):
            with self._lock:
                rec.events = (self._pool.pop() if self._pool
                              else torch.cuda.Event(enable_timing=True),
                              self._pool.pop() if self._pool
                              else torch.cuda.Event(enable_timing=True))
                rec.anchor = self._anchor
            rec.events[0].record(stream)
        annotation = None
        if rec.traced:
            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        stack.append(rec)
        with self._lock:
            self._open_records[id(rec)] = rec
        rec.t0 = time.perf_counter()
        return rec, annotation

    def _close(self, rec, stream, annotation) -> None:
        rec.t1 = time.perf_counter()
        self._stack().pop()
        if rec.events is not None:
            rec.events[1].record(stream)
        if annotation is not None:
            annotation.__exit__(None, None, None)
        with self._lock:
            del self._open_records[id(rec)]
            self.host_totals[rec.name] += rec.t1 - rec.t0
            if rec.events is not None:
                self._unread.append(rec)
            if self._cycle is not None:
                self._records.append(rec)
            if rec.name == CHUNK:
                self.chunks.append(rec)

    # -- reading the device's times -----------------------------------------

    def anchor(self, device: torch.device) -> float:
        """An event on ``device``'s current stream, waited for, then the
        host clock: the anchor later events are placed by.  Where the
        caller has just waited for the device the wait is short.  Reads
        the events that have completed (:meth:`poll`); returns the host
        time (on a device other than CUDA, the host clock alone)."""
        if device.type != "cuda":
            now = time.perf_counter()
        else:
            event = torch.cuda.Event(enable_timing=True)
            recorded = time.perf_counter()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
            now = time.perf_counter()
            with self._lock:
                self._anchor = (event, now, recorded)
        self.poll()
        return now

    def poll(self) -> None:
        """Read the events that have completed (``Event.query``, which does
        not wait) and account the epoch cycles that are then complete."""
        with self._lock:
            self._read()
            self._account_closed()

    def _read(self) -> None:
        unread = []
        for rec in self._unread:
            start, end = rec.events
            if not end.query():
                unread.append(rec)
                continue
            if rec.anchor is not None:
                event, at, _ = rec.anchor
                rec.d0 = at + event.elapsed_time(start) / 1e3
                rec.d1 = at + event.elapsed_time(end) / 1e3
            elif self._anchor is not None and self._anchor[2] > rec.t1:
                event, at, _ = self._anchor
                rec.d0 = at - start.elapsed_time(event) / 1e3
                rec.d1 = at - end.elapsed_time(event) / 1e3
            else:
                unread.append(rec)
                continue
            rec.events = rec.anchor = None
            self._pool += [start, end]
        self._unread = unread

    def settle(self, device: torch.device | None = None) -> list:
        """At a run's end, once its device work is queued: wait for every
        span's end event, take an anchor on ``device`` (the current CUDA
        device when None) where a span has none before it, read them all
        and account every closed cycle.  Returns :meth:`lines`."""
        with self._lock:
            unread = [(rec.events, rec.anchor) for rec in self._unread]
        for events, _ in unread:
            events[1].synchronize()
        if any(anchor is None for _, anchor in unread):
            self.anchor(device if device is not None
                        else torch.device("cuda", torch.cuda.current_device()))
        self.poll()
        return self.lines()

    # -- epoch cycles ------------------------------------------------------

    def start_epochs(self, device: torch.device) -> float:
        """Open a trainer's first epoch cycle at an anchor on ``device``
        (the run's device work so far is done: its captures synchronise);
        a run that ended early left cycles that are dropped."""
        with self._lock:
            self._closed, self._records, self._lines = [], [], []
        now = self.anchor(device)
        with self._lock:
            self._cycle = self._new_cycle(now, device.type == "cuda")
        return now

    def _new_cycle(self, t0: float, on_device: bool) -> dict:
        return {"t0": t0, "device": on_device,
                "counters": dict(self.counters),
                "tracing": (_Tracing.generation, _Tracing.open)}

    def end_epochs(self) -> None:
        """A trainer's run has ended: the open cycle is dropped and no
        record is kept for it; the closed ones wait for :meth:`settle`."""
        with self._lock:
            self._cycle = None

    def begin_epoch(self) -> float:
        """The host time an epoch's train steps start at."""
        return time.perf_counter()

    def end_epoch(self, epoch: int, step: int) -> float:
        """Close the open cycle at the trainer's ``epoch_end`` stamp of
        ``epoch`` (``step`` the run's steps then) and open the next;
        returns the stamp."""
        now = time.perf_counter()
        with self._lock:
            cycle = self._cycle
            if cycle is not None:
                cycle.update(epoch=int(epoch), step=int(step), t1=now,
                             counters_end=dict(self.counters),
                             tracing_end=(_Tracing.generation, _Tracing.open))
                self._closed.append(cycle)
                self._cycle = self._new_cycle(now, cycle["device"])
            self._account_closed()
        return now

    def lines(self) -> list:
        """The accounted cycles not yet taken, ``(step, line)``, oldest
        first."""
        with self._lock:
            out, self._lines = self._lines, []
        return out

    def _account_closed(self) -> None:
        while self._closed:
            cycle = self._closed[0]
            t1 = cycle["t1"]
            if any(r.t0 < t1 for r in self._open_records.values()) or \
                    any(r.t0 < t1 for r in self._unread):
                return
            self._closed.pop(0)
            line = self.account(cycle, self._records)
            self.epochs.append(line)
            self._lines.append((cycle["step"], line))
            # the records a later cycle can still read
            self._records = [r for r in self._records
                             if max(r.t1, r.d1 or r.t1) > t1]

    @staticmethod
    def account(cycle: dict, records) -> dict:
        """The ``spans`` line of a closed cycle from the records: host
        seconds by the spans that started in it; where the run is on a CUDA
        device, the union of every span's device interval clipped to it
        (busy), the rest (idle), each idle gap put to the innermost host
        span open at its middle, device seconds by span, and the train
        steps the card ran in it (each chunk's steps in proportion to its
        device interval inside the cycle); the counters' changes; whether a
        profiler session was open in it (``traced``)."""
        c0, c1 = cycle["t0"], cycle["t1"]
        recs = [r for r in records
                if r.t0 < c1 and max(r.t1, r.d1 or r.t1) > c0]
        host = collections.defaultdict(float)
        for r in recs:
            if r.t0 >= c0:
                host[r.name] += r.t1 - r.t0
        before, after = cycle["counters"], cycle["counters_end"]
        traced = (cycle["tracing"] != cycle["tracing_end"]
                  or cycle["tracing"][1] or any(r.traced for r in recs))
        line = {"epoch": cycle["epoch"], "cycle_seconds": round(c1 - c0, 6),
                "device_busy_seconds": None, "device_idle_seconds": None,
                "idle_by_span": None,
                "host_seconds": {k: round(v, 6) for k, v in host.items()},
                "device_seconds": {}, "steps": None,
                "counters": {k: v - before.get(k, 0)
                             for k, v in after.items()},
                "traced": bool(traced)}
        if not cycle["device"]:
            return line
        device = collections.defaultdict(float)
        intervals, steps = [], 0.0
        for r in recs:
            if r.d0 is None:
                continue
            a, b = max(r.d0, c0), min(r.d1, c1)
            if b <= a:
                continue
            device[r.name] += b - a
            intervals.append((a, b))
            if r.steps and r.d1 > r.d0:
                steps += r.steps * (b - a) / (r.d1 - r.d0)
        busy = _union(intervals)
        gaps, at = [], c0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < c1:
            gaps.append((at, c1))
        idle = collections.defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            running = [r for r in recs if r.t0 <= mid < r.t1]
            label = (max(running, key=lambda r: r.t0).name if running
                     else NO_SPAN)
            idle[label] += b - a
        busy_s = sum(b - a for a, b in busy)
        line.update(device_busy_seconds=round(busy_s, 6),
                    device_idle_seconds=round(c1 - c0 - busy_s, 6),
                    idle_by_span={k: round(v, 6) for k, v in idle.items()},
                    device_seconds={k: round(v, 6) for k, v in device.items()},
                    steps=round(steps, 3))
        return line

    # -- queries -------------------------------------------------------------

    def chunk_window(self, steps: int) -> list | None:
        """The last :data:`CHUNK` records not traced whose steps sum to
        ``steps``, oldest first, each read on the device; None where there
        are none such."""
        with self._lock:
            recs = list(self.chunks)
        while recs and recs[-1].traced:
            recs.pop()
        out, total = [], 0
        while recs and total < steps:
            rec = recs.pop()
            if rec.traced or rec.d0 is None:
                return None
            out.append(rec)
            total += rec.steps
        return out[::-1] if out and total == steps else None

    def epoch_lines(self, first: int, last: int) -> list | None:
        """The latest ``spans`` line of each epoch ``first`` … ``last``;
        None unless each is there, read on the device, not traced, and
        free of host launches of a graph."""
        with self._lock:
            by_epoch = {line["epoch"]: line for line in self.epochs}
        out = [by_epoch.get(e) for e in range(first, last + 1)]
        if not out or any(
                line is None or line["traced"]
                or line["device_idle_seconds"] is None
                or line["counters"].get("graphs.host_launches", 0)
                for line in out):
            return None
        return out


# a session opened before the first span or graph is followed too
_watch_profiler()
# the process's registry: the program's spans and counters, which the
# trainer logs and the benchmark's readers read
SPANS = Spans()
span = SPANS.span
count = SPANS.count
