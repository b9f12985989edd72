"""``logging.profile_steps``: a ``torch.profiler`` trace of the first train
steps.

Counterpart of ``betavae_tpu/utils/profiling.py``.  :class:`StepProfiler`
records the CPU and, on a CUDA device, the CUDA activity of the first
``profile_steps`` train steps and writes each window as a Chrome trace,
``<out_dir>/steps_<first>-<last>.trace.json`` (train steps numbered from 1,
as the METRICS lines number them), for ``utils/trace.py`` or any Chrome
trace viewer.  Nothing is recorded when ``profile_steps`` is 0.  Where the
JAX class drops the trace silently when the profiler cannot start, this
one raises: a key that is set is never ignored.
"""

from __future__ import annotations

import os

import torch
from torch.profiler import ProfilerActivity, profile


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
