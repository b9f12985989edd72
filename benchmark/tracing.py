"""The reader of a run's device trace: ``torch.profiler``'s Chrome trace.

The traced window is the span of the host annotation ``WINDOW`` that the
runner opens around the work it traces (ended by a device synchronise).
Within it:

- busy seconds: the union of the intervals in which an operation ran on the
  device (kernels, copies, memsets);
- device seconds by kernel name, and of every kernel whose name holds one of
  a list of substrings (a per-layer metric's kernels);
- the idle gaps between device operations, each put to the host event that
  was running at its middle (the innermost one, by latest start).

Times in the trace are microseconds; everything returned is seconds.
"""

from __future__ import annotations

import json
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
NAME_CHARS = 160


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, events: list, window: str = WINDOW):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("name") == window]
        if not spans:
            raise ValueError(f"the trace holds no {window!r} annotation")
        w = max(spans, key=lambda e: float(e["dur"]))
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.device = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            cat = e.get("cat", "")
            item = (max(a, self.t0), min(b, self.t1), e.get("name", ""), cat)
            if cat in DEVICE_CATS:
                self.device.append(item)
            elif cat in HOST_CATS and e.get("name") != window:
                self.host.append((a, b, e.get("name", "")))
        self._busy = _merge([(a, b) for a, b, _, _ in self.device])

    @classmethod
    def load(cls, path: str, window: str = WINDOW) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, window)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) * 1e-6

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any of
        ``patterns``."""
        return sum(b - a for a, b, name, cat in self.device
                   if cat == "kernel" and any(p in name for p in patterns)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name[:NAME_CHARS]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def gaps(self) -> list:
        """``(start, end)`` of every idle interval in the window, in µs."""
        out, at = [], self.t0
        for a, b in self._busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < self.t1:
            out.append((at, self.t1))
        return out

    def idle_by_host(self, n: int = 10) -> list:
        """The idle seconds summed by the host event running at each gap's
        middle (``"(no host event)"`` where none was), largest first."""
        by = defaultdict(float)
        for a, b in self.gaps():
            mid = 0.5 * (a + b)
            running = [h for h in self.host if h[0] <= mid < h[1]]
            label = (max(running, key=lambda h: h[0])[2][:NAME_CHARS]
                     if running else "(no host event)")
            by[label] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]
