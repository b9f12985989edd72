"""Per-kernel device-time tables from ``torch.profiler`` Chrome traces.

Counterpart of ``betavae_tpu/utils/trace.py`` for the traces the port
writes (``export_chrome_trace``: ``logging.profile_steps``,
``python -m betavae_tpu_torch.utils.profile_step``).  Only device kernels
count (events of ``cat == "kernel"``, named as the trace prints them):
memory copies and fills, CPU operators and the annotations projected onto
the device's track do not.  The rows are those of the JAX parser: µs per
step, launches per step, and the total.  Only the standard library is
needed.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from dataclasses import dataclass


@dataclass
class OpRow:
    name: str                 # the kernel's name as the trace prints it
    total_us: float           # device time over the traced window
    count: int                # launches
    example: str = ""         # grid and block of one launch


@dataclass
class TraceSummary:
    rows: list                # OpRow, sorted by total_us desc
    device_total_us: float    # Σ over the kernels
    steps: int = 1

    def per_step(self):
        """[(name, us/step, count/step)] using the declared step count."""
        return [(r.name, r.total_us / self.steps, r.count / self.steps)
                for r in self.rows]

    def table(self, top: int = 20) -> str:
        lines = [f"{'us/step':>10} {'n/step':>7}  kernel"]
        for name, us, n in self.per_step()[:top]:
            lines.append(f"{us:10.1f} {n:7.1f}  {name}")
        lines.append(f"{self.device_total_us / self.steps:10.1f} {'':7s}  "
                     "TOTAL (device kernels)")
        return "\n".join(lines)


def find_traces(logdir: str) -> list:
    """Newest-first Chrome trace files (``*.json``, ``*.json.gz``) under
    ``logdir``."""
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pattern),
                                recursive=True)]
    return sorted(paths, key=os.path.getmtime, reverse=True)


def parse_trace(path: str, steps: int = 1,
                name_filter: str | None = None) -> TraceSummary:
    """Aggregate the device kernels of a Chrome trace by name.

    ``steps``: how many train steps the trace holds.  ``name_filter``: a
    regex; keep only kernels whose name matches it.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    flt = re.compile(name_filter) if name_filter else None
    agg = collections.Counter()
    cnt = collections.Counter()
    example = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        if flt and not flt.search(name):
            continue
        agg[name] += float(e.get("dur", 0))
        cnt[name] += 1
        if name not in example:
            args = e.get("args") or {}
            example[name] = f"grid {args.get('grid')} block {args.get('block')}"
    rows = [OpRow(n, agg[n], cnt[n], example[n]) for n, _ in agg.most_common()]
    return TraceSummary(rows=rows, device_total_us=sum(agg.values()),
                        steps=steps)
