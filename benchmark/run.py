"""The benchmark of ``betavae_tpu_torch``: one cell, one run.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

Run from the root of a checkout.  The cell's configuration, traffic mix,
limits and per-layer readers are found by name (``benchmark/harness.py``).
The run makes its weights and images from ``--seed``, builds and warms the
program (``setup_s``, from the start of this process to the window),
measures for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics)
or traces a short steady window (``--trace 1``: its per-layer metrics),
then frees the program's state and holds the program's first steps against
the plain reference (``correct``).  The last line of standard output is
one JSON object; the last lines of standard error are the numbers compared,
each beside its limit.

Exits 2 without printing a result where there is no CUDA card or fewer
than the cell asks for, and 3 where a module of JAX or of the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

GIB = 1024 ** 3


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None, *, device=None, fault=None, root: Path = ROOT,
         bench_dir: Path | None = None, t_start: float | None = None) -> int:
    """One run.  ``device`` skips the look for a card (the CPU tests);
    ``fault`` plants one of the runner's faults in the timed path;
    ``root`` and ``bench_dir`` are where ``BENCHMARK.json`` and the cell's
    files are."""
    bench_dir = bench_dir or harness.HERE
    args = parse(argv)
    t_start = T_START if t_start is None else t_start
    harness.set_caches(root)
    cell = harness.load_cell(root, args.workload, bench_dir)
    import torch

    if device is None:
        problem = harness.card_problem(cell.chips)
        if problem:
            _say(f"no result: {problem}")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    drive = harness.runner(cell.traffic["runner"], bench_dir)
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        out = drive.run(cell, args, device, fault=fault,
                        trace_path=trace_path)
        trace = None
        if args.trace:
            from benchmark import tracing
            trace = tracing.Trace.load(trace_path)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev_line = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": kind, "count": cell.chips,
                "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if args.trace:
        from benchmark import flops, peaks
        ctx = harness.Ctx(trace=trace, steps=out["steps"],
                          batch=out["counters"]["batch"], cfg=cell.cfg,
                          sizes=flops.sizes(cell.cfg), peaks=peaks.of(kind),
                          counters=out["counters"])
        metrics = harness.per_layer(cell, ctx, bench_dir)
        dev_line["busy_s"] = trace.busy_s
        dev_line["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(10),
                     "idle_gaps": trace.idle_by_host(10)}
    else:
        values = {"setup_s": out["window_start"] - t_start,
                  "peak_mem_gib": out["memory_peak_bytes"] / GIB}
        values.update({k: v for k, v in out.items()
                       if k.endswith("_per_sec")})
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    bad = harness.loaded_forbidden()
    if bad:
        _say(f"no result: modules of JAX or the JAX package loaded: {bad}")
        return 3
    _say(f"setup_phases_s {out['counters'].get('setup_phases')}")
    timeline = {k: [round(float(x), 4) for x in v] for k, v in
                out["counters"].get("timeline", {}).items()}
    _say(f"timeline_s {json.dumps(timeline)}")
    _say(f"bytes_written {harness.bytes_written()}")
    for name, c in out["checks"].items():
        _say(f"check {name} {c['value']} limit {c['limit']}")
    print(harness.result_line(
        correct=out["correct"] and out["failed"] == 0,
        attempted=out["attempted"], failed=out["failed"], metrics=metrics,
        device=dev_line, checks=out["checks"], breakdown=breakdown),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
