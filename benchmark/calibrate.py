"""The readings that the limits of ``correct`` are set from, for one cell.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds ...] [--fault-seeds ...] [--refs bf16,fp32]
        [--seconds S] [--out FILE]

In one process, at the cell's own sizes and with no measured window:

- ``--seeds``: sound runs of the program: set-up and its first steps
  through the window's call (the epochs runner: one ``train()`` of
  ``--seconds``' epochs), then the plain reference; the numbers compared
  and, for the steady runner, the worst leaf of each and the steadier
  first-step and median-leaf numbers;
- ``--control-seeds``: the control, the plain reference computed with fp8
  (e4m3) operands in the program's place, against the reference (the
  epochs runner takes these from the sound runs of the same seeds);
- ``--fault-seeds``: the program with each of ``--faults`` planted
  (``half_batch``: its steps over half the rows; ``unchanged``: an update
  that leaves the state as it was; the epochs runner's ``stale_order`` and
  ``stale_schedule``: every epoch after the first fed the previous epoch's
  shuffle, or its learning rate).

``--refs`` lists the reference precisions to hold each run against (the
configuration's by default).  Prints one JSON line a run and writes them
all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, harness  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def _worst(prog: dict, ref: dict) -> dict:
    """The leaf behind each norm number."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        r = ref[key]
        floor = statistics.median(r.values())
        gaps = {n: abs(prog[key].get(n, 0.0) - r[n]) / max(r[n], floor, 1e-30)
                for n in r}
        name = max(gaps, key=gaps.get)
        out[key] = [name, gaps[name], r[name], prog[key].get(name)]
    return out


def _diag(prog: dict, ref: dict) -> dict:
    """Steadier numbers beside the compared ones: the first step's loss
    gap and the median leaf's gaps."""
    def med(key):
        r = ref[key]
        floor = statistics.median(r.values())
        return statistics.median(abs(prog[key].get(n, 0.0) - r[n])
                                 / max(r[n], floor, 1e-30) for n in r)
    return {"loss1": abs(prog["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_med": med("grad_norms"), "change_med": med("change_norms")}


def _epochs(drive, cell, dev, args) -> int:
    """The epochs runner: each seed's program once (at ``--seconds``); the
    control's readings for the first seeds of ``--control-seeds`` that are
    also sound seeds come from those runs' final states."""
    lines = []
    control = set(_seeds(args.control_seeds))
    runs = ([(None, s) for s in _seeds(args.seeds)]
            + [(f, s) for s in _seeds(args.fault_seeds)
               for f in args.faults.split(",") if f])
    for fault, seed in runs:
        t0 = time.perf_counter()
        r = drive.Epochs(cell, seed, dev, fault)
        try:
            r.prepare(args.seconds)
            r.train()
            prog = r.program_readings()
            r.release()
            ref = r.reference_readings(prog)
            feed = r.feed()
            kinds = [(fault or "sound", prog)]
            if fault is None and seed in control:
                fp8 = r.reference_readings(prog, "fp8")
                fp8["latest"] = ref["latest"]
                kinds.append(("control_fp8", fp8))
        finally:
            r.close()
        for kind, got in kinds:
            line = {"kind": kind, "seed": seed, "epochs": r.epochs,
                    "seconds": time.perf_counter() - t0,
                    "numbers": {**drive.numbers(got, ref), **feed},
                    "losses": got["losses"], "ref_losses": ref["losses"],
                    "val": got["val"], "ref_val": ref["val"]}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")
    return 0


def main(argv=None, root: Path = ROOT, bench_dir: Path | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="half_batch,unchanged")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--refs", default="")
    args = ap.parse_args(argv)
    bench_dir = bench_dir or harness.HERE
    harness.set_caches(root)
    cell = harness.load_cell(root, args.workload, bench_dir)
    import torch

    dev = torch.device(args.device)
    drive = harness.runner(cell.traffic["runner"], bench_dir)
    lines = []

    def emit(kind, seed, prog, refs, t0):
        line = {"kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
                "losses": prog["losses"]}
        for name, ref in refs.items():
            line[name] = {"numbers": check.numbers(prog, ref),
                          "diag": _diag(prog, ref),
                          "worst": _worst(prog, ref),
                          "losses": ref["losses"]}
        lines.append(line)
        print(json.dumps(line), flush=True)

    def refs(r):
        return {p: r.reference_readings(p)
                for p in (args.refs.split(",") if args.refs else [r.precision])}

    if hasattr(drive, "Epochs"):
        return _epochs(drive, cell, dev, args)
    runs = ([("sound", s, None) for s in _seeds(args.seeds)]
            + [(f, s, f) for s in _seeds(args.fault_seeds)
               for f in args.faults.split(",") if f])
    for kind, seed, fault in runs:
        t0 = time.perf_counter()
        r = drive.Steady(cell, seed, dev, fault)
        try:
            r.setup()
        finally:
            r.close()
        emit(kind, seed, r.readings, refs(r), t0)
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        r = drive.Steady(cell, seed, dev)
        r.make_inputs()
        emit("control_fp8", seed, r.reference_readings("fp8"), refs(r), t0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
