"""The comparison that decides ``correct`` for a training cell.

Both sides give their readings of the first steps from one state: each
step's loss, each leaf's norm of the first step's gradient as the optimizer
gets it (after the clip), and each leaf's norm of the change of its
parameters over the steps.  The numbers compared:

- ``loss1``: the first step's ``|L − L_ref| / |L_ref|``, and ``loss`` the
  largest over the steps (reported; the later steps' losses move with
  Adam's near-sign updates of leaves whose gradient is near nought, so the
  limits hold the first);
- ``grad``: the worst leaf's ``|‖g‖ − ‖g_ref‖| / max(‖g_ref‖, median
  leaf's ‖g_ref‖)``;
- ``change_median``: the median leaf's ``|‖Δp‖ − ‖Δp_ref‖| / max(‖Δp_ref‖,
  median leaf's ‖Δp_ref‖)`` over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (a leaf whose gradient is nought
  to rounding moves under Adam by round-off alone), and ``change`` the
  worst of those leaves (reported: the worst is always one of the small
  SE or first-block leaves, whose near-sign Adam updates flip with the
  rounding, so the limits hold the median).

Each has its limit in the cell's file (``workloads/<cell>.json``); the run
is correct when every number is finite and at most its limit.
"""

from __future__ import annotations

import math
import statistics

MOVED = 1e-3
# the first steps of the run that both sides give readings of
CHECK_STEPS = 3


def _gaps(prog: dict, ref: dict, names) -> list:
    names = list(names)
    if set(prog) != set(ref) or not names:
        return [math.inf]
    floor = statistics.median(ref[n] for n in ref)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def numbers(prog: dict, ref: dict) -> dict:
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss1": math.inf, "loss": math.inf, "grad": math.inf,
                "change": math.inf}
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    loss = max(gaps)
    g_ref = ref["grad_norms"]
    floor = statistics.median(g_ref.values())
    moved = [n for n, g in g_ref.items() if g >= MOVED * floor]
    change = _gaps(prog["change_norms"], ref["change_norms"], moved)
    return {"loss1": gaps[0] if math.isfinite(gaps[0]) else math.inf,
            "loss": loss if math.isfinite(loss) else math.inf,
            "grad": max(_gaps(prog["grad_norms"], g_ref, g_ref)),
            "change_median": statistics.median(change),
            "change": max(change)}


def judge(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: ``checks`` maps each name to its number and
    its limit, in the order of ``limits``."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        ok = ok and math.isfinite(v) and v <= limit
        checks[name] = {"value": v if math.isfinite(v) else str(v),
                        "limit": limit}
    return ok, checks
