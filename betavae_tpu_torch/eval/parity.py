"""Metric parity: one ``metrics_summary.csv`` against a reference one.

The port's own copy of ``betavae_tpu/eval/parity.py`` (the same families,
default tolerances, verdicts and report), for
``python -m betavae_tpu_torch.scripts.parity_check``:

- ``recon`` (MSE, PSNR and SSIM means, per class): relative ``rtol_recon``,
  5 % by default, since the evaluation's sampling forward makes equality
  impossible by design;
- ``std``: relative ``rtol_std`` (25 %);
- ``loose`` (probe, silhouette, traversal, F1, AUC): absolute
  ``atol_loose`` (0.05), as they hang on the probe's solver and split;
- ``exact`` (counts, class lists): equal, or the datasets differ.

A reference metric absent from ours is ``MISSING``; ours that the
reference lacks are listed, not compared.
"""

from __future__ import annotations

import csv
import json
import math


# metric-name → comparison family
_EXACT_SUBSTR = ("count", "classes")
_LOOSE_SUBSTR = ("probe", "silhouette", "f1", "auc", "traversal")


def load_metrics_csv(path: str) -> dict:
    """Read a ``metric,value`` CSV into {name: float | str}."""
    out = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        if header[:2] != ["metric", "value"]:
            raise ValueError(f"{path}: expected 'metric,value' header, "
                             f"got {header}")
        for row in reader:
            if len(row) < 2:  # blank lines, stray footers, lone names
                continue
            name, value = row[0], row[1]
            try:
                out[name] = float(value)
            except ValueError:
                out[name] = value  # JSON-ish fields (lists, matrices)
    return out


def _family(name: str) -> str:
    low = name.lower()
    if any(s in low for s in _EXACT_SUBSTR):
        return "exact"
    if any(s in low for s in _LOOSE_SUBSTR):
        return "loose"
    if low.endswith("_std"):
        return "std"
    return "recon"


def compare_metrics(reference: dict, ours: dict, *,
                    rtol_recon: float = 0.05, rtol_std: float = 0.25,
                    atol_loose: float = 0.05) -> dict:
    """Per-metric verdicts (``OK``, ``FAIL``, ``MISSING``) by family, as
    the module docstring sets out; ``parity`` is true when no row failed
    or is missing."""
    rows = []
    for name, ref_val in reference.items():
        fam = _family(name)
        if name not in ours:
            rows.append({"metric": name, "family": fam, "ref": ref_val,
                         "ours": None, "status": "MISSING"})
            continue
        our_val = ours[name]
        if fam == "exact" or isinstance(ref_val, str) or isinstance(our_val,
                                                                    str):
            ok = str(ref_val) == str(our_val)
            rows.append({"metric": name, "family": fam, "ref": ref_val,
                         "ours": our_val,
                         "status": "OK" if ok else "FAIL"})
            continue
        if not (math.isfinite(ref_val) and math.isfinite(our_val)):
            ok = (math.isnan(ref_val) and math.isnan(our_val))
            rows.append({"metric": name, "family": fam, "ref": ref_val,
                         "ours": our_val,
                         "status": "OK" if ok else "FAIL"})
            continue
        if fam == "loose":
            err = abs(our_val - ref_val)
            ok = err <= atol_loose
            rows.append({"metric": name, "family": fam, "ref": ref_val,
                         "ours": our_val, "abs_diff": round(err, 6),
                         "status": "OK" if ok else "FAIL"})
        else:
            rtol = rtol_recon if fam == "recon" else rtol_std
            denom = max(abs(ref_val), 1e-12)
            rel = abs(our_val - ref_val) / denom
            ok = rel <= rtol
            rows.append({"metric": name, "family": fam, "ref": ref_val,
                         "ours": our_val, "rel_diff": round(rel, 6),
                         "status": "OK" if ok else "FAIL"})
    extra = sorted(set(ours) - set(reference))
    n_fail = sum(r["status"] == "FAIL" for r in rows)
    n_missing = sum(r["status"] == "MISSING" for r in rows)
    return {"rows": rows, "extra_in_ours": extra,
            "n_compared": len(rows), "n_fail": n_fail,
            "n_missing": n_missing,
            "parity": n_fail == 0 and n_missing == 0}


def format_report(result: dict) -> str:
    lines = [f"{'metric':<42} {'ref':>14} {'ours':>14} {'diff':>10} status"]
    for r in result["rows"]:
        diff = r.get("rel_diff", r.get("abs_diff", ""))
        diff = f"{diff:.4f}" if isinstance(diff, float) else str(diff)
        ref = (f"{r['ref']:.6g}" if isinstance(r["ref"], float)
               else str(r["ref"])[:14])
        ours = (f"{r['ours']:.6g}" if isinstance(r["ours"], float)
                else str(r["ours"])[:14])
        lines.append(f"{r['metric']:<42} {ref:>14} {ours:>14} "
                     f"{diff:>10} {r['status']}")
    if result["extra_in_ours"]:
        lines.append(f"(ours-only metrics, not compared: "
                     f"{', '.join(result['extra_in_ours'])})")
    lines.append(f"PARITY {json.dumps({k: result[k] for k in ('n_compared', 'n_fail', 'n_missing', 'parity')})}")
    return "\n".join(lines)
