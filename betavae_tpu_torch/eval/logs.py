"""Training-log tooling: parse, plot and repair ``METRICS {json}`` logs.

The port's own copy of ``betavae_tpu/eval/logs.py``, without pandas or
matplotlib, for the CLIs ``plot_logs``, ``plot_phase_losses``,
``fix_steps`` and ``make_recon_gif`` under ``betavae_tpu_torch/scripts/``:

- :func:`iter_metrics`: every ``METRICS {json}`` payload of a log, in
  order, lines that do not parse skipped;
- :func:`parse_metrics`: those payloads as a table of columns, ``{key:
  numpy array}`` with the keys in order of first appearance and one entry
  per record, NaN where a record lacks the key or holds ``null``: float64
  where every value is a number, else an object array (the columns of the
  JAX package's DataFrame);
- :func:`train_metrics_figure` / :func:`phase_losses_figure`: the JAX
  figures' series (:func:`train_metrics_series`,
  :func:`phase_losses_series`: the first ``skip_first_train`` train points
  dropped, val epochs times ``val_step_scale`` where val records carry no
  step) drawn with PIL (``eval/plots.py``);
- :func:`rewrite_val_steps`: val records given the preceding train step;
- :func:`epoch_sort_key` / :func:`recon_gif`: the recon panels in
  numeric order, their bottom (reconstruction) halves as a GIF.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

from . import plots

_METRICS_RE = re.compile(r"METRICS (\{.*\})")

TRAIN_PANEL_KEYS = ("train_total_loss", "train_recon_loss", "train_kl",
                    "train_kl_mean", "train_kl_effective_last")


def iter_metrics(log_path) -> "list[dict]":
    """All METRICS payloads in a log file, in order."""
    log_path = Path(log_path)
    if not log_path.exists():
        raise FileNotFoundError(f"Log file not found: {log_path}")
    records = []
    for line in log_path.read_text(encoding="utf-8").splitlines():
        m = _METRICS_RE.search(line)
        if not m:
            continue
        try:
            records.append(json.loads(m.group(1)))
        except json.JSONDecodeError:
            continue
    return records


def _is_number(v) -> bool:
    return v is None or (isinstance(v, (int, float)) and not isinstance(v, bool))


def parse_metrics(log_path) -> dict:
    """METRICS payloads as ``{key: column}`` (see the module docstring)."""
    records = iter_metrics(log_path)
    keys = list(dict.fromkeys(k for r in records for k in r))
    table = {}
    for key in keys:
        vals = [r.get(key) for r in records]
        dtype = np.float64 if all(map(_is_number, vals)) else object
        table[key] = np.array([np.nan if v is None else v for v in vals],
                              dtype=dtype)
    return table


def _phase_rows(table: dict, phase: str) -> np.ndarray:
    if "phase" not in table:
        return np.zeros(0, np.int64)
    return np.flatnonzero(table["phase"] == phase)


def _present(table: dict, key: str, rows: np.ndarray) -> bool:
    """``key`` is a column holding a value in one of ``rows``."""
    if key not in table or not len(rows):
        return False
    col = table[key][rows]
    return bool(np.any([not (isinstance(v, float) and np.isnan(v))
                        for v in col]))


def _x_axis(table: dict, rows: np.ndarray) -> np.ndarray:
    """The rows' steps, else their record positions."""
    if _present(table, "step", rows):
        return table["step"][rows].astype(np.float64)
    return rows.astype(np.float64)


def train_metrics_series(table: dict, keys=TRAIN_PANEL_KEYS) -> dict:
    """``{key: (x, y)}`` over the train records, ``None`` for a key the log
    lacks; raises where there is no train record."""
    rows = _phase_rows(table, "train")
    if not len(rows):
        raise ValueError("No train-phase metrics found in the log.")
    x = _x_axis(table, rows)
    return {key: (x, table[key][rows].astype(np.float64))
            if key in table else None for key in keys}


def phase_losses_series(table: dict, skip_first_train: int = 7,
                        val_step_scale: int = 180) -> dict:
    """``{"train_total_loss": (x, y), "val_total_loss": (x, y)}``, each
    where the log holds it: the train records after the first
    ``skip_first_train``, the val records on their steps, else their epochs
    times ``val_step_scale``, else their record positions."""
    if "phase" not in table:
        raise ValueError("No phase column found in metrics log.")
    train = _phase_rows(table, "train")[skip_first_train:]
    val = _phase_rows(table, "val")
    if not len(train) and not len(val):
        raise ValueError("No train or val metrics found in the log.")
    series = {}
    if _present(table, "train_total_loss", train):
        series["train_total_loss"] = (
            _x_axis(table, train),
            table["train_total_loss"][train].astype(np.float64))
    if _present(table, "val_total_loss", val):
        if _present(table, "step", val):
            xv = table["step"][val].astype(np.float64)
        elif _present(table, "epoch", val):
            xv = table["epoch"][val].astype(np.float64) * val_step_scale
        else:
            xv = val.astype(np.float64)
        series["val_total_loss"] = (
            xv, table["val_total_loss"][val].astype(np.float64))
    return series


def _limits(values: list) -> tuple:
    """The finite span of ``values`` with 5 % of room at each end."""
    finite = np.concatenate([v[np.isfinite(v)] for v in values] + [[]])
    if not finite.size:
        return 0.0, 1.0
    lo, hi = float(finite.min()), float(finite.max())
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    return lo - pad, hi + pad


def _axes(draw: ImageDraw.ImageDraw, box: tuple, series: list,
          title: str | None = None) -> plots.Axes:
    """Axes over ``box`` spanning ``series`` (``(x, y)`` pairs), with ticks
    and a dashed grid."""
    xlim = _limits([x for x, _ in series])
    ylim = _limits([y for _, y in series])
    ax = plots.Axes(draw, box, xlim, ylim, title=title)
    xt = plots.nice_ticks(*xlim) + 0.0      # + 0.0: no "-0" label
    yt = plots.nice_ticks(*ylim) + 0.0
    for v in xt:
        ax.line([v, v], list(ylim), "#dddddd", dashed=True, width=1)
    for v in yt:
        ax.line(list(xlim), [v, v], "#dddddd", dashed=True, width=1)
    ax.xticks(xt)
    ax.yticks(yt)
    return ax


_BLUE, _ORANGE = plots.TAB10[0], plots.TAB10[1]


def train_metrics_figure(table: dict, keys=TRAIN_PANEL_KEYS) -> Image.Image:
    """One panel per key over the train steps, stacked (1200 × 1800 px,
    the JAX figure's 8 × 12 in at 150 dpi)."""
    series = train_metrics_series(table, keys)
    img = Image.new("RGB", (1200, 1800), "white")
    draw = ImageDraw.Draw(img)
    plots.centered_text(draw, (600, 20), "Train metrics")
    left, right, top, height, gap = 200, 1170, 50, 290, 50
    for i, key in enumerate(keys):
        y0 = top + i * (height + gap)
        box = (left, y0, right, y0 + height)
        plots.centered_text(draw, (95, y0 + height / 2), key)
        if series[key] is None:
            draw.rectangle(box, outline="black")
            plots.centered_text(draw, ((left + right) / 2, y0 + height / 2),
                                f"{key} not found")
            continue
        ax = _axes(draw, box, [series[key]])
        ax.line(*series[key], _BLUE)
    plots.centered_text(draw, ((left + right) / 2, 1780), "step")
    return img


def phase_losses_figure(table: dict, skip_first_train: int = 7,
                        val_step_scale: int = 180) -> Image.Image:
    """Train and val total losses on one step axis (1500 × 600 px, the JAX
    figure's 10 × 4 in at 150 dpi); val dashed."""
    series = phase_losses_series(table, skip_first_train, val_step_scale)
    img = Image.new("RGB", (1500, 600), "white")
    draw = ImageDraw.Draw(img)
    box = (110, 40, 1470, 530)
    if not series:
        draw.rectangle(box, outline="black")
        plots.centered_text(draw, (790, 285), "No total losses found")
    else:
        ax = _axes(draw, box, list(series.values()), title="Total loss")
        style = {"train_total_loss": (_BLUE, False),
                 "val_total_loss": (_ORANGE, True)}
        for name, (x, y) in series.items():
            ax.line(x, y, style[name][0], dashed=style[name][1])
        ax.legend([(name, *style[name]) for name in series])
    plots.centered_text(draw, (790, 575), "step")
    plots.centered_text(draw, (30, 285), "loss")
    return img


def rewrite_val_steps(input_path, output_path) -> int:
    """Write ``input_path`` to ``output_path`` with every val record given
    the preceding train record's step; returns how many were rewritten."""
    fixed = 0
    last_train_step = None
    out_lines = []
    for line in Path(input_path).read_text().splitlines(keepends=True):
        m = _METRICS_RE.search(line)
        if m:
            try:
                payload = json.loads(m.group(1))
            except json.JSONDecodeError:
                out_lines.append(line)
                continue
            phase = payload.get("phase")
            if phase == "train" and "step" in payload:
                last_train_step = payload["step"]
            elif phase == "val" and last_train_step is not None:
                payload["step"] = last_train_step
                fixed += 1
            rendered = json.dumps(payload, separators=(", ", ": "))
            out_lines.append(line[: m.start(1)] + rendered + "\n")
        else:
            out_lines.append(line)
    Path(output_path).write_text("".join(out_lines))
    return fixed


_EPOCH_RE = re.compile(r"(\d+)")


def epoch_sort_key(path):
    """Numeric-aware ordering, so epoch10 follows epoch2."""
    nums = [int(n) for n in _EPOCH_RE.findall(Path(path).stem)]
    return (nums, str(path))


def recon_gif(figures_dir, pattern: str = "recon_epoch*.png",
              output: str = "recons_only.gif", duration_ms: int = 200,
              crop_bottom_half: bool = True,
              include_diff: bool = False) -> Path:
    """Animate the recon panels (their bottom, reconstruction half by
    default) into ``<figures_dir>/<output>``."""
    figures_dir = Path(figures_dir)
    files = sorted(figures_dir.glob(pattern), key=epoch_sort_key)
    if not include_diff:
        files = [f for f in files if "_diff" not in f.stem]
    if not files:
        raise FileNotFoundError(
            f"No files matching {pattern} found in {figures_dir}")

    frames = []
    for f in files:
        with Image.open(f) as img:
            if crop_bottom_half:
                w, h = img.size
                img = img.crop((0, h // 2, w, h))
            frames.append(img.copy())
    out_path = figures_dir / output
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return out_path
