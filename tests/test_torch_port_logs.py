"""The port's log tooling and parity check against the JAX package's, on the
CPU.

One METRICS log (CONFIG and junk lines, a line that does not parse, train
records that lack a key, val records with ``step: null``, a string and a
boolean column) goes through both packages' ``eval/logs.py``:

- ``iter_metrics``: equal payloads;
- ``parse_metrics``: the port's columns in the JAX DataFrame's order, NaN
  in the same places, every other value equal;
- the two figures: the port's series equal, bitwise, the x and y data of
  the JAX figures' matplotlib lines (the panels, the skipped train points,
  the val x axis from steps, epochs × 180 or record positions), and both
  raise where the JAX ones do;
- ``rewrite_val_steps``: byte-equal output and the same count;
- ``epoch_sort_key``: the same order;
- ``recon_gif``: bitwise-equal frames (both draw with PIL).

``eval/parity.py``: the same verdicts and report on the tables of
``tests/test_parity_check.py``; the port's ``parity_check`` exits 1 on a
MISSING row.  The four log CLIs run and write their files.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
from PIL import Image, ImageSequence

from betavae_tpu.eval import logs as jax_logs
from betavae_tpu.eval import parity as jax_parity
from test_parity_check import BASE, _write

from betavae_tpu_torch.config import reset_config_cache
from betavae_tpu_torch.eval import logs, parity
from betavae_tpu_torch.scripts import (fix_steps, make_recon_gif,
                                       parity_check, plot_logs,
                                       plot_phase_losses)


def _records(val_x: str) -> list:
    """Train records of 20 steps (``train_kl_effective_last`` from step 4),
    a val record every 5 (x from ``step``, ``epoch`` or neither) and an
    epoch_end record every 10."""
    rows = []
    for s in range(1, 21):
        r = {"phase": "train", "step": s, "epoch": 1 + (s - 1) // 10,
             "beta": 0.1, "train_total_loss": 100.0 / s,
             "train_recon_loss": 90.0 / s, "train_kl": 5.0 + s,
             "train_kl_mean": 0.5 * s}
        if s >= 4:
            r["train_kl_effective_last"] = 5.1 - 0.1 * s
        rows.append(r)
        if s % 5 == 0:
            val = {"phase": "val", "val_total_loss": 95.0 / s,
                   "lpips_weights": "random-init", "is_best": s == 10}
            if val_x == "step":
                val["step"] = s
            elif val_x == "epoch":
                val.update(step=None, epoch=s // 5)
            rows.append(val)
        if s % 10 == 0:
            rows.append({"phase": "epoch_end", "epoch": s // 10,
                         "epoch_wall_seconds": 1.5})
    return rows


def _write_log(path, rows) -> str:
    lines = ["2026-01-01 00:00:00,000 | INFO | CONFIG {\"a\": 1}"]
    for i, r in enumerate(rows):
        lines.append(f"2026-01-01 00:00:{i % 60:02d},000 | INFO | METRICS "
                     + json.dumps(r))
        if i == 3:
            lines.append("a line without metrics")
    lines.append("2026-01-01 00:00:00,000 | INFO | METRICS {not json")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(params=["epoch", "step", "none"])
def log(request, tmp_path):
    return _write_log(tmp_path / "run.log", _records(request.param))


def test_iter_metrics_match_jax(log, tmp_path):
    assert logs.iter_metrics(log) == jax_logs.iter_metrics(log)
    with pytest.raises(FileNotFoundError):
        logs.iter_metrics(tmp_path / "absent.log")


def test_parse_metrics_columns_match_the_jax_dataframe(log):
    want = jax_logs.parse_metrics(log)
    got = logs.parse_metrics(log)
    assert list(got) == list(want.columns)
    for key, col in got.items():
        ref = want[key].to_numpy()
        assert col.shape == ref.shape, key
        missing = pd.isna(ref)
        np.testing.assert_array_equal(pd.isna(col), missing, err_msg=key)
        assert list(col[~missing]) == list(ref[~missing]), key


def _line_data(line) -> tuple:
    return (np.asarray(line.get_xdata(), np.float64),
            np.asarray(line.get_ydata(), np.float64))


def test_train_figure_series_match_the_jax_figure(log):
    import matplotlib.pyplot as plt

    keys = logs.TRAIN_PANEL_KEYS + ("absent_key",)
    fig = jax_logs.train_metrics_figure(jax_logs.parse_metrics(log), keys)
    try:
        series = logs.train_metrics_series(logs.parse_metrics(log), keys)
        for ax, key in zip(fig.axes, keys):
            if series[key] is None:
                assert not ax.lines, key
                continue
            (line,) = ax.lines
            for got, want in zip(series[key], _line_data(line)):
                np.testing.assert_array_equal(got, want, err_msg=key)
    finally:
        plt.close(fig)
    img = logs.train_metrics_figure(logs.parse_metrics(log), keys)
    assert img.size == (1200, 1800)


@pytest.mark.parametrize("skip", [7, 0, 30])
def test_phase_losses_series_match_the_jax_figure(log, skip):
    import matplotlib.pyplot as plt

    fig = jax_logs.phase_losses_figure(jax_logs.parse_metrics(log),
                                       skip_first_train=skip)
    try:
        want = {line.get_label(): _line_data(line)
                for line in fig.axes[0].lines}
    finally:
        plt.close(fig)
    table = logs.parse_metrics(log)
    got = logs.phase_losses_series(table, skip_first_train=skip)
    assert list(got) == list(want)
    for name, (x, y) in got.items():
        np.testing.assert_array_equal(x, want[name][0], err_msg=name)
        np.testing.assert_array_equal(y, want[name][1], err_msg=name)
    img = logs.phase_losses_figure(table, skip_first_train=skip)
    assert img.size == (1500, 600)


def test_figures_raise_where_jax_raises(tmp_path):
    only_val = _write_log(tmp_path / "val.log",
                          [{"phase": "val", "step": 1, "val_total_loss": 1.0}])
    with pytest.raises(ValueError, match="No train-phase"):
        jax_logs.train_metrics_figure(jax_logs.parse_metrics(only_val))
    with pytest.raises(ValueError, match="No train-phase"):
        logs.train_metrics_figure(logs.parse_metrics(only_val))
    no_phase = _write_log(tmp_path / "nophase.log", [{"step": 1}])
    for pkg in (jax_logs, logs):
        with pytest.raises(ValueError, match="No phase column"):
            pkg.phase_losses_figure(pkg.parse_metrics(no_phase))
    other = _write_log(tmp_path / "other.log", [{"phase": "epoch_end"}])
    for pkg in (jax_logs, logs):
        with pytest.raises(ValueError, match="No train or val"):
            pkg.phase_losses_figure(pkg.parse_metrics(other))


def test_rewrite_val_steps_byte_equal(log, tmp_path):
    n_want = jax_logs.rewrite_val_steps(log, tmp_path / "jax.log")
    n_got = logs.rewrite_val_steps(log, tmp_path / "port.log")
    assert n_got == n_want == 4
    assert (tmp_path / "port.log").read_bytes() == \
        (tmp_path / "jax.log").read_bytes()


def test_epoch_sort_key_orders_as_jax():
    files = ["recon_epoch10.png", "recon_epoch2.png", "recon_epoch1.png",
             "recon_epoch2_diff.png", "a/recon_epoch100.png", "recon.png"]
    assert sorted(files, key=logs.epoch_sort_key) == \
        sorted(files, key=jax_logs.epoch_sort_key)
    assert sorted(files, key=make_recon_gif.natural_sort_key)[:3] == [
        "recon.png", "recon_epoch1.png", "recon_epoch2.png"]


def _panels(root) -> None:
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for e in (1, 2, 10):
        for suffix in ("", "_diff"):
            Image.fromarray(rng.integers(0, 255, (41, 30), np.uint8), "L").save(
                os.path.join(root, f"recon_epoch{e}{suffix}.png"))


@pytest.mark.parametrize("crop,include_diff", [(True, False), (False, True)])
def test_recon_gif_frames_bitwise(tmp_path, crop, include_diff):
    _panels(tmp_path)
    kw = {"crop_bottom_half": crop, "include_diff": include_diff,
          "duration_ms": 150}
    want = jax_logs.recon_gif(tmp_path, output="jax.gif", **kw)
    got = logs.recon_gif(tmp_path, output="port.gif", **kw)
    with Image.open(want) as a, Image.open(got) as b:
        assert b.n_frames == a.n_frames == (6 if include_diff else 3)
        for fa, fb in zip(ImageSequence.Iterator(a), ImageSequence.Iterator(b)):
            assert fb.size == fa.size == ((30, 21) if crop else (30, 41))
            assert fb.info.get("duration") == fa.info.get("duration")
            np.testing.assert_array_equal(np.asarray(fb), np.asarray(fa))
    with pytest.raises(FileNotFoundError):
        logs.recon_gif(tmp_path, pattern="absent*.png")


def _parity_cases() -> dict:
    ours_ok = dict(BASE, mse_mean=0.0049 * 1.03, mse_std=0.0042 * 1.20,
                   probe_macro_auc=0.877 + 0.03)
    missing = dict(BASE)
    del missing["silhouette"]
    return {
        "identical": (BASE, dict(BASE)),
        "within_tolerance": (BASE, ours_ok),
        "recon_fail": (BASE, dict(ours_ok, psnr_mean=23.92 * 1.10)),
        "count_and_missing": (BASE, dict(missing,
                                         **{"per_class/glioma/count": 299.0})),
        "classes": (BASE, dict(BASE, classes="[0, 1]")),
        "extra_and_nan": (dict(BASE, ssim_std=float("nan")),
                          dict(BASE, ssim_std=float("nan"), recon_elbo=1.0)),
    }


@pytest.mark.parametrize("case", list(_parity_cases()))
def test_parity_verdicts_and_report_match_jax(tmp_path, case):
    ref, ours = _parity_cases()[case]
    paths = {}
    for name, table in (("ref", ref), ("ours", ours)):
        paths[name] = str(tmp_path / f"{name}.csv")
        _write(paths[name], table)
    with open(paths["ours"], "a", newline="") as f:
        f.write("orphan_metric_name\n\n")
    loaded = {k: parity.load_metrics_csv(p) for k, p in paths.items()}
    # repr, so that NaN rows compare equal
    assert repr(loaded) == repr({k: jax_parity.load_metrics_csv(p)
                                 for k, p in paths.items()})
    got = parity.compare_metrics(loaded["ref"], loaded["ours"])
    want = jax_parity.compare_metrics(loaded["ref"], loaded["ours"])
    assert parity.format_report(got) == jax_parity.format_report(want)
    assert [r["status"] for r in got["rows"]] == \
        [r["status"] for r in want["rows"]]
    assert {k: got[k] for k in ("n_fail", "n_missing", "parity",
                                "extra_in_ours")} == \
        {k: want[k] for k in ("n_fail", "n_missing", "parity",
                              "extra_in_ours")}


def test_parity_check_cli_exits_1_on_a_missing_row(tmp_path,
                                                   demo_config_factory):
    from betavae_tpu_torch.config import get_config

    path = demo_config_factory()
    reset_config_cache()
    cfg = get_config(path)
    os.makedirs(cfg.paths.tables_dir)
    ref_dir = tmp_path / "ref_tables"
    ref_dir.mkdir()
    _write(str(ref_dir / "metrics_summary.csv"), BASE)
    missing = dict(BASE)
    del missing["mse_std"]
    try:
        _write(os.path.join(cfg.paths.tables_dir, "metrics_summary.csv"),
               BASE)
        assert parity_check.main(["--reference-tables", str(ref_dir),
                                  "--config", path]) == 0
        _write(os.path.join(cfg.paths.tables_dir, "metrics_summary.csv"),
               missing)
        assert parity_check.main(["--reference-tables", str(ref_dir),
                                  "--config", path]) == 1
    finally:
        reset_config_cache()


def test_log_clis_write_their_files(tmp_path, demo_config_factory, capsys):
    from betavae_tpu_torch.config import get_config

    path = demo_config_factory()
    reset_config_cache()
    cfg = get_config(path)
    log_path = os.path.join(cfg.paths.outputs_dir, "logs", "testrun.log")
    os.makedirs(os.path.dirname(log_path))
    from pathlib import Path

    _write_log(Path(log_path), _records("epoch"))
    _panels(cfg.paths.figures_dir)
    try:
        out = plot_logs.main(["--config", path])
        assert out.name == "testrun_train_metrics.png" and out.exists()
        out = plot_phase_losses.main(["--config", path])
        assert out.name == "testrun_losses.png" and out.exists()
        custom = tmp_path / "custom.png"
        plot_phase_losses.main(["--config", path, "--log", log_path,
                                "--out", str(custom)])
        assert custom.exists()
        gif = make_recon_gif.main(["--config", path, "--duration", "100"])
        with Image.open(gif) as im:
            assert im.n_frames == 3
    finally:
        reset_config_cache()
    fixed = tmp_path / "fixed.log"
    assert fix_steps.main([log_path, str(fixed)]) == 0
    assert "Rewrote 4 val-phase" in capsys.readouterr().out
    assert [r["step"] for r in logs.iter_metrics(fixed)
            if r["phase"] == "val"] == [5, 10, 15, 20]
    assert fix_steps.main([log_path]) == 1
