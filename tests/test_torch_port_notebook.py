"""The port's demo notebook against the JAX package's, on the CPU.

``notebooks/train_and_eval_torch.ipynb`` runs every code cell in order
(``utils/notebook.py::run_notebook``, ``DEVICE = "cpu"``) in a copy of
``notebooks/`` and ``configs/demo_notebook.yaml`` under a temporary
folder.  ``notebooks/train_and_eval.ipynb`` runs in a second copy: its
set-up and data cells, then, on the port's ``best`` checkpoint copied
into that tree, its evaluation cells 4–6 (evaluation, reconstructions,
latent figures), not its training cell.  The JAX package's keys and files
of training come from a JAX ``train()`` of the same config cut to two
train batches and one validation batch an epoch, in a third tree.  Held:

- (a) the demo data byte for byte the JAX cell's;
- (b) the port's ``METRICS`` lines the JAX keys in each phase (``train``,
  ``val``, ``epoch_end``, ``eval``);
- (c) the checkpoints, figures, tables and log the JAX runs' file names;
- (d) the reconstruction figure's 8 reconstructions (z = μ) JAX's
  ``model.forward(..., deterministic=True)`` on the same weights within
  rtol 1e-5, atol 1e-6 (fp32 on the CPU), the figure their panels;
- (e) the two ``evaluate_full`` reports, and their
  ``metrics_summary.csv``, under ``eval/parity.py::compare_metrics``'
  defaults (sampling is on in this config, so the two packages' noise
  agrees in distribution only), NaN equal to NaN.
"""

import shutil
import sys
from pathlib import Path

import matplotlib.pyplot as plt
import numpy as np
import pytest
import yaml
from PIL import Image

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.data.demo import generate_demo_data as jax_demo_data
from betavae_tpu.eval.logs import iter_metrics
from betavae_tpu.eval.parity import compare_metrics, load_metrics_csv
from betavae_tpu.logging_utils import reset_logger as jax_reset_logger
from betavae_tpu.train.loop import train as jax_train

from betavae_tpu_torch.config import reset_config_cache
from betavae_tpu_torch.eval.plots import image_panel
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.utils.notebook import code_cells, run_cell, run_notebook

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configs" / "demo_notebook.yaml"
PORT_NB, JAX_NB = "train_and_eval_torch.ipynb", "train_and_eval.ipynb"
# the JAX notebook's code cells: set-up, data, train, evaluation,
# reconstructions, latent figures
JAX_TRAIN_CELL = 2
OUT, DATA = "outputs_demo", "data/demo_processed"


def _tree(root: Path) -> Path:
    """A copy of both notebooks and the demo config under ``root``."""
    (root / "notebooks").mkdir(parents=True)
    (root / "configs").mkdir()
    for name in (PORT_NB, JAX_NB):
        shutil.copy(ROOT / "notebooks" / name, root / "notebooks" / name)
    shutil.copy(CONFIG, root / "configs" / CONFIG.name)
    return root


def _reset_both():
    reset_config_cache()
    reset_logger()
    jax_reset_config()
    jax_reset_logger()


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _jax_training_tree(root: Path) -> Path:
    """JAX ``train()`` on the demo config, its paths under ``root`` and its
    epochs cut to 2 train batches and 1 validation batch."""
    cfg = yaml.safe_load(CONFIG.read_text())
    for key in ("raw_dir", "processed_dir", "labels_csv", "outputs_dir",
                "models_dir", "figures_dir", "tables_dir"):
        cfg["paths"][key] = str(root / cfg["paths"][key])
    cfg["debug"].update(max_train_batches=2, max_val_batches=1)
    root.mkdir()
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    jax_demo_data(cfg["paths"]["processed_dir"], train_per_class=24,
                  test_per_class=12, size=cfg["data"]["image_size"])
    jax_get_config(str(path))
    jax_train()
    return root


def _run_jax_cells(nb: Path, port_models: Path) -> dict:
    """The JAX notebook's set-up and data cells, then its evaluation cells
    on the port's checkpoints; each cell's value by index."""
    namespace, values = {"__name__": "__main__"}, {}
    for i, source in enumerate(code_cells(nb)):
        if i == JAX_TRAIN_CELL:
            shutil.copytree(port_models, nb.parent.parent / OUT / "models")
            continue
        values[i] = run_cell(source, namespace, f"{nb.name}[{i}]")
    plt.close("all")
    return {"namespace": namespace, "values": values}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("notebook")
    port, jax_root = _tree(root / "port"), _tree(root / "jax")
    _reset_both()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPLBACKEND", "Agg")
        try:
            training = _jax_training_tree(root / "jax_train")
            _reset_both()
            port_run = run_notebook(port / "notebooks" / PORT_NB,
                                    device="cpu")
            _reset_both()
            # what the JAX cells change: put back when the context ends
            mp.chdir(jax_root / "notebooks")
            mp.setattr(sys, "path", list(sys.path))
            mp.setenv("CONFIG_PATH", str(jax_root / "configs" / CONFIG.name))
            jax_run = _run_jax_cells(jax_root / "notebooks" / JAX_NB,
                                     port / OUT / "models")
        finally:
            _reset_both()
    return {"port": port, "jax": jax_root, "training": training,
            "port_run": port_run, "jax_run": jax_run}


def test_every_port_cell_ran_on_the_cpu(runs):
    ns, values = runs["port_run"]["namespace"], runs["port_run"]["values"]
    assert len(values) == len(code_cells(ROOT / "notebooks" / PORT_NB))
    assert ns["DEVICE"] == "cpu"
    assert ns["model"].fc_mu.weight.device.type == "cpu"
    assert (ns["state"]["epoch"], ns["state"]["total_steps"]) == (5, 30)
    assert values[1] == ("demo_notebook", 64, 16)


def test_demo_data_is_the_jax_cells_bytes(runs):
    got = _files(runs["port"] / DATA)
    want = _files(runs["jax"] / DATA)
    assert len(got) == 4 * (24 + 12)
    assert list(got) == list(want)
    assert got == want


def test_metrics_lines_have_the_jax_keys(runs):
    port = iter_metrics(runs["port"] / OUT / "logs" / "demo_notebook.log")
    jax_lines = (iter_metrics(runs["training"] / OUT / "logs"
                              / "demo_notebook.log")
                 + iter_metrics(runs["jax"] / OUT / "logs"
                                / "demo_notebook.log"))
    for phase in ("train", "val", "epoch_end", "eval"):
        keys = {tuple(m) for m in port if m["phase"] == phase}
        assert keys, phase
        assert keys == {tuple(m) for m in jax_lines if m["phase"] == phase}, \
            phase


def test_files_written_are_the_jax_cells_names(runs):
    def listing(root, sub=""):
        return {str(p.relative_to(root / OUT))
                for p in (root / OUT / sub).rglob("*") if p.is_file()}

    models = listing(runs["port"], "models")
    assert models == listing(runs["training"], "models") == {
        f"models/demo_notebook_{tag}_shard{i}.pt"
        for tag in ("best", "latest") for i in (0, 1)}
    # the JAX evaluation cells' files (its models folder is the port's
    # copy) and the JAX training run's
    want = {p for p in listing(runs["jax"]) if not p.startswith("models/")}
    want |= listing(runs["training"])
    assert "figures/latent_scatter_tsne.png" in want
    assert listing(runs["port"]) == want


def test_reconstruction_figure_matches_jax_forward(runs):
    ns = runs["port_run"]["namespace"]
    want = np.asarray(runs["jax_run"]["namespace"]["recon"])
    assert ns["recon"].shape == want.shape == (8, 64, 64, 1)
    np.testing.assert_allclose(ns["recon"], want, rtol=1e-5, atol=1e-6)
    figure = runs["port_run"]["values"][5]
    assert isinstance(figure, Image.Image) and figure is ns["figure"]
    side = 128
    assert figure.size == (8 * side, 2 * side)
    # the panels under the row labels: originals, then reconstructions
    for i in range(1, 8):
        for row, img in ((0, ns["x"][i]), (1, ns["recon"][i])):
            box = (i * side, row * side, (i + 1) * side, (row + 1) * side)
            assert np.array_equal(np.asarray(figure.crop(box)),
                                  np.asarray(image_panel(img, side)))


def test_evaluation_reports_agree_in_distribution(runs):
    got = runs["port_run"]["values"][4]
    want = runs["jax_run"]["values"][3]
    assert list(got) == list(want)
    assert np.isnan(got["probe_macro_auc"]) == np.isnan(
        want["probe_macro_auc"])
    result = compare_metrics(want, got)
    assert result["parity"], [r for r in result["rows"]
                              if r["status"] != "OK"]
    tables = [load_metrics_csv(str(r / OUT / "tables" / "metrics_summary.csv"))
              for r in (runs["jax"], runs["port"])]
    assert list(tables[1]) == list(tables[0])
    result = compare_metrics(*tables)
    assert result["parity"], [r for r in result["rows"]
                              if r["status"] != "OK"]
