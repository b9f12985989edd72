"""The port stands alone: no JAX, no ``betavae_tpu``, no silent CPU.

Every module of ``betavae_tpu_torch``, ``chip_smoke.py`` and each code
cell of ``notebooks/train_and_eval_torch.ipynb`` is scanned for imports of
``jax``, ``flax``, ``optax`` or ``betavae_tpu``, of the JAX scripts'
``_bootstrap``, and of matplotlib, pandas or scikit-learn, which the
card's install lacks; importing every module in a fresh interpreter must
leave all of them unloaded; the entry points that build the model must
raise by default where there is no GPU; and the notebook's first code cell
sets ``DEVICE = "cuda"`` and no cell asks whether a GPU is there.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from betavae_tpu_torch.utils.notebook import code_cells

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "betavae_tpu", "_bootstrap",
             "matplotlib", "pandas", "sklearn"}
PORT_FILES = sorted((ROOT / "betavae_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


NOTEBOOK = ROOT / "notebooks" / "train_and_eval_torch.ipynb"
NOTEBOOK_CELLS = code_cells(NOTEBOOK)


def _absolute_imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [m for m in _absolute_imports(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("index", range(len(NOTEBOOK_CELLS)))
def test_notebook_cell_imports_no_jax(index):
    tree = ast.parse(NOTEBOOK_CELLS[index], f"{NOTEBOOK.name}[{index}]")
    bad = [m for m in _absolute_imports(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"code cell {index} imports {bad}"


def test_notebook_runs_on_the_card_unless_told():
    """The parameter cell is ``DEVICE = "cuda"`` alone, and no cell asks
    ``torch.cuda.is_available()``: a run without a GPU fails rather than
    taking the CPU."""
    (param,) = ast.parse(NOTEBOOK_CELLS[0]).body
    assert isinstance(param, ast.Assign)
    assert [t.id for t in param.targets] == ["DEVICE"]
    assert isinstance(param.value, ast.Constant)
    assert param.value.value == "cuda"
    for index, source in enumerate(NOTEBOOK_CELLS):
        for node in ast.walk(ast.parse(source)):
            assert not (isinstance(node, ast.Attribute)
                        and node.attr == "is_available"), \
                f"code cell {index} asks whether a GPU is there"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import betavae_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"print(sorted(k for k in sys.modules\n"
        f"             if k.split('.')[0] in {sorted(FORBIDDEN)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_raises_without_a_gpu(demo_config_factory):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from betavae_tpu_torch.config import get_config, reset_config_cache
    from betavae_tpu_torch.models.beta_vae import model_from_config
    from betavae_tpu_torch.scripts import (diag_overfit,
                                           generate_umap_and_grid,
                                           parity_check, traverse_image)
    from betavae_tpu_torch.train.loop import train, train_steps

    path = demo_config_factory()
    reset_config_cache()
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            model_from_config(get_config(path))
        with pytest.raises(RuntimeError, match="cuda"):
            train_steps(path, max_steps=1)
        with pytest.raises(RuntimeError, match="cuda"):
            train(path)
        for main, argv in (
                (traverse_image.main, ["--image", "x.png"]),
                (diag_overfit.main, []),
                (generate_umap_and_grid.main, ["--skip-grid"]),
                (parity_check.main, ["--reference-tables", ".",
                                     "--run-eval"])):
            reset_config_cache()
            with pytest.raises(RuntimeError, match="cuda"):
                main(["--config", path, *argv])
    finally:
        reset_config_cache()
