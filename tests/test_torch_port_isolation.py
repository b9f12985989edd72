"""The port stands alone: no JAX, no ``betavae_tpu``, no silent CPU.

Every module of ``betavae_tpu_torch`` and ``chip_smoke.py`` is scanned for
imports of ``jax``, ``flax``, ``optax`` or ``betavae_tpu``; importing every
module in a fresh interpreter must leave JAX and the JAX package unloaded;
and the entry points' default device must raise where there is no GPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "betavae_tpu"}
PORT_FILES = sorted((ROOT / "betavae_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _absolute_imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import betavae_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'optax',"
        " 'betavae_tpu')))\n")
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
    from betavae_tpu_torch.train.loop import train_steps

    path = demo_config_factory()
    reset_config_cache()
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            model_from_config(get_config(path))
        with pytest.raises(RuntimeError, match="cuda"):
            train_steps(path, max_steps=1)
    finally:
        reset_config_cache()
