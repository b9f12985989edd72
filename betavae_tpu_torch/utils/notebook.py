"""Run a notebook's code cells in order in one namespace, without Jupyter.

The card's install has no Jupyter, so ``chip_smoke.py`` (phase
``notebook``) and the CPU test run ``notebooks/train_and_eval_torch.ipynb``
through :func:`run_notebook`, as a kernel would run it:

- the run starts in the notebook's folder, where a kernel starts, and the
  working directory, ``CONFIG_PATH`` and ``sys.path``, which the
  notebook's first cells change, are put back afterwards;
- ``device``, where given, is set as ``DEVICE`` in the namespace after
  the first code cell (the notebook's parameter cell), as a parameterised
  run sets it;
- a cell whose last statement is an expression gives that value, the one
  Jupyter shows under the cell.

The config and logger singletons are the caller's to reset: the cells
may use either package's.
"""

from __future__ import annotations

import ast
import json
import os
import sys
import time
from pathlib import Path


def code_cells(path) -> list:
    """The source of each code cell of the notebook at ``path``."""
    nb = json.loads(Path(path).read_text())
    return ["".join(cell["source"]) for cell in nb["cells"]
            if cell["cell_type"] == "code"]


def run_cell(source: str, namespace: dict, name: str = "<cell>"):
    """Execute ``source`` in ``namespace``; the value of its last statement
    where that is an expression, else None."""
    tree = ast.parse(source, name)
    last = None
    if tree.body and isinstance(tree.body[-1], ast.Expr):
        last = ast.Expression(tree.body.pop().value)
    exec(compile(tree, name, "exec"), namespace)
    return None if last is None else eval(compile(last, name, "eval"),
                                          namespace)


def run_notebook(path, device: str | None = None, after_cell=None) -> dict:
    """Every code cell of the notebook at ``path``, in order, in one
    namespace.  ``after_cell(i)``, where given, is called after code cell
    ``i``.  Returns ``{"namespace", "values", "seconds"}``: the namespace
    after the last cell, and each cell's value and wall seconds."""
    path = Path(path).resolve()
    cwd, env, sys_path = os.getcwd(), os.environ.get("CONFIG_PATH"), \
        list(sys.path)
    namespace = {"__name__": "__main__"}
    values, seconds = [], []
    os.chdir(path.parent)
    try:
        for i, source in enumerate(code_cells(path)):
            t0 = time.perf_counter()
            values.append(run_cell(source, namespace, f"{path.name}[{i}]"))
            seconds.append(time.perf_counter() - t0)
            if i == 0 and device is not None:
                namespace["DEVICE"] = device
            if after_cell is not None:
                after_cell(i)
    finally:
        os.chdir(cwd)
        sys.path[:] = sys_path
        if env is None:
            os.environ.pop("CONFIG_PATH", None)
        else:
            os.environ["CONFIG_PATH"] = env
    return {"namespace": namespace, "values": values, "seconds": seconds}
