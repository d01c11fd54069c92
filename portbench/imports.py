"""The benchmark measures the PyTorch port alone: nothing it runs may load
JAX or the JAX package.  Names are compared by their whole top-level
part (before the first dot), so ``otpose_tpu_torch`` is not
``otpose_tpu``.  The reference may not load the port either."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "otpose_tpu")
PROGRAM = "otpose_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names if top(n) in FORBIDDEN})


def imported_names(path: Path) -> set:
    """The top-level names that ``path``'s import statements name, and
    those of ``importlib.import_module`` / ``__import__`` calls on a
    literal."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(top(node.module))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            names.add(top(node.args[0].value))
    return names
