"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import harness, imports

FILES = sorted(p for p in harness.PACKAGE.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = harness.PACKAGE / "reference"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.PACKAGE)))
def test_no_file_imports_jax_or_the_jax_package(path: Path):
    names = imports.imported_names(path)
    assert not names & set(imports.FORBIDDEN), names


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_torch_numpy_and_itself(path: Path):
    tree = ast.parse(path.read_text())
    modules = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    modules |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    for m in modules:
        assert (m in ("__future__", "contextlib", "dataclasses", "math", "typing", "numpy")
                or m.split(".")[0] == "torch" or m.startswith("portbench.reference")), m


def test_top_level_names_are_compared_whole():
    assert imports.loaded_forbidden({"otpose_tpu_torch": 1, "otpose_tpu_torch.models": 1,
                                     "jaxtyping": 1, "numpy": 1}) == []
    assert imports.loaded_forbidden({"otpose_tpu.models": 1, "jax": 1, "jaxlib.xla": 1}) == [
        "jax", "jaxlib", "otpose_tpu"]


def test_import_scan_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom otpose_tpu.models import x\n"
                   "import importlib\nimportlib.import_module('flax.linen')\nfrom . import y\n")
    assert imports.imported_names(src) == {"jax", "otpose_tpu", "importlib", "flax"}
