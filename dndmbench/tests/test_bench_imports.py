"""Nothing the benchmark runs imports JAX, Flax or the JAX package
``repro``; the reference imports nothing of the port either.  Top-level
names are compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import sys

import pytest

from dndmbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(p for p in harness.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_imports(path):
    found = set(_imports(path))
    assert not found & FORBIDDEN, f"{path}: {sorted(found & FORBIDDEN)}"
    if "reference" in path.relative_to(harness.BENCH).parts:
        assert "repro_torch" not in found, path


def test_the_run_looks_for_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    found = harness.no_jax()
    assert "repro_torch_x" not in found
    monkeypatch.setitem(sys.modules, "repro.core.fake", sys)
    assert "repro" in harness.no_jax()


def test_a_run_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = harness.main(["--workload", "text8-serve", "--seed", "1",
                       "--seconds", "1"], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""
