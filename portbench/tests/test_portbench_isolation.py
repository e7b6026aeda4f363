"""Nothing under portbench imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the program), and
the plain reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from portbench.lib.cell import BENCH

FILES = sorted(BENCH.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "importlib", "math", "torch"}, tops
