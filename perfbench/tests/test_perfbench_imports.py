"""What the benchmark runs imports neither JAX nor the JAX package, and
its reference nothing of the program. Top-level names compared whole:
``vers_tpu_torch`` is not ``vers_tpu``."""

import ast

import pytest

from perfbench.bench.registry import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "vers_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert tops <= {"__future__", "contextlib", "typing", "numpy", "torch"}


def test_whole_names():
    tops = {m.split(".")[0] for f in FILES for m in imported(f)}
    assert "vers_tpu_torch" in tops and "vers_tpu" not in tops
