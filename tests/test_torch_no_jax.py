"""The port stands alone: no module of vers_tpu_torch imports jax or
the JAX package, and importing it pulls in neither."""

import ast
import pathlib
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "vers_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_vers_tpu_imports():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 16
    bad = [
        (str(f.relative_to(PKG)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "vers_tpu")
    ]
    assert not bad, bad


def test_import_loads_neither_jax_nor_vers_tpu():
    # compare module sets before and after the import: an interpreter
    # may load jax at startup on its own
    code = (
        "import sys; before = set(sys.modules); "
        "import vers_tpu_torch, vers_tpu_torch.ops.binned, "
        "vers_tpu_torch.ops.kmeans, vers_tpu_torch.utils.parity; "
        "print(sorted(m for m in set(sys.modules) - before "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'vers_tpu')))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=PKG.parent, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout
