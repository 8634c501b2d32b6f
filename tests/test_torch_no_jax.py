"""The port stands alone: no module of vers_tpu_torch (the README API,
the demo and the native IO included), no tool and not the smoke script
imports jax or the JAX package, the native IO builds from the port's own
copy of its C++ source, and importing the package pulls in neither."""

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
    root = PKG.parent
    files = sorted(PKG.rglob("*.py")) + sorted((root / "tools").glob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) >= 30
    assert {"lsh.py", "rpforest.py", "forest_shared.py", "time_kernel_b.py",
            "chip_smoke.py", "beam.py", "beam_inline.py", "hnsw_build.py",
            "hnsw.py", "config.py", "compat.py", "demo.py", "__main__.py",
            "version.py", "logging.py"} <= {f.name for f in files}
    # the native IO: the port's own copy of the C++ source
    assert (PKG / "native" / "__init__.py") in files
    source = PKG / "native" / "io_native.cpp"
    assert source.is_file() and not source.is_symlink()
    # the multi-device layer: the ten modules of vers_tpu/parallel/
    parallel = {f.name for f in (PKG / "parallel").glob("*.py")}
    assert parallel == {f.name for f in (root / "vers_tpu" / "parallel").glob(
        "*.py")}, parallel
    bad = [
        (str(f.relative_to(root)), name)
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
        "vers_tpu_torch.ops.kmeans, vers_tpu_torch.utils.parity, "
        "vers_tpu_torch.index.lsh, vers_tpu_torch.ops.forest_shared, "
        "vers_tpu_torch.index.hnsw, vers_tpu_torch.ops.beam, "
        "vers_tpu_torch.ops.beam_inline, vers_tpu_torch.ops.hnsw_build, "
        "vers_tpu_torch.parallel, vers_tpu_torch.parallel.mesh, "
        "vers_tpu_torch.parallel.search, vers_tpu_torch.parallel.kmeans, "
        "vers_tpu_torch.parallel.sharded_index, vers_tpu_torch.parallel.ivf, "
        "vers_tpu_torch.parallel.lsh, vers_tpu_torch.parallel.lsh_partitioned, "
        "vers_tpu_torch.parallel.partitioned, vers_tpu_torch.parallel.hnsw, "
        "vers_tpu_torch.parallel.hnsw_partitioned, vers_tpu_torch.compat, "
        "vers_tpu_torch.demo, vers_tpu_torch.__main__, vers_tpu_torch.native, "
        "vers_tpu_torch.utils.logging, vers_tpu_torch.version; "
        "vers_tpu_torch.ShardedFlatIndex, vers_tpu_torch.PartitionedHNSWIndex; "
        "print(sorted(m for m in set(sys.modules) - before "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'vers_tpu')))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=PKG.parent, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout
