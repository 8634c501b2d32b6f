"""Tiny copies of the benchmark's cells for the CPU tests: the real
configuration and cell files, each configuration cut by its driver's
``tiny`` and each cell's common traffic keys cut to a few calls, in a
temporary directory laid out as ``perfbench/``."""

import json
import shutil
import time
from pathlib import Path

import pytest

from perfbench.bench.registry import HERE, Registry, driver

ROOT = HERE.parent


def make_tiny(dest: Path, src: Path = HERE, bench: dict = None) -> Registry:
    """Tiny copies of ``src``'s configurations and cells (``perfbench/``
    and ``BENCHMARK.json`` unless given) in ``dest``."""
    for sub in ("configs", "workloads"):
        shutil.copytree(src / sub, dest / sub)
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        path = dest / "configs" / f"{cfg['name']}.json"
        c = json.loads(path.read_text())
        path.write_text(json.dumps(driver(c["index"]).tiny(c)))
    for path in (dest / "workloads").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(batch=64, pool_batches=min(t["pool_batches"], 8),
                 warmup_calls=4, trace_calls=4)
        path.write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(dest, dest / "BENCHMARK.json")


@pytest.fixture
def tiny(tmp_path) -> Registry:
    return make_tiny(tmp_path)


def run_tiny(registry, workload, seed=2 ** 31 + 7, system="program", fault=None,
             trace=0, seconds=1):
    """One run of a tiny cell on the CPU: (exit code, result, stderr)."""
    import io

    from perfbench.bench.cli import main

    out, err = io.StringIO(), io.StringIO()
    rc = main(["--workload", workload, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], time.perf_counter(),
              registry=registry, device="cpu", system=system, fault=fault,
              out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
