"""A run's last line: the contract's keys, the cell's metrics, and the
checked numbers with their limits last (on standard output and error)."""

import json

import pytest

from perfbench.bench.registry import HERE, driver
from perfbench.tests.conftest import run_tiny

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tiny, cell):
    rc, res, err = run_tiny(tiny, cell, seconds=3)
    assert rc == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    want = [m["name"] for m in tiny.metrics(cell, trace=False)]
    assert sorted(res["metrics"]) == sorted(want)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    checks = res["checks"]
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    # the driver's declaration holds: its run judges exactly these
    assert set(checks) == set(driver(tiny.cell(cell).config["index"]).CHECKS)
    tail = err.strip().splitlines()[-len(checks):]
    assert [line.split()[1] for line in tail] == list(checks)
    assert all(line.startswith("check ") and line.endswith(" ok") for line in tail)


def test_no_card_no_result(tiny, capsys):
    import time

    import torch

    from perfbench.bench.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
              time.perf_counter(), registry=tiny)
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    import sys
    import types

    from perfbench.bench import cli

    monkeypatch.setitem(sys.modules, "vers_tpu_torch_probe", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", types.ModuleType("x"))
    assert "vers_tpu" not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vers_tpu.ops", types.ModuleType("x"))
    assert "vers_tpu" in cli.forbidden_modules()
