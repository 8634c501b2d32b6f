"""The comparison that decides ``correct`` fails a broken run: the
harness's look for a chip skipped (the CPU), the rest of a run driven
with the answers broken where they are produced, or with the driver's
control in the program's place. The cells come from ``BENCHMARK.json``,
each cell's faults and control from its driver's declaration."""

import json

import pytest

from perfbench.bench.registry import HERE, Registry, driver
from perfbench.tests.conftest import run_tiny

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
DRIVERS = {c: driver(Registry().cell(c).config["index"]) for c in CELLS}
FAULTS = [(c, f) for c in CELLS for f in DRIVERS[c].FAULTS]
CONTROLS = [c for c in CELLS if "control" in DRIVERS[c].SYSTEMS]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny, cell, fault):
    rc, res, err = run_tiny(tiny, cell, fault=fault)
    assert rc == 0 and res["correct"] is False
    assert "FAIL" in err.strip().splitlines()[-1] or "FAIL" in err


@pytest.mark.parametrize("cell", CONTROLS)
def test_control_is_not_correct(tiny, cell):
    rc, res, _ = run_tiny(tiny, cell, system="control")
    assert rc == 0 and res["correct"] is False


def test_sound_run_is_correct(tiny):
    rc, res, _ = run_tiny(tiny, "sift128-ivf-bulk", seed=12345)
    assert rc == 0 and res["correct"] is True
