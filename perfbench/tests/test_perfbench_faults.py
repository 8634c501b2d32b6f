"""The comparison that decides ``correct`` fails a broken run: the
harness's look for a chip skipped (the CPU), the rest of a run driven
with the answers broken where they are produced, or with the plain
reference at TF32 (the control) in the program's place."""

import pytest

from perfbench.drivers.ivfflat import FAULTS
from perfbench.tests.conftest import run_tiny

CELLS = ("wiki300-ivf-bulk", "wiki300-ivf-small", "wiki300-ivf-adaptive")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault):
    rc, res, err = run_tiny(tiny, cell, fault=fault)
    assert rc == 0 and res["correct"] is False
    assert "FAIL" in err.strip().splitlines()[-1] or "FAIL" in err


@pytest.mark.parametrize("cell", CELLS + ("sift128-ivf-bulk",))
def test_control_is_not_correct(tiny, cell):
    rc, res, _ = run_tiny(tiny, cell, system="control")
    assert rc == 0 and res["correct"] is False


def test_sound_run_is_correct(tiny):
    rc, res, _ = run_tiny(tiny, "sift128-ivf-bulk", seed=12345)
    assert rc == 0 and res["correct"] is True
