"""The same runs on a CUDA card (the ``gpu`` marker; skips without one):
a tiny cell through the kernels and CUDA graphs, traced, and the control
and a fault failing there. Run on the card with
``python3 -m pytest perfbench/tests -q -m gpu``."""

import pytest
import torch

from perfbench.bench.cli import main


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_on_the_card(tiny, trace):
    _card()
    import io
    import json
    import time

    out, err = io.StringIO(), io.StringIO()
    rc = main(["--workload", "wiki300-ivf-bulk", "--seed", "77", "--seconds", "2",
               "--trace", str(trace)], time.perf_counter(), registry=tiny,
              out=out, err=err)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]


@pytest.mark.gpu
@pytest.mark.parametrize("system,fault", [("control", None), ("program", "altered"),
                                          ("program", "no_lloyd")])
def test_broken_on_the_card(tiny, system, fault):
    _card()
    import io
    import json
    import time

    out = io.StringIO()
    rc = main(["--workload", "wiki300-ivf-bulk", "--seed", "78", "--seconds", "1"],
              time.perf_counter(), registry=tiny, system=system, fault=fault,
              out=out, err=io.StringIO())
    assert rc == 0 and json.loads(out.getvalue().strip().splitlines()[-1])["correct"] is False
