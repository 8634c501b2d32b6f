"""The interval arithmetic of tools/profile_torch_search.py: device busy
time is the union of the device records, and the idle share is taken
against the profiled window."""

import sys
import types
from pathlib import Path

import pytest
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import profile_torch_search as pts  # noqa: E402


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 5), (1, 3), (4, 8), (10, 12)], 10.0),  # nested, overlapping, apart
    ([(3, 4), (0, 1), (1, 2)], 3.0),             # unsorted, touching
])
def test_busy_us_is_the_union(spans, want):
    assert pts.busy_us(spans) == want


def _ev(name, start, end, device_type):
    return types.SimpleNamespace(name=name, device_type=device_type,
                                 time_range=types.SimpleNamespace(start=start,
                                                                  end=end))


def test_device_profile_idle_share_and_names():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev(pts.WINDOW, 0, 100, cpu),
        _ev(pts.WINDOW, 10, 90, gpu),        # the window's own annotation
        _ev("aten::mm", 5, 15, cpu),         # host records do not count
        _ev("gemm", 10, 30, gpu),
        _ev("sort", 25, 40, gpu),            # overlaps the gemm
        _ev("gemm", 60, 70, gpu),
        _ev("Activity Buffer Request", 0, 100, gpu),
    ]
    r = pts.device_profile(events, reps=2, device_type=gpu)
    assert r["busy_ms"] == pytest.approx(40 / 2 / 1e3)
    assert r["profiled_ms"] == pytest.approx(100 / 2 / 1e3)
    assert r["idle_share"] == pytest.approx(0.6)
    assert [a["name"] for a in r["activities"]] == ["gemm", "sort"]
    assert r["activities"][0]["calls"] == 1.0
