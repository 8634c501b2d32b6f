"""The yardstick's arithmetic on hand-worked cases: interval unions,
idle gaps, the roofline bound, percentiles and the metric readers."""

import pytest

from perfbench.bench.record import Run
from perfbench.bench.trace import Trace
from perfbench.bench.traffic import Window, latencies, percentile, served_in_window
from perfbench.bench.registry import metric_reader
from perfbench.reference.intervals import busy_us, gaps, label_gaps, union
from perfbench.reference.peaks import HBM, TF32, packed_scan_bound


def test_busy_union():
    assert busy_us([]) == 0.0
    assert busy_us([(0, 2), (1, 3), (5, 6)]) == 4.0      # overlap counts once
    assert busy_us([(0, 10), (2, 3), (4, 5)]) == 10.0    # nested
    assert busy_us([(5, 6), (0, 1), (1, 2)]) == 3.0      # touching, unsorted
    assert union([(3, 4), (0, 2), (1, 2.5)]) == [(0, 2.5), (3, 4)]


def test_gaps_and_labels():
    idle = gaps([(1, 2), (4, 6)], 0, 10)
    assert idle == [(0, 1), (2, 4), (6, 10)]
    assert gaps([(0, 10)], 2, 8) == []
    host = [("enqueue", 0, 3), ("drain", 2.5, 3.5), ("drain", 5, 20)]
    assert label_gaps(idle, host) == [("enqueue", 1), ("drain", 2), ("drain", 4)]
    assert label_gaps([(30, 31)], host) == [("other", 1)]


def test_packed_scan_bound_hand_worked():
    # 1000 pairs at d 100: 6e5 TF32 flop; bytes 4*10*100 + 408*50 + 8*10*5
    b = packed_scan_bound(live_rows=10, out_rows=10, scanned=1000,
                          probed_rows=50, d=100, k=5)
    assert b["ops"] == 6 * 1000 * 100
    assert b["bytes"] == 4000 + 408 * 50 + 400
    assert b["bound_ms"] == pytest.approx(max(6e5 / TF32, 24800 / HBM) * 1e3)
    assert b["bound_by"] == "bytes"
    # the IVF path's own size (PERF.md: 0.373 ms, bytes)
    big = packed_scan_bound(32768, 32768, 32768 * 488, 999_994, 300, 10)
    assert big["bound_by"] == "bytes"
    assert big["bound_ms"] == pytest.approx(0.37, abs=0.01)


def test_percentile():
    assert percentile([], 0.95) is None
    assert percentile([3.0], 0.95) == 3.0
    assert percentile(list(range(101)), 0.95) == pytest.approx(95.0)
    assert percentile([0.0, 10.0], 0.95) == pytest.approx(9.5)


def _run():
    win = Window(start=0.0, end=2.0)
    win.calls = [(0, 0.0, 0.5), (1, 0.5, 1.0), (2, 1.0, 1.9), (3, 1.9, 2.4), (4, 2.1, 2.6)]
    trace = Trace(device=[("packed_scan_kernel<true>", 0.0, 0.5),
                          ("plan_cost_kernel", 0.5, 0.6),
                          ("radixSort", 0.6, 0.8),
                          ("memcpy", 1.2, 1.4)],
                  host=[("enqueue", 0.0, 0.1), ("drain", 0.1, 2.0)],
                  window=(0.0, 2.0), calls=[0, 1])
    work = [dict(live_rows=10, out_rows=10, scanned=1000, probed_rows=50, d=100, k=5)]
    return Run(batch=100, window=win, setup_s=12.5, build_s=4.0, build_index_s=3.0,
               enqueue_s=[1e-4, 3e-4, 2e-4], judged={"recall_at_10": 0.98},
               trace=trace, work=work, pool_batches=1)


def test_readers_hand_worked():
    run = _run()
    assert served_in_window(run.window, 100) == 300        # done by 2.0
    assert latencies(run.window) == pytest.approx([0.5, 0.5, 0.9, 0.5])
    read = {n: metric_reader(n).read(run) for n in (
        "qps", "latency_p95_ms", "recall_at_10", "build_s", "setup_s", "enqueue_us",
        "binned_device_ms", "copy_device_ms", "kernel_b_roofline", "device_idle_share",
        "build_index_s")}
    assert read["qps"] == pytest.approx(150.0)
    assert read["latency_p95_ms"] == pytest.approx(840.0)
    assert read["recall_at_10"] == 0.98
    assert (read["build_s"], read["setup_s"], read["build_index_s"]) == (4.0, 12.5, 3.0)
    assert read["enqueue_us"] == pytest.approx(200.0)
    # busy 1.0 s of 2.0; kernel B 0.6 s; two calls
    assert read["device_idle_share"] == pytest.approx(50.0)
    # busy less kernel B less the copy: the sort alone
    assert read["binned_device_ms"] == pytest.approx((1.0 - 0.6 - 0.2) / 2 * 1e3)
    assert read["copy_device_ms"] == pytest.approx(0.2 / 2 * 1e3)
    least = 2 * packed_scan_bound(**run.work[0])["bound_ms"] * 1e-3
    assert read["kernel_b_roofline"] == pytest.approx(100 * least / 0.6)
    # the online cells' names read as the metrics they are named from
    for n in ("qps", "latency_p95_ms", "enqueue_us", "binned_device_ms",
              "copy_device_ms", "device_idle_share"):
        assert metric_reader(n + ".online").read(run) == read[n]


def test_readers_find_nothing():
    run = _run()
    run.trace, run.work, run.enqueue_s, run.judged = None, None, [], {}
    for n in ("enqueue_us", "binned_device_ms", "copy_device_ms", "kernel_b_roofline",
              "device_idle_share", "recall_at_10", "enqueue_us.online",
              "binned_device_ms.online", "copy_device_ms.online",
              "device_idle_share.online"):
        assert metric_reader(n).read(run) is None
    run = _run()
    run.trace.device = [("radixSort", 0.0, 0.5)]   # no kernel B, no copy: silent, not 0
    assert metric_reader("kernel_b_roofline").read(run) is None
    assert metric_reader("copy_device_ms").read(run) is None


def test_breakdown_lists():
    b = _run().trace.breakdown()
    assert b["device_ops"][0] == ["packed_scan_kernel<true>", 0.5]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0] == ["drain", pytest.approx(0.6)]
