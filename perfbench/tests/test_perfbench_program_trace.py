"""The readers of the program's own trace (``bench/stages.py`` and
``metrics/{probe,sort,scan,merge}_device_ms``, ``search_host_us``,
``program_idle_ms``, ``graph_replay_share``, ``layout_build_s``) on
hand-made traces, and each silent (None, so the line leaves it out)
where the program left no stage marker or ``vers/`` span: a program
without the trace, or with it off."""

import re

import pytest

from perfbench.bench import stages
from perfbench.bench.record import Run
from perfbench.bench.registry import metric_reader, read_metrics
from perfbench.bench.trace import Trace
from perfbench.bench.traffic import Window

STAGE_READERS = ("probe_device_ms", "sort_device_ms", "scan_device_ms",
                 "merge_device_ms")
SLICE_READERS = STAGE_READERS + ("search_host_us", "program_idle_ms",
                                 "graph_replay_share")
READERS = SLICE_READERS + ("layout_build_s",)


def _mark(i, t):
    return (f"void vers::trace::mark<{i}>()", t, t + 0.001)


def _call(t0, outcome, search):
    """One call from ``t0``: five markers around the four stages (the
    scan as two overlapping kernels), then a result copy; its host
    spans; ``search``: its ``vers/ivf.search`` span, relative to t0."""
    device = [_mark(0, t0), ("gemm", t0 + 0.001, t0 + 0.3),
              _mark(1, t0 + 0.3), ("radixSort", t0 + 0.301, t0 + 0.4),
              _mark(2, t0 + 0.4), ("packed_scan_kernel<true>", t0 + 0.401, t0 + 0.9),
              ("plan_cost_kernel", t0 + 0.401, t0 + 0.45),
              _mark(3, t0 + 0.9), ("reduce_kernel", t0 + 0.901, t0 + 1.0),
              _mark(4, t0 + 1.0), ("Memcpy DtoH", t0 + 1.001, t0 + 1.1)]
    host = [("enqueue", t0, t0 + 0.05),
            ("vers/ivf.search", t0 + search[0], t0 + search[1]),
            ("vers/" + outcome, t0 + 0.01, t0 + 0.03),
            ("drain", t0 + 0.05, t0 + 1.1)]
    return device, host


def _run(device, host, calls=(0, 1), window=(0.0, 2.4)):
    trace = Trace(device=device, host=host, window=window, calls=list(calls))
    return Run(batch=100, window=Window(start=0.0, end=2.4), setup_s=1.0,
               trace=trace)


def _traced():
    d0, h0 = _call(0.0, "graph.replay", (0.0, 0.04))
    # the second call's search span covers the idle stretch 1.1-1.2
    d1, h1 = _call(1.2, "graph.eager", (-0.05, 0.05))
    return _run(d0 + d1, h0 + h1)


def test_stages_hand_worked():
    run = _traced()
    read = {n: metric_reader(n).read(run) for n in SLICE_READERS}
    # each stage: the records between its marker's end and the next
    # marker's start, markers and the copy after "end" left out
    assert read["probe_device_ms"] == pytest.approx(299.0)
    assert read["sort_device_ms"] == pytest.approx(99.0)
    assert read["scan_device_ms"] == pytest.approx(499.0)  # overlap counts once
    assert read["merge_device_ms"] == pytest.approx(99.0)
    assert read["search_host_us"] == pytest.approx(70_000.0)  # 40 and 100 ms
    # idle 1.1-1.2 (under vers/ivf.search) counts; 2.3-2.4 (under drain) not
    assert read["program_idle_ms"] == pytest.approx(50.0)
    assert read["graph_replay_share"] == pytest.approx(0.5)
    # the four stages add up to the busy time less markers and copies
    t = run.trace
    rest = (t.busy_s() - t.busy_s(("vers::trace::mark", "Memcpy"))) / 2 * 1e3
    assert sum(read[n] for n in STAGE_READERS) == pytest.approx(rest)


def test_stages_inside_the_slice_only():
    run = _traced()
    run.trace.window = (0.0, 1.15)  # the second call's markers lie outside
    assert metric_reader("scan_device_ms").read(run) == pytest.approx(499.0 / 2)


def test_markers_in_stage_order():
    got = stages.markers(_traced().trace)
    assert [i for i, _, _ in got] == [0, 1, 2, 3, 4] * 2
    assert [s for _, s, _ in got] == sorted(s for _, s, _ in got)


def test_silent_without_the_programs_trace():
    # the parent's program: the benchmark's own spans and kernels, no
    # marker and no vers/ span
    run = _run([("packed_scan_kernel<true>", 0.0, 0.5), ("radixSort", 0.6, 0.8)],
               [("enqueue", 0.0, 0.1), ("drain", 0.1, 2.0)])
    for n in SLICE_READERS:
        assert metric_reader(n).read(run) is None, n
    entries = [{"name": n, "unit": metric_reader(n).UNIT} for n in SLICE_READERS]
    assert read_metrics(entries, run) == {}
    run.trace = None
    for n in SLICE_READERS:
        assert metric_reader(n).read(run) is None, n
    # markers but no calls in the slice
    run = _traced()
    run.trace.calls = []
    for n in STAGE_READERS + ("program_idle_ms",):
        assert metric_reader(n).read(run) is None, n


def test_layout_build_s():
    seconds = metric_reader("layout_build_s").seconds
    assert seconds({}) is None
    assert seconds({"graph.replay": dict(count=3, total_ns=9, max_ns=3)}) is None
    assert seconds({"ivf.layout": dict(count=1, total_ns=1_500_000_000, max_ns=0),
                    "layout.padded": dict(count=1, total_ns=250_000_000, max_ns=0)}
                   ) == pytest.approx(1.75)


def test_layout_build_s_reads_the_program():
    """Off, the program's trace holds no layout and the reader is silent;
    on, a build and a search on the CPU give a positive total."""
    import numpy as np

    from vers_tpu_torch import IVFFlatIndex, trace

    read = metric_reader("layout_build_s").read
    run = _traced()
    trace.disable()
    trace.reset()
    x = np.random.default_rng(0).standard_normal((512, 8)).astype(np.float32)
    idx = IVFFlatIndex.build_index(4, 1, 2, x, device="cpu")
    idx.search_batch(x[:8], 3, 2)
    assert read(run) is None
    trace.enable()
    try:
        idx = IVFFlatIndex.build_index(4, 1, 2, x, device="cpu")
        idx.search_batch(x[:8], 3, 2)
        spans = trace.snapshot()["spans"]
        assert spans["ivf.layout"]["count"] == spans["layout.padded"]["count"] == 1
        assert read(run) == pytest.approx(
            (spans["ivf.layout"]["total_ns"] + spans["layout.padded"]["total_ns"]) * 1e-9)
        assert read(run) > 0
    finally:
        trace.disable()
        trace.reset()


@pytest.mark.parametrize("name", READERS)
def test_readers_declare_the_schemas_fields(name):
    import json

    from perfbench.bench.registry import HERE

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    mod = metric_reader(name)
    assert mod.SOURCE in ("device_trace", "host_clock")
    assert mod.BETTER in ("lower", "higher")
    assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", mod.UNIT)
    assert mod.MOVES in [e["name"] for e in bench["end_to_end"]]
    assert 1 <= len(mod.LAYER) <= 200 and "\n" not in mod.LAYER
