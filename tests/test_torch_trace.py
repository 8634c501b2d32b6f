"""``vers_tpu_torch.trace``: the port's spans, stage markers and snapshot.

On the CPU: tracing off records nothing and every ``span()`` is one
shared null context; nested spans carry their parent and their call (the
outermost span's id); spans are ``vers/`` ranges of a profiler that
records; the aggregates count every span while the ring of
recent ones stays at ``RING``, and threads that trace at once lose no
update; ``mark`` launches nothing off the card or with tracing off; a
CPU IVF search yields ``ivf.search`` over the stages ``probe``,
``sort``, ``scan``, ``merge`` in that order (one probe rank, two, and
the adaptive depth), with the upload and the download of a host call
beside it and a search with tracing off recording nothing; ``kmeans.step``
counts the Lloyd steps that ran; ``ivf.layout`` and ``layout.padded`` are
recorded once for each layout built; a CPU forest search yields
``lsh.search`` over ``descend``, then ``gather``, the binned stages and
``fold`` a tree, at one probe, four and the default rule. The graph
outcome spans are tested with the stand-in graphs of
``tests/test_torch_graphs.py``.

On the card (``gpu`` marker): a replayed and an eager IVF search with
tracing on leave five markers a call in the profiler's device records,
in stage order, none with tracing off, and the same answers bit for
bit; an HNSW search on the inline route leaves its four (``route``,
``beam``, ``rescore``, ``beam.end``) the same way, and a forest search
its own (``descend``, then ``gather``, the binned search's five and
``fold`` a tree, then ``forest.end``). This file imports neither jax nor
vers_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import contextlib
import re
import sys
import threading

import numpy as np
import pytest
import torch

from vers_tpu_torch import graphs, trace
from vers_tpu_torch.index.ivfflat import IVFFlatIndex
from vers_tpu_torch.ops import _build, kmeans

torch.set_num_threads(2)

STAGES = ["probe", "sort", "scan", "merge"]


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(700, 24)).astype(np.float32)
    return dict(x=x, q=rng.normal(size=(40, 24)).astype(np.float32))


@pytest.fixture(scope="module")
def ivf(data):
    return IVFFlatIndex.build_index(8, 1, 4, data["x"], device="cpu")


def _spans():
    return trace.snapshot()["recent"]


def _counts():
    return {n: v["count"] for n, v in trace.snapshot()["spans"].items()}


def test_off_records_nothing(ivf, data):
    trace.disable()
    trace.reset()
    a, b = trace.span("a"), trace.span("b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert trace.stage("probe", torch.device("cpu")) is a
    with a:
        with b:
            pass
    ivf.search_batch(data["q"], 5, 2)
    ivf.search_batch_device(torch.from_numpy(data["q"]), 5, 0)
    snap = trace.snapshot()
    assert not snap["enabled"] and snap["spans"] == {} and snap["recent"] == []


def test_nesting_gives_parent_and_call(tracing):
    with trace.span("outer"):
        with trace.span("mid"):
            with trace.span("inner"):
                pass
        with trace.span("second"):
            pass
    with trace.span("next"):
        pass
    got = {s.name: s for s in _spans()}
    outer, mid, inner = got["outer"], got["mid"], got["inner"]
    assert outer.parent is None and outer.call == outer.id
    assert mid.parent == outer.id and inner.parent == mid.id
    assert got["second"].parent == outer.id
    assert {s.call for s in (outer, mid, inner, got["second"])} == {outer.id}
    assert got["next"].parent is None and got["next"].call == got["next"].id
    assert got["next"].call != outer.id
    assert outer.start_ns <= mid.start_ns <= inner.start_ns
    assert inner.end_ns <= mid.end_ns <= outer.end_ns
    assert {s.thread for s in got.values()} == {threading.get_ident()}
    # the order of the ring: each span as it closes
    assert [s.name for s in _spans()] == ["inner", "mid", "second", "outer",
                                          "next"]


def test_spans_are_profiler_ranges_while_one_records(tracing):
    from torch.profiler import ProfilerActivity, profile

    with trace.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                pass
    ranges = [e.name for e in prof.events() if e.name.startswith("vers/")]
    assert sorted(ranges) == ["vers/inner", "vers/outer"]
    assert _counts() == {"before": 1, "outer": 1, "inner": 1}


def test_aggregates_count_and_the_ring_stays_bounded(tracing):
    n = trace.RING + 100
    for i in range(n):
        with trace.span("a" if i % 2 else "b"):
            pass
    snap = trace.snapshot()
    assert snap["spans"]["a"]["count"] + snap["spans"]["b"]["count"] == n
    assert snap["spans"]["a"]["count"] == n // 2
    for agg in snap["spans"].values():
        assert 0 <= agg["max_ns"] <= agg["total_ns"]
    recent = snap["recent"]
    assert len(recent) == trace.RING
    ids = [s.id for s in recent]
    assert ids == sorted(ids) and ids[-1] - ids[0] == trace.RING - 1
    trace.reset()
    assert trace.snapshot()["spans"] == {} and trace.snapshot()["recent"] == []


def test_threads_tracing_at_once_lose_no_span(tracing):
    workers, each = 8, 400
    wrong = []

    def work():
        me = threading.get_ident()
        for _ in range(each):
            with trace.span("outer") as outer:
                with trace.span("inner") as inner:
                    if inner.parent != outer.id or inner.call != outer.id:
                        wrong.append(me)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
    assert _counts() == {"outer": workers * each, "inner": workers * each}
    by_id = {s.id: s for s in _spans()}
    for s in by_id.values():
        if s.name == "inner":
            assert by_id[s.parent].thread == s.thread


@pytest.mark.parametrize("on,device", [(True, "cpu"), (False, "cuda")])
def test_mark_launches_nothing_off_the_card_or_off(monkeypatch, on, device):
    def refuse():
        raise AssertionError("a marker was launched")

    monkeypatch.setattr(_build, "load_library", refuse)
    (trace.enable if on else trace.disable)()
    try:
        for stage in trace.STAGES:
            trace.mark(stage, torch.device(device))
    finally:
        trace.disable()


def test_snapshot_carries_the_launch_counters():
    launches = trace.snapshot()["launches"]
    assert set(launches) == {"packed_scan", "packed_scan_split",
                             "rank_merge", "distance_topk", "topk_values",
                             "bucket_scan", "beam_step", "beam_step_plain"}


@pytest.mark.parametrize("nprobe", [1, 2, 0])
def test_cpu_ivf_search_yields_the_stages_in_order(tracing, ivf, data, nprobe):
    want = ivf.search_batch(data["q"], 5, nprobe)
    trace.reset()
    got = ivf.search_batch(data["q"], 5, nprobe)
    np.testing.assert_array_equal(got.ids, want.ids)
    spans = _spans()
    (search,) = [s for s in spans if s.name == "ivf.search"]
    assert search.parent is None
    mine = sorted((s for s in spans if s.call == search.call),
                  key=lambda s: s.start_ns)
    assert [s.name for s in mine if s.name in STAGES] == STAGES
    names = {s.name for s in mine}
    assert {"ivf.upload", "ivf.plan", "graph.eager"} <= names
    assert "ivf.layout" not in names  # built by the first call
    eager = next(s for s in mine if s.name == "graph.eager")
    for s in mine:
        if s.name in STAGES:
            assert s.parent == eager.id
            assert search.start_ns <= s.start_ns <= s.end_ns <= search.end_ns
    (download,) = [s for s in spans if s.name == "ivf.download"]
    assert download.start_ns >= search.end_ns
    # a tensor already on the index's device is not uploaded
    trace.reset()
    ivf.search_batch_device(torch.from_numpy(data["q"]), 5, nprobe)
    assert "ivf.upload" not in _counts() and _counts()["ivf.search"] == 1


@pytest.mark.parametrize("k,iterations,attempts,steps", [
    (1, 10, 2, 2),   # one cluster: the second step repeats the first
    (8, 3, 2, 3),    # stopped by max_iterations
])
def test_kmeans_step_counts_the_lloyd_steps(tracing, data, k, iterations,
                                            attempts, steps):
    IVFFlatIndex.build_index(k, attempts, iterations, data["x"], device="cpu")
    counts = _counts()
    assert counts["kmeans.step"] == attempts * steps
    assert counts["ivf.build"] == 1
    build = next(s for s in _spans() if s.name == "ivf.build")
    assert all(s.call == build.id for s in _spans())
    trace.reset()
    x = torch.from_numpy(data["x"])
    kmeans.build_kmeans(torch.Generator().manual_seed(0), x, len(x), k,
                        iterations)
    assert _counts() == {"kmeans.step": steps}


def test_ivf_layout_is_recorded_once_a_build(tracing, data):
    idx = IVFFlatIndex.build_index(8, 1, 3, data["x"], device="cpu")
    trace.reset()
    idx.search_batch(data["q"], 5, 2)
    parents = {s.id: s.name for s in _spans()}
    # the cluster-major layout, then the padded one under the plan
    (layout,) = [s for s in _spans() if s.name == "ivf.layout"]
    (padded,) = [s for s in _spans() if s.name == "layout.padded"]
    assert parents[layout.parent] == "ivf.search"
    assert parents[padded.parent] == "ivf.plan"
    for _ in range(2):
        idx.search_batch(data["q"], 5, 2)
    counts = _counts()
    assert (counts["ivf.layout"], counts["layout.padded"]) == (1, 1)
    idx.add_batch(data["q"][:3])  # drops the layout
    idx.search_batch(data["q"], 5, 2)
    counts = _counts()
    assert (counts["ivf.layout"], counts["layout.padded"]) == (2, 2)


@pytest.mark.parametrize("probes", [1, 4, None])
def test_cpu_forest_search_yields_the_stages_in_order(tracing, data, probes):
    from vers_tpu_torch import ANNIndex

    forest = ANNIndex.build_index(3, 16, data["x"], np.arange(len(data["x"])),
                                  device="cpu")
    want = forest.search_batch(data["q"], 5, probes)
    trace.reset()
    got = forest.search_batch(data["q"], 5, probes)
    np.testing.assert_array_equal(got.ids, want.ids)
    spans = _spans()
    (search,) = [s for s in spans if s.name == "lsh.search"]
    assert search.parent is None
    mine = sorted((s for s in spans if s.call == search.call),
                  key=lambda s: s.start_ns)
    # the forest's stages, each tree's binned ones between its gather and
    # its fold (the probes are given: no probe stage)
    order = [s.name for s in mine if s.name in STAGES + ["descend", "gather", "fold"]]
    assert order == ["descend"] + ["gather", "sort", "scan", "merge", "fold"] * 3
    assert "lsh.layout" not in {s.name for s in mine}  # built by the first call
    for s in mine:
        assert search.start_ns <= s.start_ns <= s.end_ns <= search.end_ns


def test_forest_build_spans_and_counters(tracing, data):
    from vers_tpu_torch import ANNIndex

    forest = ANNIndex.build_index(3, 16, data["x"], np.arange(len(data["x"])),
                                  device="cpu")
    spans = _spans()
    (build,) = [s for s in spans if s.name == "lsh.build"]
    inner = [s.name for s in sorted(spans, key=lambda s: s.start_ns)
             if s.parent == build.id]
    assert inner == ["lsh.dedup", "lsh.trees", "lsh.tables"]
    view = forest.forest_view()
    levels = sum(int(((t.split >= 0) | (t.bucket >= 0)).any(1).sum())
                 for t in view.trees)
    assert trace.snapshot()["counters"] == dict(
        dict.fromkeys(trace.COUNTERS, 0),
        forest_leaves=sum(len(t.leaf_sizes) for t in view.trees),
        forest_levels=levels)
    forest.search_batch(data["q"], 5, 1)
    forest.search_batch(data["q"], 5, 1)
    assert _counts()["lsh.layout"] == 1  # once a layout
    trace.reset()
    trace.disable()
    ANNIndex.build_index(3, 16, data["x"], np.arange(len(data["x"])),
                         device="cpu").search_batch(data["q"], 5, 1)
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"] == dict.fromkeys(trace.COUNTERS, 0)


# -- on the card ---------------------------------------------------------

MARK = re.compile(r"vers::trace::mark<(\d+)>")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _profiled_marks(search, calls):
    """The outputs of ``calls`` calls of ``search`` and the stage index
    of each marker the profiler's device records hold, in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a kernel ahead of the calls: the profiler can miss the record
        # of the first launch after it starts (an eager HNSW search's
        # first launch is its route marker)
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        outs = [search() for _ in range(calls)]
        torch.cuda.synchronize()
    marks = sorted((e.time_range.start, int(m.group(1)))
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and (m := MARK.search(e.name)))
    return outs, [i for _, i in marks]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["replay", "eager"])
def test_markers_on_the_card(cuda, mode):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(20000, 64)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(500, 64)).astype(np.float32)).to(cuda)
    idx = IVFFlatIndex.build_index(64, 1, 4, x)
    eager = graphs.disabled if mode == "eager" else contextlib.nullcontext

    def search():
        with eager():
            return idx.search_batch_device(q, 10, 2)

    calls = 3
    got = {}
    for on in (False, True, False):
        (trace.enable if on else trace.disable)()
        try:
            search(), search()  # the first call, the capture
            outs, marks = _profiled_marks(search, calls)
        finally:
            trace.disable()
        if on:  # the binned search's five stages
            assert marks == list(range(trace.STAGES.index("end") + 1)) * calls
        else:
            assert marks == []
        got.setdefault(on, outs)
        for d, i in outs:
            assert torch.equal(d, got[on][0][0]) and torch.equal(i, got[on][0][1])
    for (d_on, i_on), (d_off, i_off) in zip(got[True], got[False]):
        assert torch.equal(d_on, d_off) and torch.equal(i_on, i_off)
    if mode == "replay":
        assert len(idx._graphs.sites()) == 2  # one with markers, one without


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["replay", "eager"])
def test_hnsw_markers_on_the_card(cuda, mode):
    import dataclasses

    from vers_tpu_torch import HNSWIndex

    rng = np.random.default_rng(6)
    x = rng.normal(size=(20480, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = torch.from_numpy(x[:512] + 0.1 * rng.normal(size=(512, 64)).astype(
        np.float32)).to(cuda)
    idx = HNSWIndex.build_index_device(4, 40, 32, 8, torch.from_numpy(x).to(cuda))
    # the inline route at this size: the scan router, the inline beam
    # and the f32 rescore, as at 1M rows
    idx.config = dataclasses.replace(idx.config, nav_inline_dp=16, max_degree=12)
    eager = graphs.disabled if mode == "eager" else contextlib.nullcontext

    def search():
        with eager():
            return idx.search_batch_device(q, 10)

    calls = 3
    hnsw = [trace.STAGES.index(s) for s in ("route", "beam", "rescore", "beam.end")]
    got = {}
    for on in (False, True, False):
        (trace.enable if on else trace.disable)()
        try:
            search(), search()  # the first call, the capture
            outs, marks = _profiled_marks(search, calls)
        finally:
            trace.disable()
        assert marks == (hnsw * calls if on else [])
        got.setdefault(on, outs)
        for d, i in outs:
            assert torch.equal(d, got[on][0][0]) and torch.equal(i, got[on][0][1])
    assert idx._ensure_device_cache()["inline"] is not None
    for (d_on, i_on), (d_off, i_off) in zip(got[True], got[False]):
        assert torch.equal(d_on, d_off) and torch.equal(i_on, i_off)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["replay", "eager"])
@pytest.mark.parametrize("probes", [1, None])
def test_forest_markers_on_the_card(cuda, mode, probes):
    from vers_tpu_torch import ANNIndex

    rng = np.random.default_rng(7)
    x = rng.normal(size=(20000, 64)).astype(np.float32)
    q = torch.from_numpy(x[:500] + 0.1 * rng.normal(size=(500, 64)).astype(
        np.float32)).to(cuda)
    forest = ANNIndex.build_index(3, 100, x, np.arange(len(x)), device=cuda)
    eager = graphs.disabled if mode == "eager" else contextlib.nullcontext

    def search():
        with eager():
            return forest.search_batch_device(q, 10, probes)

    calls = 3
    idx = trace.STAGES.index
    tree = [idx("gather")] + list(range(idx("end") + 1))[1:] + [idx("fold")]
    want = ([idx("descend")] + tree * 3 + [idx("forest.end")]) * calls
    got = {}
    for on in (False, True, False):
        (trace.enable if on else trace.disable)()
        try:
            search(), search()  # the first call, the capture
            outs, marks = _profiled_marks(search, calls)
        finally:
            trace.disable()
        assert marks == (want if on else [])
        got.setdefault(on, outs)
        for d, i in outs:
            assert torch.equal(d, got[on][0][0]) and torch.equal(i, got[on][0][1])
    for (d_on, i_on), (d_off, i_off) in zip(got[True], got[False]):
        assert torch.equal(d_on, d_off) and torch.equal(i_on, i_off)
    if mode == "replay":
        assert len(forest._graphs.sites()) == 2  # one with markers, one without
