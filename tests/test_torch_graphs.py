"""``vers_tpu_torch.graphs`` (the search paths' CUDA graphs) on the CPU.

- ``ops/binned.bin_counts``, the fixed-size count that replaced
  ``torch.bincount`` in ``_fused_core``, equals ``bincount(...)[:bins]``
  on bins with sentinels and empty bins;
- with a stand-in for ``torch.cuda.CUDAGraph`` injected into ``graphs``
  (capture records every aten op with its tensors; a replay runs them
  again in order, writing each result into the tensor the capture
  returned, which is what a CUDA graph does to its pool; a key's first
  call runs eagerly, its second answers with its warm-up and captures,
  later calls replay): keys separate Q, ``top_k``, nprobe and the state
  version; IVF's adaptive nprobe=0 never captures; ``add`` on an IVF, a
  forest and an HNSW index drops their graphs; the bound on sites holds,
  a busy site is not dropped for a new one, and shapes that never
  repeat never capture; the device and host searches of the forest and
  HNSW share one site; chained calls return unaliased outputs; two
  threads calling one cache at once each get their own answers;
  ``disabled()`` bypasses the cache; a capture that raises is not
  swallowed; replays count the launches their capture recorded; the
  beam's replayed chunks equal the eager loop; replayed searches equal
  eager ones, bit for bit;
- with ``trace`` on, each call is one outcome span (``graph.eager``,
  ``graph.capture`` or ``graph.replay``, the last around ``graph.load``
  and ``graph.take``); a replayed IVF search records no stage span (its
  stages run as the graph's markers on a card); a site captured with
  tracing off is not replayed with it on, nor the reverse;
- a CPU index never captures.

The card's own graphs are held to the eager searches by
``tests/test_torch_cuda.py`` (``gpu`` marker) and ``chip_smoke.py``."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from vers_tpu_torch import core, graphs, trace
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.index.ivfflat import IVFFlatIndex
from vers_tpu_torch.index.lsh import ANNIndex
from vers_tpu_torch.ops import beam
from vers_tpu_torch.ops.binned import bin_counts

torch.set_num_threads(2)


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if StandInGraph.fail:  # as an op the card refuses to capture
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class StandInGraph:
    """A CUDA graph's semantics on CPU tensors (see the module
    docstring); with ``fail`` set, a captured op raises."""

    made = []
    fail = False

    def __init__(self):
        self.ops = None
        self.replays = 0
        self.ended = False
        StandInGraph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self._rec = _Recorder()
        self._rec.__enter__()

    def capture_end(self):
        self._rec.__exit__(None, None, None)
        self.ops = self._rec.ops
        self.ended = True

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            for o, n in zip(tree_leaves(out), tree_leaves(new)):
                if (isinstance(o, torch.Tensor) and o.numel()
                        and o.data_ptr() != n.data_ptr()):
                    o.copy_(n)


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on CPU tensors: the stand-in graph, pool handles, and
    ``capturable`` true outside ``disabled()``."""
    StandInGraph.made = []
    StandInGraph.fail = False
    pools = iter(range(1, 1 << 30))
    monkeypatch.setattr(graphs, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(graphs, "pool_handle", lambda: (0, next(pools)))
    monkeypatch.setattr(graphs, "capturable", lambda t: graphs.enabled())
    return StandInGraph


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    return dict(x=_normed(rng, 600, 32), q=_normed(rng, 24, 32),
                extra=_normed(rng, 2, 32))


def _eager(fn):
    with graphs.disabled():
        return fn()


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _admitted(cache, key, x, state):
    """The site of ``key`` on ``x``, asked for twice: a configuration's
    first call runs eagerly (no site)."""
    assert cache.site(key, x, state) is None
    return cache.site(key, x, state)


# -- the fixed-size count -----------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_counts_equal_bincount(seed):
    rng = np.random.default_rng(seed)
    num_bins = 37
    # every third bin empty; a quarter of the entries the sentinel
    live = rng.choice(np.arange(0, num_bins, 3) + 1, size=300) % num_bins
    bins = np.where(rng.random(300) < 0.25, num_bins, live)
    t = torch.from_numpy(bins.astype(np.int64))
    want = torch.bincount(t, minlength=num_bins + 1)[:num_bins]
    got = bin_counts(t, num_bins)
    assert got.dtype == torch.int64 and got.shape == (num_bins,)
    assert torch.equal(got, want)
    assert (got == 0).any() and int(got.sum()) < len(bins)


# -- the cache's mechanics on a toy function ----------------------------


def _toy(x, y):
    return (x * 2 + y, (x - y).sum(dim=1))


def test_chained_calls_return_unaliased_outputs(stand_in):
    cache = graphs.GraphCache()
    state = {}
    a, b = torch.arange(12.0).reshape(3, 4), torch.ones(3, 4)
    c = torch.full((3, 4), 5.0)
    assert cache.site(("toy",), a, state) is None  # the first call: eager
    first = graphs.run(cache.site(("toy",), a, state), "f", _toy, a, b)
    kept = [t.clone() for t in first]
    second = graphs.run(cache.site(("toy",), c, state), "f", _toy, c, b)
    third = graphs.run(cache.site(("toy",), a, state), "f", _toy, a, c)
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 2
    _assert_same(first, kept)  # the later calls wrote elsewhere
    _assert_same(first, _toy(a, b))
    _assert_same(second, _toy(c, b))
    _assert_same(third, _toy(a, c))
    g = cache.sites()[0].graphs[("f", ((((3, 4), torch.float32),) * 2))]
    outs = (first, second, third)
    for out in outs:
        for t, static in zip(out, (*g.outputs, *g.inputs)):
            assert t.data_ptr() != static.data_ptr()
    assert len({out[0].data_ptr() for out in outs}) == 3


def test_a_first_result_aliasing_an_input_is_copied(stand_in):
    """A function that returns (a view of) its input: the first call's
    answer must not be the graph's static input buffer."""
    site = _admitted(graphs.GraphCache(), ("id",), torch.ones(3), {})
    x = torch.arange(3.0)
    first = graphs.run(site, "f", lambda t: (t[1:], t * 2), x)
    graphs.run(site, "f", lambda t: (t[1:], t * 2), torch.zeros(3))
    assert torch.equal(first[0], torch.tensor([1.0, 2.0]))


def test_lru_bound_and_keys(stand_in, monkeypatch):
    # room for the first loop's calls
    monkeypatch.setattr(graphs, "IDLE_CALLS", 2 * (graphs.MAX_SITES + 2))
    cache = graphs.GraphCache()
    state = {}
    x = torch.ones(2, 3)

    def call(k, t=x):
        site = cache.site(("toy", k), t, state)
        graphs.run(site, "f", _toy, t, t)
        return site

    # each key's second call captures, while there is room; with every
    # site busy, the keys past the bound run eagerly
    for k in range(graphs.MAX_SITES + 2):
        assert call(k) is None
        assert (call(k) is None) == (k >= graphs.MAX_SITES)
    keys = [s.key[0] for s in cache.sites()]
    assert keys == [("toy", k) for k in range(graphs.MAX_SITES)]
    assert len(stand_in.made) == graphs.MAX_SITES
    # once the least recently used site has had no call in IDLE_CALLS
    # calls, a new key takes its place; the busy ones stay
    for _ in range(graphs.IDLE_CALLS):
        assert call(1) is not None
    assert call(99) is None and call(99) is not None
    keys = [s.key[0] for s in cache.sites()]
    assert ("toy", 0) not in keys and keys[-2:] == [("toy", 1), ("toy", 99)]
    assert len(keys) == graphs.MAX_SITES
    # another shape, another site; another state drops every site
    monkeypatch.setattr(graphs, "IDLE_CALLS", 0)
    made = len(stand_in.made)
    five = torch.ones(5, 3)
    assert call(99, five) is None and call(99, five) is not None
    assert len(stand_in.made) == made + 1
    version = cache.version
    assert cache.site(("toy", 99), x, {}) is None
    assert cache.version == version + 1 and not cache.sites()


def test_shapes_that_never_repeat_never_capture(stand_in, monkeypatch):
    """Each configuration is remembered as called once (the last
    SEEN_KEYS); a call past that window runs eagerly again."""
    monkeypatch.setattr(graphs, "SEEN_KEYS", 3)
    cache = graphs.GraphCache()
    state = {}
    for n in range(1, 40):  # a new batch shape at every call
        assert cache.site(("toy",), torch.ones(n, 3), state) is None
    for n in (1, 2, 3, 4):  # forgotten: three newer shapes came since
        assert cache.site(("toy",), torch.ones(n, 3), state) is None
    # 2 came again among the last three shapes
    assert cache.site(("toy",), torch.ones(2, 3), state) is not None
    assert not stand_in.made


def test_two_threads_on_one_cache_get_their_own_answers(stand_in):
    """Two threads replay one graph at once, each with its own inputs:
    the load, the replay and the take of one call are not interleaved
    with the other thread's (``GraphCache.held``)."""
    cache = graphs.GraphCache()
    state = {}
    shape = torch.ones(64, 8)
    for _ in range(2):  # the first call, the capture
        graphs.run(cache.site(("toy",), shape, state), "f", _toy, shape, shape)
    wrong = []

    def worker(seed):
        gen = torch.Generator().manual_seed(seed)
        for _ in range(300):
            a = torch.randn(64, 8, generator=gen)
            b = torch.randn(64, 8, generator=gen)
            site = cache.site(("toy",), a, state)
            got = graphs.run(site, "f", _toy, a, b)
            if not all(torch.equal(g, w) for g, w in zip(got, _toy(a, b))):
                wrong.append(seed)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not wrong
    assert stand_in.made[0].replays == 600


def test_disabled_bypasses_the_cache(stand_in):
    cache = graphs.GraphCache()
    x = torch.ones(2, 3)
    with graphs.disabled():
        assert cache.site(("toy",), x, {}) is None
        out = graphs.run(None, "f", _toy, x, x)
    _assert_same(out, _toy(x, x))
    assert not stand_in.made and not cache.sites()
    assert graphs.enabled()


def test_a_failed_capture_raises(stand_in):
    cache = graphs.GraphCache()
    x = torch.ones(2, 3)
    stand_in.fail = True
    site = _admitted(cache, ("toy",), x, {})
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.run(site, "f", _toy, x, x)
    assert stand_in.made[0].ended  # the capture was closed
    assert not site.graphs
    assert getattr(core.CAPTURE, "tally", None) is None
    stand_in.fail = False
    calls = []

    def broken(x, y):  # the warm-up passes, the capture raises
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("the body's own error")
        return (x + y,)

    with pytest.raises(ValueError, match="own error"):
        graphs.run(site, "g", broken, x, x)
    assert stand_in.made[-1].ended and not site.graphs


def test_replays_count_the_recorded_launches(stand_in):
    counters = {}

    def launching(x):
        core.count(counters, "LAUNCHES")
        core.count(counters, "BY_TWO", 2)
        return (x + 1,)

    cache = graphs.GraphCache()
    x = torch.zeros(4)
    site = _admitted(cache, ("count",), x, {})
    graphs.run(site, "f", launching, x)
    # the warm-up ran (its launches count); the capture ran nothing
    assert counters == {"LAUNCHES": 1, "BY_TWO": 2}
    for _ in range(3):
        graphs.run(site, "f", launching, x)
    assert counters == {"LAUNCHES": 4, "BY_TWO": 8}
    assert stand_in.made[0].replays == 3
    g = next(iter(site.graphs.values()))
    assert sorted((k, n) for _, k, n in g.launches) == [("BY_TWO", 2),
                                                        ("LAUNCHES", 1)]
    assert getattr(core.CAPTURE, "tally", None) is None


@pytest.mark.parametrize("max_steps, sync_every", [(10, 4), (8, 4), (7, 0),
                                                   (9, 1)])
def test_replayed_beam_chunks_equal_the_eager_loop(stand_in, max_steps,
                                                   sync_every):
    """A toy state that converges at step 6: the replayed chunks (with a
    remainder chunk where max_steps is not a multiple) give run_beam's
    state, and the host reads the flag where run_beam does."""
    def make_step(limit):
        def step(state):
            (t,) = state
            t = torch.minimum(t + 1, limit)
            return (t,), (t < limit).any()
        return step

    limit = torch.tensor([3, 6, 1])
    start = (torch.zeros(3, dtype=torch.int64),)
    want = beam.run_beam(start, make_step(limit), max_steps, sync_every)
    site = _admitted(graphs.GraphCache(), ("beam",), limit, {})
    got = beam.replay_beam(site, "b", start, make_step, (limit,), max_steps,
                           sync_every)
    _assert_same(got, want)
    assert torch.equal(start[0], torch.zeros(3, dtype=torch.int64))
    # the chunks run_beam's reads allow: the flag is down after step 6
    chunk, done, want_names = sync_every or max_steps, 0, set()
    while done < max_steps:
        n = min(chunk, max_steps - done)
        want_names.add(("b", n))
        done += n
        if sync_every and done < max_steps and done >= 6:
            break
    assert {name for name, _ in site.graphs} == want_names


# -- the indexes ---------------------------------------------------------


def _ivf(data):
    return IVFFlatIndex.build_index(8, 1, 5, data["x"], device="cpu")


def _forest(data):
    return ANNIndex.build_index(3, 40, data["x"], np.arange(len(data["x"])),
                                device="cpu")


def _hnsw(data, **config):
    idx = HNSWIndex.build_index_batched(3, 32, 16, 6, data["x"], wave_cap=128,
                                        device="cpu")
    idx.config = dataclasses.replace(idx.config, **config)
    return idx


def test_a_cpu_index_never_captures(data, monkeypatch):
    StandInGraph.made = []
    monkeypatch.setattr(graphs, "CUDAGraph", StandInGraph)
    q = torch.from_numpy(data["q"])
    for idx, search in ((_ivf(data), lambda i: i.search_batch_device(q, 5, 2)),
                        (_forest(data), lambda i: i.search_batch_device(q, 5)),
                        (_hnsw(data), lambda i: i.search_batch_device(q, 5))):
        search(idx)
        assert not idx._graphs.sites()
    assert not StandInGraph.made


def test_ivf_keys_separate_q_top_k_nprobe_and_version(stand_in, data):
    idx = _ivf(data)
    q = torch.from_numpy(data["q"])

    def made():
        return len(stand_in.made)

    for call in ((q, 5, 2), (q[:16], 5, 2), (q, 3, 2), (q, 5, 1), (q, 5, 0)):
        before = made()
        want = _eager(lambda: idx.search_batch_device(*call))
        for _ in range(3):  # the first call, the capturing one, a replay
            _assert_same(idx.search_batch_device(*call), want)
        if call[2] == 0:  # the adaptive depth runs eagerly
            assert made() == before, call
            continue
        assert made() == before + 1, call
        assert stand_in.made[-1].replays == 1
    assert len(idx._graphs.sites()) == 4
    # the state version: an add drops every graph, the second call after
    # it captures
    version = idx._graphs.version
    idx.add(data["extra"][0], 0)
    assert not idx._graphs.sites() and idx._graphs.version > version
    before = made()
    want = _eager(lambda: idx.search_batch_device(q, 5, 2))
    for _ in range(3):
        _assert_same(idx.search_batch_device(q, 5, 2), want)
    assert made() == before + 1 and stand_in.made[-1].replays == 1


@pytest.mark.parametrize("kind", ["ivf", "forest", "hnsw", "hnsw_inline",
                                  "hnsw_beam"])
def test_add_drops_the_graphs_and_replays_equal_eager(stand_in, data, kind):
    if kind == "ivf":
        idx = _ivf(data)
    elif kind == "forest":
        idx = _forest(data)
    elif kind == "hnsw":
        idx = _hnsw(data)
    elif kind == "hnsw_inline":
        idx = _hnsw(data, nav_inline_dp=16)
    else:
        idx = _hnsw(data, route_mode="beam")
    q = torch.from_numpy(data["q"])
    # IVF at a fixed nprobe: its default, the adaptive depth, runs eagerly
    more = (2,) if kind == "ivf" else ()
    if kind == "hnsw_inline":
        idx.search_batch_device(q, 5, *more)
        assert idx._device_cache["inline"] is not None
    for _ in range(3):  # the first call, the capturing one, a replay
        got = idx.search_batch_device(q, 5, *more)
        _assert_same(got, _eager(lambda: idx.search_batch_device(q, 5, *more)))
    assert idx._graphs.sites()
    made = len(stand_in.made)
    assert all(g.replays for g in stand_in.made)
    n = len(data["x"])
    idx.add(data["extra"][1], n)
    assert not idx._graphs.sites()
    for _ in range(3):
        got = idx.search_batch_device(q, 5, *more)
        _assert_same(got, _eager(lambda: idx.search_batch_device(q, 5, *more)))
    assert len(stand_in.made) > made and stand_in.made[-1].replays
    one = data["extra"][1:2]
    for _ in range(3):
        got = idx.search_batch_device(one, 1, *more)
    _assert_same(got, _eager(lambda: idx.search_batch_device(one, 1, *more)))
    assert int(got[1][0, 0]) == n


@pytest.mark.parametrize("kind", ["forest", "hnsw"])
def test_device_and_host_searches_share_a_site(stand_in, data, kind):
    """``search_batch`` (rows, ids mapped on the host) and
    ``search_batch_device`` (ids mapped on the card) replay one
    configuration's graphs: the id map is a graph of its own there."""
    idx = _forest(data) if kind == "forest" else _hnsw(data)
    q = torch.from_numpy(data["q"])
    want = _eager(lambda: idx.search_batch(q, 5))
    want_dev = _eager(lambda: idx.search_batch_device(q, 5))
    for _ in range(3):
        got = idx.search_batch(q, 5)
        got_dev = idx.search_batch_device(q, 5)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.distances, want.distances)
    _assert_same(got_dev, want_dev)
    (site,) = idx._graphs.sites()
    assert "ids" in {name for name, _ in site.graphs}


# -- the trace's graph outcomes -----------------------------------------


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def _call_spans(call):
    """Names of the spans of the outermost span ``call`` (a name), by
    parent name."""
    spans = trace.snapshot()["recent"]
    (top,) = [s for s in spans if s.name == call]
    names = {s.id: s.name for s in spans}
    return {(names.get(s.parent), s.name) for s in spans
            if s.call == top.call and s is not top}


def test_each_call_is_one_outcome_span(stand_in, tracing):
    cache = graphs.GraphCache()
    x, y = torch.ones(3, 4), torch.arange(12.0).reshape(3, 4)
    state = {}
    outcomes = []
    for _ in range(4):  # the first call, the capture, two replays
        trace.reset()
        with trace.span("call"):
            graphs.run(cache.site(("toy",), x, state), "f", _toy, x, y)
        outcomes.append(_call_spans("call"))
    assert outcomes[0] == {("call", "graph.eager")}
    assert outcomes[1] == {("call", "graph.capture")}
    assert outcomes[2] == outcomes[3] == {
        ("call", "graph.replay"), ("graph.replay", "graph.load"),
        ("graph.replay", "graph.take")}
    assert stand_in.made[0].replays == 2


def test_a_replayed_ivf_search_records_no_stage_span(stand_in, tracing, data):
    idx = _ivf(data)
    q = torch.from_numpy(data["q"])
    want = _eager(lambda: idx.search_batch_device(q, 5, 2))
    stages = {"probe", "sort", "scan", "merge"}
    seen = []
    for _ in range(3):
        trace.reset()
        _assert_same(idx.search_batch_device(q, 5, 2), want)
        seen.append(_call_spans("ivf.search"))
    assert {(p, n) for p, n in seen[0] if n in stages} == {
        ("graph.eager", n) for n in stages}
    # the warm-up and the capture both run the stages
    assert {(p, n) for p, n in seen[1] if n in stages} == {
        ("graph.capture", n) for n in stages}
    assert not {n for _, n in seen[2]} & stages
    assert ("ivf.search", "graph.replay") in seen[2]


@pytest.mark.parametrize("first_on", [False, True])
def test_tracing_is_part_of_a_sites_key(stand_in, first_on):
    """A graph captured with tracing off holds no stage markers, and one
    captured with it on holds them: neither replays in the other state."""
    cache = graphs.GraphCache()
    x = torch.ones(2, 3)
    state = {}

    def call():
        return graphs.run(cache.site(("toy",), x, state), "f", _toy, x, x)

    try:
        for on in (first_on, not first_on, first_on):
            (trace.enable if on else trace.disable)()
            for _ in range(3):
                _assert_same(call(), _toy(x, x))
        assert [g.replays for g in stand_in.made] == [1 + 3, 1]
        assert sorted(s.key[-2] for s in cache.sites()) == [False, True]
    finally:
        trace.disable()
        trace.reset()
