"""The port's HNSW search against the benchmark's plain reference
(``perfbench/reference/hnsw.py``), on the CPU at a small size.

- The plain search (the reference's FIFO layer search, in f64) with a
  beam as wide as the corpus returns the exact nearest rows wherever
  every row is reachable.
- ``HNSWIndex`` built by ``build_index_device`` and served on the route
  the benchmark's cell takes (the scan router, the inline layer-0 beam,
  the f32 rescore), judged as the cell judges it: exact f32 distances,
  unique live rows nearest first, recall within the reference's over the
  port's own graph, a sound graph.
- The check fails a beam cut to one step and random layer-0 lists.
- With tracing on, a search and a build leave the ``hnsw.*`` spans, and
  the trace's counters equal the beam's steps and flag reads.

This file imports neither jax nor vers_tpu.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from perfbench.reference import hnsw as ref  # noqa: E402
from vers_tpu_torch import HNSWIndex, trace  # noqa: E402
from vers_tpu_torch.ops import beam, beam_inline  # noqa: E402

torch.set_num_threads(2)

N, DIM, M, LAYERS, EFC, K = 1500, 24, 8, 4, 40, 10
# the served lists' cap and the inline table's width: small enough that
# a 1500-row index takes the cell's route
MAX_DEGREE, DP = 12, 16
# dist_err: the port's distances are f32 rescores of unit rows, 1 - an
# f32 dot of 24 products, off the f64 value by ~1e-7; distances of rows
# rounded to bf16 are off by ~1e-3, so 1e-5 tells the two apart
DIST_ERR = 1e-5
# recall_gap: the port's beam (a capped number of steps from the scan's
# seeds) trails the reference's exhaustive FIFO search a little (0.02-0.03
# at this size and ef 32-48); a beam cut to one step trails it by 0.4
RECALL_GAP = 0.1


def _clustered(seed: int, n: int, q: int):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(12, DIM)) * 2.0
    x = centres[rng.integers(0, 12, n)] + rng.normal(size=(n, DIM))
    qs = x[rng.integers(0, n, q)] + 0.5 * rng.normal(size=(q, DIM))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(
        qs.astype(np.float32))


def _index(x: torch.Tensor, ef: int, **serving) -> HNSWIndex:
    corpus = torch.zeros((-(-x.shape[0] // 128) * 128, DIM))
    corpus[: x.shape[0]] = x
    idx = HNSWIndex.build_index_device(LAYERS, EFC, ef, M, corpus,
                                       n_valid=x.shape[0])
    idx.config = dataclasses.replace(idx.config, nav_inline_dp=DP,
                                     max_degree=MAX_DEGREE, **serving)
    return idx


def _graph(idx: HNSWIndex) -> dict:
    cache = idx._ensure_device_cache()
    return dict(adjs=list(cache["adjs"]), entry=int(cache["entry"]),
                members=[torch.from_numpy(m) for m, _, _ in idx._pending_graph])


def _judge(idx: HNSWIndex, queries: torch.Tensor, ef: int) -> dict:
    res = idx.search_batch(queries, K)
    g = _graph(idx)
    corpus = idx._corpus_dev
    rows = torch.randperm(N, generator=torch.Generator().manual_seed(5))[:256]
    return ref.judge(corpus, N, queries, torch.from_numpy(res.distances),
                     torch.from_numpy(res.ids), K, ef, g["adjs"], g["members"],
                     ref.served_caps(LAYERS, M, MAX_DEGREE), g["entry"], rows)


@pytest.fixture(scope="module")
def data():
    return _clustered(11, N, 200)


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 10), (2, 1)])
def test_reference_at_full_ef_is_exact(seed, k):
    """Over a graph where every row is reachable (each row linked to its
    3 ring neighbours on each side on layer 0, a strided subset above),
    a beam of all rows finds the exact k nearest."""
    n = 300
    x, q = _clustered(seed, n, 40)
    ring = torch.arange(n)[:, None] + torch.tensor([-3, -2, -1, 1, 2, 3])
    adj0 = ring % n
    adj1 = torch.full((n, 2), -1)
    top = torch.arange(0, n, 10)
    adj1[top] = torch.stack([torch.roll(top, 1), torch.roll(top, -1)], 1)
    plain = ref.PlainHNSW(x, [adj0, adj1], entry=0)
    d, i = plain.search(q.double(), k, ef=n)
    exact = ref.exact_nearest(x.double(), q, k)
    assert torch.equal(i, exact)
    want = 1.0 - (x.double()[exact] * q.double()[:, None, :]).sum(-1)
    torch.testing.assert_close(d, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ef", [32, 48])
def test_port_on_the_cells_route_against_the_reference(data, ef):
    x, q = data
    idx = _index(x, ef)
    out = _judge(idx, q, ef)
    cache = idx._ensure_device_cache()
    # the cell's route: the scan router over layer 1, the inline beam,
    # the f32 rescore of a bf16-navigated beam
    assert cache["l1_tab"] is not None and cache["inline"] is not None
    assert cache["vecs_nav"].dtype == torch.bfloat16
    assert cache["policy"] == (MAX_DEGREE, DP)
    assert out["dist_err"] < DIST_ERR, out
    assert out["stray_ids"] == 0 and out["graph_stray"] == 0, out
    assert out["recall_gap"] < RECALL_GAP, out
    assert out["recall_at_10"] > 0.75, out


@pytest.mark.parametrize("fault", ["short_beam", "random_edges"])
def test_the_check_fails_a_broken_search(data, fault):
    x, q = data
    ef = 32
    if fault == "short_beam":
        idx = _index(x, ef, beam_steps=1)
    else:
        idx = _index(x, ef)
        mem, adj, dist = idx._pending_graph[0]
        live = (adj >= 0) & np.isfinite(dist)
        rnd = np.random.default_rng(3).integers(0, N, adj.shape)
        idx._pending_graph[0] = (mem, np.where(live, rnd, adj).astype(adj.dtype),
                                 dist)
    out = _judge(idx, q, ef)
    assert out["dist_err"] < DIST_ERR  # the distances stay exact
    assert out["recall_gap"] > 2 * RECALL_GAP, out
    if fault == "random_edges":
        assert out["graph_stray"] > 0 or out["self_miss"] > 0.3, out


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def test_spans_and_counters(tracing, data, monkeypatch):
    x, q = data
    ef = 32
    idx = _index(x, ef)
    snap = trace.snapshot()
    assert snap["spans"]["hnsw.build"]["count"] == 1
    assert snap["spans"]["hnsw.wave"]["count"] >= 3
    assert snap["counters"]["beam_steps"] > 0  # the build's beams count too
    trace.reset()
    assert trace.snapshot()["counters"] == dict.fromkeys(trace.COUNTERS, 0)

    steps, reads = [0], [0]
    inner_step = beam_inline.inline_step

    def counted_step(*a, **kw):
        step = inner_step(*a, **kw)

        def run(state):
            steps[0] += 1
            return step(state)
        return run

    inner_wait = beam.host_wait

    def counted_wait(t):
        reads[0] += 1
        inner_wait(t)

    monkeypatch.setattr(beam_inline, "inline_step", counted_step)
    monkeypatch.setattr(beam, "host_wait", counted_wait)
    idx.search_batch_device(q, K)
    snap = trace.snapshot()
    counts = {n: v["count"] for n, v in snap["spans"].items()}
    assert counts["hnsw.search"] == 1 and counts["hnsw.cache"] == 1
    assert counts["route"] == counts["beam"] == counts["rescore"] == 1
    cap = -(-ef // 4)  # the inline beam's step cap: ceil(ef / expand)
    assert 0 < steps[0] <= cap and reads[0] == counts.get("hnsw.flag", 0)
    assert snap["counters"] == dict(
        dict.fromkeys(trace.COUNTERS, 0), beam_steps=steps[0],
        beam_flag_reads=reads[0], beam_stopped_early=int(steps[0] < cap))
    search = next(s for s in snap["recent"] if s.name == "hnsw.search")
    for s in snap["recent"]:
        if s.name in ("route", "beam", "rescore", "hnsw.flag", "hnsw.cache"):
            assert s.call == search.call
