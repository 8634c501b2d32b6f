"""The HNSW inline beam's step kernel (``csrc/beam_step.cu``, launched by
``ops/beam_inline.cuda_beam_step``) and its route.

On the CPU: ``beam_step_takes`` over widths inside and outside the
kernel's range; CPU tensors take the plain step, count it under
``LAUNCHES_PLAIN`` (``beam_step_plain`` in ``trace.snapshot()``) and
never load the kernel library, in a lone step and in a whole search;
the wrapper's input checks and its choice of load width.

On the card (``gpu`` marker): steps of the kernel against the plain step
bit for bit, the whole state and the active flag, on inputs of small
integers, whose f32 sums are exact in any order: forced equal
distances, ids repeated within a step and ids already in the beam, -1
pads in the beam and the adjacency, queries with nothing left to
expand, r = 0, r = 1, 0 < r < e * deg and r = e * deg, at the
benchmark's widths and at the kernel's edges (deg 49, dp 32, e 1,
ef 1 and 256, 392 and 512 candidates, d 1024, odd d, an unaligned
table); widths outside the range take the plain step, counted; a whole
HNSW search over a 50k-row graph with the kernel against the plain step
(rows in another order only where their distances lie within 1e-5, at
most 2 of the 512 rows with other ids; distances within 1e-5 where the
ids agree), its steps counted, replays included. This
file imports neither jax nor vers_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_beam_step_kernel.py
"""

import numpy as np
import pytest
import torch

from vers_tpu_torch import trace
from vers_tpu_torch.ops import _build
from vers_tpu_torch.ops import beam_inline as bi

torch.set_num_threads(2)

TOL = 1e-5
# Rows of the whole search over the 50k graph (512 queries) allowed to
# hold other ids than the plain step's: the two differ in the order of
# f32 sums, so a near-tie at a step's cut can keep another candidate
# and steer the beam elsewhere. On an H100 none did, in each of the
# three settings below.
OTHER_ROWS = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load_library", refuse)


# -- the route ----------------------------------------------------------


@pytest.mark.parametrize("widths,takes", [
    ((48, 4, 32, 64, 96, 300), True),    # the benchmark's HNSW cell
    ((48, 4, 32, 64, 0, 0), True),       # no refine: d unused
    ((32, 4, 32, 32, 64, 300), True),    # dp 32
    ((256, 5, 49, 32, 245, 1024), True),  # the range's edges
    ((1, 1, 49, 64, 1, 1), True),
    ((256, 8, 32, 64, 256, 300), True),  # 256 candidates, all refined
    ((48, 8, 49, 64, 96, 300), True),    # 392: expand 8 at degree 49
    ((256, 8, 64, 32, 512, 1024), True),  # 512 candidates, all refined
    ((48, 4, 32, 16, 96, 300), False),   # dp outside {32, 64}
    ((48, 4, 32, 128, 96, 300), False),
    ((257, 4, 32, 64, 96, 300), False),  # ef over 256
    ((48, 11, 49, 64, 96, 300), False),  # 539 candidates
    ((256, 2, 257, 64, 0, 0), False),    # 514 candidates
    ((48, 4, 32, 64, 96, 1025), False),  # full-dim rows over 1024
    ((48, 4, 32, 64, 96, 0), False),     # refine without rows
    ((48, 4, 32, 64, 129, 300), False),  # r over e * deg
    ((4, 5, 32, 64, 0, 0), False),       # e over ef
    ((48, 0, 32, 64, 0, 0), False),
])
def test_beam_step_takes(widths, takes):
    assert bi.beam_step_takes(*widths) is takes
    assert bi.beam_step_takes(*widths, bf16=False) is False


def _tiny(rng, q_n=12, n_pad=90, deg=6, dp=32, d=40):
    """A small projected beam problem on the CPU: tables, queries and a
    seeded state."""
    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    adj = rng.integers(-1, n_pad, size=(n_pad, deg)).astype(np.int32)
    seeds = np.stack([rng.permutation(n_pad)[:4] for _ in range(q_n)])
    return dict(
        qp=bf16(rng.normal(size=(q_n, dp))), tab=bf16(rng.normal(size=(n_pad, deg * dp))),
        adj=torch.from_numpy(adj), qn=bf16(rng.normal(size=(q_n, d))),
        vecs=bf16(rng.normal(size=(n_pad, d))), seeds=torch.from_numpy(seeds),
        seed_d=torch.from_numpy(rng.normal(size=(q_n, 4)).astype(np.float32)))


@pytest.mark.parametrize("refine", [0, 5])
def test_cpu_steps_take_the_plain_step(no_library, refine):
    p = _tiny(np.random.default_rng(refine))
    before = (bi.LAUNCHES, bi.LAUNCHES_PLAIN)
    trace.enable()
    try:
        trace.reset()
        got = bi.beam_search_layer_inline(
            p["qp"], p["tab"], p["adj"], p["seeds"], p["seed_d"], ef=8,
            max_steps=5, expand_per_step=2, refine_r=refine,
            queries_nav=p["qn"], vecs_nav=p["vecs"], sync_every=0)
        steps = trace.snapshot()["counters"]["beam_steps"]
    finally:
        trace.disable()
        trace.reset()
    assert steps == 5
    assert (bi.LAUNCHES, bi.LAUNCHES_PLAIN) == (before[0], before[1] + 5)
    launches = trace.snapshot()["launches"]
    assert launches["beam_step"] == bi.LAUNCHES
    assert launches["beam_step_plain"] == bi.LAUNCHES_PLAIN
    assert got[1].shape == (12, 8)


def test_cpu_search_counts_plain_steps(no_library):
    from vers_tpu_torch.config import HNSWConfig
    from vers_tpu_torch.index.hnsw import HNSWIndex
    from vers_tpu_torch.utils.data import synthetic_gaussian

    x, q = synthetic_gaussian(1500, 40, n_clusters=8, n_queries=16, seed=4,
                              normalized=True, query_noise=0.5)
    config = HNSWConfig(num_layers=3, ef_construction=32, ef_search=16,
                        num_neighbours=6, nav_inline_dp=32)
    built = HNSWIndex.build_index_batched(3, 32, 16, 6, x, device="cpu")
    idx = HNSWIndex.from_numpy(x, built._pending_graph, 32, 16, 3, 6,
                               config=config, device="cpu")
    before = (bi.LAUNCHES, bi.LAUNCHES_PLAIN)
    trace.enable()
    try:
        trace.reset()
        idx.search_batch(q, 5)
        steps = trace.snapshot()["counters"]["beam_steps"]
    finally:
        trace.disable()
        trace.reset()
    assert idx._device_cache["inline"] is not None
    assert 0 < steps <= 4  # ceil(ef / 4) steps at most
    assert (bi.LAUNCHES, bi.LAUNCHES_PLAIN) == (before[0], before[1] + steps)


def _state(q_n, ef):
    return (torch.zeros((q_n, ef)), torch.full((q_n, ef), -1, dtype=torch.int64),
            torch.zeros((q_n, ef), dtype=torch.bool))


@pytest.mark.parametrize("fault", ["beam_dtype", "beam_shape", "adj_dtype",
                                   "tab_width", "nav_dtype", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(no_library, fault):
    p = _tiny(np.random.default_rng(9))
    state = list(_state(12, 8))
    args = dict(queries_p=p["qp"], adj=p["adj"], inline_tab=p["tab"],
                queries_nav=p["qn"], vecs_nav=p["vecs"])
    if fault == "beam_dtype":
        state[1] = state[1].int()
    elif fault == "beam_shape":
        state[0] = state[0][:, :7]
    elif fault == "adj_dtype":
        args["adj"] = p["adj"].long()
    elif fault == "tab_width":
        args["inline_tab"] = p["tab"][:, :-32].contiguous()
    elif fault == "nav_dtype":
        args["vecs_nav"] = p["vecs"].float()
    else:
        args["queries_p"] = torch.cat([p["qp"], p["qp"]], dim=1)[:, ::2]
    with pytest.raises(ValueError):
        bi.cuda_beam_step(tuple(state), ef=8, e=2, r=5, **args)


@pytest.mark.parametrize("d,offset,width", [
    (300, 0, 4), (256, 0, 8), (302, 0, 2), (301, 0, 1), (64, 4, 2),
    (64, 2, 1), (64, 8, 4)])
def test_load_width(d, offset, width):
    n = 6
    buf = torch.zeros(n * d + 16, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    vecs = buf[offset // 2 : offset // 2 + n * d].view(n, d)
    assert bi._load_width(vecs) == width


# -- on the card --------------------------------------------------------


def _exact_problem(rng, q_n, n_pad, ef, e, deg, dp, d, offset, dev):
    """Tables, queries and a state of small integers: every product and
    sum of the step is exact in f32 whatever its order, and distances
    tie often. The adjacency repeats ids within rows and across them
    (n_pad is small), holds -1 pads, and names ids of the beams; beams
    hold live ids first, then -1 pads; some queries have nothing left
    to expand, some have no live entry."""
    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(dev)

    adj = rng.integers(0, n_pad, size=(n_pad, deg))
    adj[rng.random(adj.shape) < 0.1] = -1
    adj[:, -1] = adj[:, 0]  # a repeat within every row
    tab = bf16(rng.integers(-2, 3, size=(n_pad, deg * dp)))
    vecs = rng.integers(-2, 3, size=(n_pad, d))
    buf = torch.zeros(n_pad * d + 8, dtype=torch.bfloat16, device=dev)
    vecs_nav = buf[offset : offset + n_pad * d].view(n_pad, d)
    vecs_nav.copy_(bf16(vecs))
    beam_d = np.full((q_n, ef), np.inf, np.float32)
    beam_i = np.full((q_n, ef), -1, np.int64)
    expanded = np.zeros((q_n, ef), bool)
    for r in range(q_n):
        live = [0, ef, 1][r] if r < 3 else int(rng.integers(1, ef + 1))
        beam_i[r, :live] = rng.permutation(n_pad)[:live]
        beam_d[r, :live] = rng.integers(-8, 9, size=live)
        expanded[r, :live] = rng.random(live) < (1.0 if r == 1 else 0.4)
    state = (torch.from_numpy(beam_d).to(dev), torch.from_numpy(beam_i).to(dev),
             torch.from_numpy(expanded).to(dev))
    return dict(
        qp=bf16(rng.integers(-1, 2, size=(q_n, dp))),
        qn=bf16(rng.integers(-1, 2, size=(q_n, d))),
        adj=torch.from_numpy(adj.astype(np.int32)).to(dev), tab=tab,
        vecs=vecs_nav, state=state)


def _same_state(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("ef,e,deg,dp,r,d,offset", [
    (48, 4, 32, 64, 96, 300, 0),     # the benchmark's HNSW cell
    (48, 4, 32, 64, 0, 300, 0),      # no refine
    (16, 2, 16, 32, 32, 64, 0),      # r = e * deg; 16-byte row loads
    (256, 5, 49, 32, 100, 1024, 0),  # deg 49, ef 256, d 1024
    (32, 1, 49, 64, 1, 37, 0),       # e 1, r 1, odd d
    (24, 3, 7, 32, 10, 302, 0),      # 4-byte row loads
    (256, 8, 32, 64, 256, 300, 0),   # 256 candidates, all refined
    (48, 8, 49, 64, 96, 300, 0),     # 392: expand 8 at degree 49
    (256, 8, 64, 32, 512, 1024, 0),  # 512 candidates, the most shared memory
    (1, 1, 5, 32, 3, 64, 0),         # ef 1
    (48, 4, 32, 64, 96, 300, 1),     # an unaligned full-dim table
])
def test_kernel_step_equals_the_plain_step(cuda, ef, e, deg, dp, r, d, offset):
    rng = np.random.default_rng(ef * 1000 + deg * 10 + r)
    p = _exact_problem(rng, 300, 400, ef, e, deg, dp, d, offset, cuda)
    assert bi.beam_step_takes(ef, e, deg, dp, r, d)
    plain = bi.plain_step(p["qp"], p["tab"], p["adj"], ef, e, r, p["qn"],
                          p["vecs"])
    want = p["state"]
    got = tuple(t.clone() for t in want)
    before = bi.LAUNCHES
    for _ in range(6):
        got_out, got_active = bi.cuda_beam_step(
            got, p["qp"], p["adj"], p["tab"], ef, e, r, p["qn"], p["vecs"])
        assert all(a is b for a, b in zip(got_out, got))  # in place
        want, want_active = plain(want)
        torch.cuda.synchronize()
        _same_state(got, want)
        assert bool(got_active) == bool(want_active)
    assert bi.LAUNCHES == before + 6
    # the forced cases happened: ties, and rows with nothing to expand
    assert not got[2][1].logical_not().logical_and(got[1][1] >= 0).any()
    fin = torch.isfinite(got[0])
    assert (got[0][:, 1:] == got[0][:, :-1])[fin[:, 1:]].any() or ef == 1


@pytest.mark.gpu
@pytest.mark.parametrize("ef,e,deg,dp", [(48, 4, 32, 16), (48, 11, 49, 64),
                                         (264, 4, 32, 64)])
def test_widths_outside_the_range_take_the_plain_step(cuda, ef, e, deg, dp):
    rng = np.random.default_rng(5)
    p = _exact_problem(rng, 40, 400, ef, e, deg, dp, 64, 0, cuda)
    before = (bi.LAUNCHES, bi.LAUNCHES_PLAIN)
    step = bi.inline_step(p["qp"], p["tab"], p["adj"], ef, e, 20, p["qn"],
                          p["vecs"])
    for _ in range(3):
        p["state"], _ = step(p["state"])
    torch.cuda.synchronize()
    assert (bi.LAUNCHES, bi.LAUNCHES_PLAIN) == (before[0], before[1] + 3)


@pytest.fixture(scope="module")
def graph_50k():
    """A wave build of 50k x 100 clustered unit rows on the card and 512
    queries near corpus rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from vers_tpu_torch.index.hnsw import HNSWIndex
    from vers_tpu_torch.utils.data import synthetic_gaussian

    x, q = synthetic_gaussian(50_000, 100, n_clusters=128, n_queries=512,
                              seed=21, normalized=True, query_noise=0.5)
    idx = HNSWIndex.build_index_batched(4, 64, 32, 16, x, device="cuda")
    return x, q, idx


def _served(graph, dp, **cfg):
    from vers_tpu_torch.config import HNSWConfig
    from vers_tpu_torch.index.hnsw import HNSWIndex

    x, _, built = graph
    config = HNSWConfig(num_layers=4, ef_construction=64, ef_search=32,
                        num_neighbours=16, nav_inline_dp=dp, **cfg)
    return HNSWIndex.from_numpy(x, built._pending_graph, 64, 32, 4, 16,
                                config=config, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dp,cfg", [(64, {}), (32, {}),
                                    (32, dict(nav_inline_refine=0))])
def test_search_with_the_kernel_equals_the_plain_step(graph_50k, monkeypatch,
                                                      dp, cfg):
    from vers_tpu_torch import graphs

    x, q, _ = graph_50k
    idx = _served(graph_50k, dp, **cfg)
    with graphs.disabled():
        before = (bi.LAUNCHES, bi.LAUNCHES_PLAIN)
        got = idx.search_batch(q, 10)
        kernel_steps = bi.LAUNCHES - before[0]
        assert kernel_steps > 0 and bi.LAUNCHES_PLAIN == before[1]
        monkeypatch.setattr(bi, "beam_step_takes", lambda *a, **k: False)
        want = idx.search_batch(q, 10)
        assert bi.LAUNCHES == before[0] + kernel_steps
        assert bi.LAUNCHES_PLAIN > before[1]
    assert idx._device_cache["inline"] is not None
    reordered, other = _compare_rows(got, want)
    assert not reordered, reordered[:8]
    assert len(other) <= OTHER_ROWS, (len(other), other[:8])
    same = got.ids == want.ids
    assert np.allclose(got.distances[same], want.distances[same], rtol=0.0,
                       atol=TOL)


def _compare_rows(got, want):
    """Rows of two (ids, distances) results that differ: those holding
    the same ids in another order where the distances at the moved
    positions are not within TOL (an order only equal distances can
    swap), and those holding other ids."""
    reordered, other = [], []
    for row in np.flatnonzero((got.ids != want.ids).any(axis=1)):
        if np.array_equal(np.sort(got.ids[row]), np.sort(want.ids[row])):
            at = got.ids[row] != want.ids[row]
            gap = np.abs(got.distances[row, at] - want.distances[row, at])
            if not (gap <= TOL).all():
                reordered.append((int(row), float(gap.max())))
        else:
            other.append(int(row))
    return reordered, other


@pytest.mark.gpu
def test_replayed_searches_count_their_steps(graph_50k):
    _, q, _ = graph_50k
    idx = _served(graph_50k, 64)
    qd = torch.from_numpy(q).cuda()
    from vers_tpu_torch import graphs

    with graphs.disabled():
        before = bi.LAUNCHES
        eager = idx.search_batch_device(qd, 10)
        steps = bi.LAUNCHES - before
    for _ in range(2):  # eager, then the capturing call
        idx.search_batch_device(qd, 10)
    before = (bi.LAUNCHES, bi.LAUNCHES_PLAIN)
    replay = idx.search_batch_device(qd, 10)
    torch.cuda.synchronize()
    assert (bi.LAUNCHES, bi.LAUNCHES_PLAIN) == (before[0] + steps, before[1])
    assert trace.snapshot()["launches"]["beam_step"] == bi.LAUNCHES
    for a, b in zip(replay, eager):
        assert torch.equal(a, b)
