"""The port's beam search (``ops/beam.py``) against ``vers_tpu.ops.beam``
on one graph: a JAX host-built HNSW index (the reference's sequential
build, 600 x 24), whose serving arrays both sides search.

- ``nav_dtype="float32"``: ids equal except swaps at equal distance,
  distances within 1e-5;
- bf16 navigation: rescored distances within 1e-5, and every row whose
  ids differ is traced to a gap under 1e-6 between nav distances
  (bf16 products summed in f64) of the ids where the two differ;
- ``beam_search_layer``, ``full_descent_scan``, ``full_descent``,
  ``rescore_cosine`` and ``insertion_candidates``;
- the loop: stopping early (the active flag read every step), running
  to the step cap with no sync, and running query chunks one by one
  give bit-identical beams;
- the layer-1 routing scan (kernel A's plain version on the CPU) against
  the JAX scan on bf16 operands;
- the index end to end on the graph carried over through a saved file.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vers_tpu.config import HNSWConfig as JaxConfig
from vers_tpu.index.hnsw import HNSWIndex as JaxHNSW
from vers_tpu.ops import beam as jbeam
from vers_tpu.ops.topk import fused_scan_topk as jax_scan
from vers_tpu_torch.config import HNSWConfig
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.ops import beam
from vers_tpu_torch.ops.topk import repeats_earlier
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

TOL = 1e-5
GAP = 1e-6


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(11)
    x = _normed(rng, 600, 24)
    j = JaxHNSW.build_index(4, 40, 32, 8, x, seed=0)
    c = j._ensure_device_cache()
    q = _normed(rng, 48, 24)
    return dict(
        x=x, q=q, jax=j,
        vecs=np.asarray(c["vecs"]),
        adjs=[np.asarray(a) for a in c["adjs"]],
        l1_tab=np.asarray(c["l1_tab"].astype(jnp.float32)),
        l1_members=np.asarray(c["l1_members"]),
        n1=int(c["n1"]), entry=int(c["entry"]),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _nav_dist(g, nav, ids, row):
    """f64 nav distances of query ``row`` to ``ids``: the table and the
    query rounded to the nav dtype."""
    xt = torch.from_numpy(g["vecs"])
    qt = torch.from_numpy(g["q"][row])
    if nav == "bfloat16":
        xt, qt = xt.to(torch.bfloat16), qt.to(torch.bfloat16)
    xn, qn = xt.double().numpy(), qt.double().numpy()
    return 1.0 - xn[np.asarray(ids)] @ qn


def _assert_traced(g, nav, got_i, want_i):
    """Rows whose live id sets differ: among the nav distances of the
    ids of both results, the differing ids must sit within GAP of
    another such distance (a near-tie flipped one decision)."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    n_diff = 0
    for r in range(got_i.shape[0]):
        a = {int(i) for i in got_i[r] if i >= 0}
        b = {int(i) for i in want_i[r] if i >= 0}
        if a == b:
            continue
        n_diff += 1
        ids = sorted(a | b)
        d = np.sort(_nav_dist(g, nav, ids, r))
        assert np.diff(d).min() < GAP, (r, sorted(a - b), sorted(b - a))
    return n_diff


@pytest.mark.parametrize("nav", ["float32", "bfloat16"])
@pytest.mark.parametrize("ef,expand,seeds", [(16, 4, 1), (32, 8, 3), (24, 1, 1)])
def test_beam_search_layer_matches(graph, nav, ef, expand, seeds):
    g = graph
    n_pad = g["vecs"].shape[0]
    rng = np.random.default_rng(ef + seeds)
    entry = np.stack([rng.choice(600, seeds, replace=False)
                      for _ in range(g["q"].shape[0])]).astype(np.int32)
    jv = jnp.asarray(g["vecs"]).astype(jnp.dtype(nav))
    want_d, want_i = jbeam.beam_search_layer(
        jnp.asarray(g["q"]), jv, jnp.asarray(g["adjs"][0]), jnp.asarray(entry),
        ef=ef, max_steps=64, expand_per_step=expand)
    tv = _t(g["vecs"]).to(getattr(torch, nav))
    got_d, got_i = beam.beam_search_layer(
        _t(g["q"]), tv, _t(g["adjs"][0]), _t(entry), ef=ef, max_steps=64,
        expand_per_step=expand)
    assert got_d.shape == (g["q"].shape[0], ef)
    if nav == "float32":
        assert_topk_match(got_d, got_i, want_d, want_i, rtol=0.0, atol=TOL)
    else:
        _assert_traced(g, nav, got_i, want_i)
        same = (got_i.numpy() == np.asarray(want_i)).all(axis=1)
        assert np.allclose(got_d.numpy()[same], np.asarray(want_d)[same],
                           rtol=0.0, atol=TOL)
    assert n_pad >= 600


def test_loop_identity(graph):
    """Early exit, run to the cap and query chunks: bit-identical."""
    g = graph
    tv = _t(g["vecs"]).to(torch.bfloat16)
    q, adj = _t(g["q"]), _t(g["adjs"][0])
    entry = torch.zeros((q.shape[0],), dtype=torch.int64)
    runs = []
    for sync in (1, 4, 0):
        runs.append(beam.beam_search_layer(q, tv, adj, entry, ef=24,
                                           max_steps=200, expand_per_step=4,
                                           sync_every=sync))
    parts = [beam.beam_search_layer(q[c:c + 7], tv, adj, entry[c:c + 7], ef=24,
                                    max_steps=200, expand_per_step=4)
             for c in range(0, q.shape[0], 7)]
    runs.append((torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])))
    for d, i in runs[1:]:
        assert torch.equal(d, runs[0][0]) and torch.equal(i, runs[0][1])
    # the loop did converge before the cap: the early exit really stopped
    steps = []

    def counting(state, step_fn, max_steps, sync_every):
        def fn(s):
            steps.append(1)
            return step_fn(s)
        return real(state, fn, max_steps, sync_every)

    real = beam.run_beam
    beam.run_beam = counting
    try:
        beam.beam_search_layer(q, tv, adj, entry, ef=24, max_steps=200,
                               expand_per_step=4, sync_every=1)
    finally:
        beam.run_beam = real
    assert 1 < len(steps) < 200


def test_repeats_earlier_matches_pairwise():
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(-1, 12, size=(30, 40)))
    want = ((ids[:, :, None] == ids[:, None, :])
            & (torch.arange(40)[None, :] < torch.arange(40)[:, None])[None]).any(2)
    assert torch.equal(repeats_earlier(ids), want)


@pytest.mark.parametrize("k", [1, 8, 13])
def test_route_scan_matches_jax(graph, k):
    g = graph
    want_d, want_pos = jax_scan(
        jnp.asarray(g["q"]).astype(jnp.bfloat16),
        jnp.asarray(g["l1_tab"]).astype(jnp.bfloat16), g["n1"], k,
        metric="cosine", precision=jax_scan_precision())
    got_d, got_pos = beam.route_scan(_t(g["q"]), _t(g["l1_tab"]), g["n1"], k)
    assert got_pos.dtype == torch.int32
    assert_topk_match(got_d, got_pos, want_d, want_pos, rtol=0.0, atol=GAP)


def jax_scan_precision():
    import jax

    return jax.lax.Precision.DEFAULT


@pytest.mark.parametrize("nav", ["float32", "bfloat16"])
@pytest.mark.parametrize("ef,seeds,expand", [(32, 8, 8), (16, 1, 4)])
def test_full_descent_scan_matches(graph, nav, ef, seeds, expand):
    g = graph
    jv = jnp.asarray(g["vecs"])
    want_d, want_i = jbeam.full_descent_scan(
        jnp.asarray(g["q"]), jv, jv.astype(jnp.dtype(nav)), jnp.zeros((1,)),
        jnp.asarray(g["adjs"][0]), jnp.asarray(g["l1_tab"]).astype(jnp.bfloat16),
        jnp.asarray(g["l1_members"]), g["n1"], top_k=10, ef=ef, seeds=seeds,
        rescore=nav != "float32", has_scales=False, expand=expand)
    tv = _t(g["vecs"])
    got_d, got_i = beam.full_descent_scan(
        _t(g["q"]), tv, tv.to(getattr(torch, nav)), _t(g["adjs"][0]),
        _t(g["l1_tab"]), _t(g["l1_members"]), g["n1"], top_k=10, ef=ef,
        seeds=seeds, rescore=nav != "float32", expand=expand)
    if nav == "float32":
        assert_topk_match(got_d, got_i, want_d, want_i, rtol=0.0, atol=TOL)
    else:
        _assert_traced(g, nav, got_i, want_i)
        same = (got_i.numpy() == np.asarray(want_i)).all(axis=1)
        assert np.allclose(got_d.numpy()[same], np.asarray(want_d)[same],
                           rtol=0.0, atol=TOL)


@pytest.mark.parametrize("nav", ["float32", "bfloat16"])
def test_full_descent_matches(graph, nav):
    g = graph
    q_n = g["q"].shape[0]
    jv = jnp.asarray(g["vecs"])
    want_d, want_i = jbeam.full_descent(
        jnp.asarray(g["q"]), jv, jv.astype(jnp.dtype(nav)), jnp.zeros((1,)),
        tuple(jnp.asarray(a) for a in g["adjs"][:3]),
        jnp.full((q_n,), g["entry"], jnp.int32), top_k=10, ef=32, ef_r=8,
        rescore=nav != "float32", has_scales=False, expand=8)
    tv = _t(g["vecs"])
    got_d, got_i = beam.full_descent(
        _t(g["q"]), tv, tv.to(getattr(torch, nav)),
        [_t(a) for a in g["adjs"][:3]],
        torch.full((q_n,), g["entry"], dtype=torch.int64), top_k=10, ef=32,
        ef_r=8, rescore=nav != "float32", expand=8)
    if nav == "float32":
        assert_topk_match(got_d, got_i, want_d, want_i, rtol=0.0, atol=TOL)
    else:
        _assert_traced(g, nav, got_i, want_i)


def test_rescore_cosine_matches(graph):
    g = graph
    rng = np.random.default_rng(4)
    ids = np.stack([rng.choice(600, 20, replace=False)
                    for _ in range(g["q"].shape[0])]).astype(np.int32)
    ids[:, 5] = -1
    want_d, want_i = jbeam.rescore_cosine(jnp.asarray(g["q"]),
                                          jnp.asarray(g["vecs"]),
                                          jnp.asarray(ids), 12)
    got_d, got_i = beam.rescore_cosine(_t(g["q"]), _t(g["vecs"]), _t(ids), 12)
    assert got_d.shape == (g["q"].shape[0], 12)
    assert_topk_match(got_d, got_i, want_d, want_i, rtol=0.0, atol=TOL)


@pytest.mark.parametrize("l_ins", [0, 2])
def test_insertion_candidates_match(graph, l_ins):
    g = graph
    q = g["q"][:1]
    jv = jnp.asarray(g["vecs"])
    want = jbeam.insertion_candidates(
        jnp.asarray(q), jv, jv.astype(jnp.bfloat16), jnp.zeros((1,)),
        tuple(jnp.asarray(a) for a in g["adjs"]),
        jnp.full((1,), g["entry"], jnp.int32), efc=40, l_ins=l_ins)
    tv = _t(g["vecs"])
    got = beam.insertion_candidates(
        _t(q), tv, tv.to(torch.bfloat16), [_t(a) for a in g["adjs"]],
        torch.full((1,), g["entry"], dtype=torch.int64), efc=40, l_ins=l_ins)
    assert got[0].shape == (l_ins + 1, 40)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.allclose(got[0].numpy(), np.asarray(want[0]), rtol=0.0, atol=TOL)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("kw", [{}, dict(route_mode="beam"),
                                dict(nav_dtype="float32"),
                                dict(route_mode="beam", ef_route=None),
                                dict(max_degree=6, beam_steps=5)])
def test_index_on_a_loaded_jax_graph(tmp_path, graph, kw):
    """The JAX package saves its host-built graph; both packages load
    the file and search it (the host-dict path of the device cache; a
    loaded neighbour set iterates in the same order on both sides, which
    the ``max_degree`` truncation reads)."""
    g = graph
    p = tmp_path / "j.index"
    g["jax"].save_index(str(p))
    cfg = dict(num_layers=4, ef_construction=40, ef_search=32, num_neighbours=8,
               **kw)
    j = JaxHNSW.load_index(str(p), dim=24, config=JaxConfig(**cfg))
    want = j.search_batch(g["q"], 10)
    t = HNSWIndex.load_index(str(p), config=HNSWConfig(**cfg), device="cpu")
    got = t.search_batch(g["q"], 10)
    if kw.get("nav_dtype") == "float32":
        assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                          rtol=0.0, atol=TOL)
    else:
        _assert_traced(g, "bfloat16", got.ids, want.ids)
    d, i = t.search_batch_device(g["q"], 10)
    assert i.dtype == torch.int32
    assert np.array_equal(i.numpy(), got.ids)
    assert torch.equal(d, torch.from_numpy(got.distances))
