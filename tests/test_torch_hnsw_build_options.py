"""The wave build's two search options in the port against
``vers_tpu.ops.hnsw_build`` on the CPU, at 600 x 24, ``(4, 48, 32, 8)``,
``wave_cap=128`` (the shape of ``tests/test_torch_hnsw_build.py``):

- ``build_graph(route_scan=True)`` at ``seed_count`` 1 and 3: exact
  scans of each upper layer's built members (kernel A's plain version
  on the CPU) in place of the routing beams. The same members and,
  row for row, the same adjacency as the JAX graph (a row that differs
  is traced to a neighbour-distance gap under 1e-6); the same layer
  sizes as the classic build and recall@10 within 0.05 of it, as
  ``tests/test_hnsw_batched.py`` holds the JAX package's;
- ``build_graph(insert_inline=True, inline_dp=16, inline_refine=48)``:
  the layer-0 insertion beam on the construction-time inline table.
  On the JAX package's PCA basis (captured from its build and handed
  to the port's) the graph matches as above; on the port's own basis
  the recall conditions hold;
- the 8 GiB guard of the inline table (made smaller) refusing the same
  builds in both packages; route_scan with insert_inline raising in
  both;
- the options through ``HNSWIndex.build_index_batched``,
  ``build_index_device`` and ``PartitionedHNSWIndex.build_index``
  (2 shards), the last equal to the JAX package's.

Each JAX build runs once, in a module-scoped fixture."""

import numpy as np
import pytest
import torch

import vers_tpu.ops.beam_inline as jbi
from test_torch_hnsw_build import _assert_graphs_match
from vers_tpu.ops import hnsw_build as jb
from vers_tpu.parallel.hnsw_partitioned import (
    PartitionedHNSWIndex as JaxPartHNSW,
)
from vers_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.ops import beam_inline as tbi
from vers_tpu_torch.ops import cuda_topk
from vers_tpu_torch.ops import hnsw_build as tb
from vers_tpu_torch.parallel import PartitionedHNSWIndex, make_mesh
from vers_tpu_torch.utils.harness import recall_at_k
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

SHAPE = (4, 48, 8)  # num_layers, ef_construction, M
INLINE = dict(insert_inline=True, inline_dp=16, inline_refine=48)


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    return _normed(np.random.default_rng(21), 600, 24)


def _jax_graph(x, **kw):
    """The JAX package's graph, and the PCA basis its build computed
    (None without the inline table)."""
    seen = []
    real = jbi.pca_projection

    def recording(corpus, dp, **k):
        basis = real(corpus, dp, **k)
        seen.append(np.array(basis))
        return basis

    jbi.pca_projection = recording
    try:
        _, graph = jb.build_graph(x, *SHAPE, wave_cap=128, as_arrays=True, **kw)
    finally:
        jbi.pca_projection = real
    return graph, (seen[0] if seen else None)


def _port_graph(x, basis=None, **kw):
    """The port's graph; ``basis``, if given, stands in for the port's
    own PCA basis."""
    real = tbi.pca_projection
    if basis is not None:
        tbi.pca_projection = lambda corpus, dp, **k: torch.from_numpy(
            basis[:, :dp].copy()).to(corpus.device)
    try:
        _, graph = tb.build_graph(x, *SHAPE, wave_cap=128, as_arrays=True,
                                  device="cpu", **kw)
    finally:
        tbi.pca_projection = real
    return graph


@pytest.fixture(scope="module")
def jax_graphs(corpus):
    return {
        "scan1": _jax_graph(corpus, route_scan=True),
        "scan3": _jax_graph(corpus, route_scan=True, seed_count=3),
        "inline": _jax_graph(corpus, **INLINE),
    }


def _recall(x, graph):
    q = x[:64]
    truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
    idx = HNSWIndex.from_numpy(x, graph, 48, 32, 4, 8, device="cpu")
    return recall_at_k(idx.search_batch(q, 10).ids, truth), idx


@pytest.fixture(scope="module")
def classic_recall(corpus):
    graph = _port_graph(corpus)
    return _recall(corpus, graph)[0], [len(m) for m, _, _ in graph]


@pytest.mark.parametrize("key,kw", [("scan1", dict(route_scan=True)),
                                    ("scan3", dict(route_scan=True,
                                                   seed_count=3))])
def test_route_scan_graph_matches(corpus, jax_graphs, key, kw):
    got = _port_graph(corpus, **kw)
    _assert_graphs_match(corpus, "bfloat16", got, jax_graphs[key][0])


@pytest.mark.parametrize("kw", [dict(route_scan=True),
                                dict(route_scan=True, seed_count=3), INLINE])
def test_option_recall(corpus, classic_recall, kw):
    """The options keep the classic build's layer sizes (membership is
    seed-drawn) and its recall within 0.05 (on the port's own PCA basis
    for the inline table)."""
    graph = _port_graph(corpus, **kw)
    rec, idx = _recall(corpus, graph)
    base_rec, base_sizes = classic_recall
    assert [len(m) for m, _, _ in graph] == base_sizes
    assert rec > base_rec - 0.05 and rec > 0.8, (rec, base_rec)
    # the host search works on the graph too
    assert idx.search_approximate(corpus[3], 10)[0][0] == 3


def test_route_scan_recall_matches_jax(corpus, jax_graphs):
    for key, kw in (("scan1", {}), ("scan3", dict(seed_count=3))):
        got = _port_graph(corpus, route_scan=True, **kw)
        assert abs(_recall(corpus, got)[0]
                   - _recall(corpus, jax_graphs[key][0])[0]) <= 0.01, key


def test_route_scan_runs_the_scans(corpus, monkeypatch):
    """Every upper-layer step is a scan: no routing beam runs above
    layer 0, and every wave makes one k = min(efc, rows) scan per layer
    it inserts at, plus the layer-0 seed scan at k = seed_count."""
    calls = []
    real_scan = tb.scan_members

    def scan(q, tab, members, n_built, k, chunk):
        calls.append((q.shape[0], tab.shape[0], n_built, k))
        assert n_built >= 1 and n_built <= tab.shape[0]
        return real_scan(q, tab, members, n_built, k, chunk)

    beams = []
    real_beam = tb._beam

    def beam(q, vecs, adj, *a, **k):
        beams.append(adj.shape[1])
        return real_beam(q, vecs, adj, *a, **k)

    monkeypatch.setattr(tb, "scan_members", scan)
    monkeypatch.setattr(tb, "_beam", beam)
    plain = cuda_topk.LARGE_K_PLAIN
    tb.build_graph(corpus, *SHAPE, wave_cap=128, as_arrays=True, device="cpu",
                   route_scan=True, seed_count=2)
    assert cuda_topk.LARGE_K_PLAIN == plain  # k <= 128 here
    assert set(beams) == {2 * 8 + 1}  # layer 0's forward width only
    seeds = [c for c in calls if c[3] == 2]
    assert len(seeds) == len(beams) == 7  # one a wave
    assert all(k in (2, min(48, rows)) for _, rows, _, k in calls)


def test_inline_graph_matches_on_the_jax_basis(corpus, jax_graphs):
    graph, basis = jax_graphs["inline"]
    assert basis.shape == (24, 16)
    got = _port_graph(corpus, basis=basis, **INLINE)
    _assert_graphs_match(corpus, "bfloat16", got, graph)


def test_inline_table_is_kept_slot_for_slot(corpus, monkeypatch):
    """After every wave the construction table equals a rebuild from
    the adjacency: each slot holds its neighbour's projected block,
    zeros where the slot is empty."""
    real = tb._commit_edges
    checked = []

    def commit(adj, dist, rank_map, *a, inline=None, proj=None, **k):
        out = real(adj, dist, rank_map, *a, inline=inline, proj=proj, **k)
        if inline is not None:
            ids = adj[:-1].long()
            want = proj[ids.clamp(min=0)].masked_fill((ids < 0)[:, :, None], 0)
            assert torch.equal(inline[:-1], want)
            checked.append(adj.shape[0])
        return out

    monkeypatch.setattr(tb, "_commit_edges", commit)
    timings = {}
    tb.build_graph(corpus, *SHAPE, wave_cap=128, as_arrays=True, device="cpu",
                   timings=timings, **INLINE)
    assert len(checked) == 7
    assert timings["inline_table_bytes"] == 601 * (17 + 8) * 16 * 2


def test_inline_guard_and_the_two_layer0_paths(corpus, monkeypatch):
    # the JAX package counts 1024 rows (a power of two) of width 25 at
    # dp 16: 819,200 bytes; the port counts the same. (Its accepted
    # build runs with a do-nothing wave step: nothing to compile.)
    monkeypatch.setattr(jb, "make_wave_step",
                        lambda *a, **k: lambda vecs, rm, adjs, dists, *r: (
                            adjs, dists, r[3]))
    for limit, refused in ((819_200, False), (819_199, True)):
        monkeypatch.setattr(tb, "_INLINE_BUILD_MAX_BYTES", limit)
        monkeypatch.setattr(jb, "_INLINE_BUILD_MAX_BYTES", limit)
        for build, kw in ((jb.build_graph, {}), (tb.build_graph,
                                                 dict(device="cpu"))):
            if refused:
                with pytest.raises(ValueError, match="guard"):
                    build(corpus[:513], *SHAPE, wave_cap=128, as_arrays=True,
                          **INLINE, **kw)
            else:
                build(corpus[:513], *SHAPE, wave_cap=128, as_arrays=True,
                      **INLINE, **kw)
    for build, kw in ((jb.build_graph, {}), (tb.build_graph,
                                             dict(device="cpu"))):
        with pytest.raises(NotImplementedError):
            build(corpus, 3, 16, 4, route_scan=True, insert_inline=True, **kw)


def test_index_entry_points_forward_the_options(corpus, jax_graphs):
    a = HNSWIndex.build_index_batched(4, 48, 32, 8, corpus, wave_cap=128,
                                      device="cpu", route_scan=True)
    got = [(m, adj, d) for m, adj, d in a._pending_graph]
    _assert_graphs_match(corpus, "bfloat16", got, jax_graphs["scan1"][0])
    padded = torch.zeros((640, 24))
    padded[:600] = torch.from_numpy(corpus)
    b = HNSWIndex.build_index_device(4, 48, 32, 8, padded, n_valid=600,
                                     wave_cap=128, insert_inline=True,
                                     inline_dp=16, inline_refine=48)
    assert b.build_seconds["inline_table_bytes"] == 601 * 25 * 16 * 2
    assert b.get_num_nodes_in_layers() == a.get_num_nodes_in_layers()
    assert b.search_batch(corpus[:4], 1).ids[:, 0].tolist() == [0, 1, 2, 3]


def test_partitioned_route_scan_matches_jax():
    y = _normed(np.random.default_rng(5), 400, 24)
    j = JaxPartHNSW.build_index(3, 16, 16, 6, y, mesh=jax_make_mesh(2),
                                route_scan=True)
    t = PartitionedHNSWIndex.build_index(3, 16, 16, 6, y,
                                         mesh=make_mesh(2, device="cpu"),
                                         route_scan=True)
    assert len(t.shards) == 2
    for s, (js, ts) in enumerate(zip(j.shards, t.shards)):
        block = y[s * 200:(s + 1) * 200]
        _assert_graphs_match(block, "bfloat16", ts._pending_graph,
                             js._pending_graph)
    q = y[:64]
    got, want = t.search_batch(q, 10), j.search_batch(q, 10)
    assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                      rtol=0.0, atol=1e-4)
