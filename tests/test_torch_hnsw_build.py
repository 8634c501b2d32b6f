"""The port's wave-parallel HNSW build (``ops/hnsw_build.py``) against
``vers_tpu.ops.hnsw_build`` on the CPU:

- ``draw_insertion_layers`` exact;
- ``_heuristic_select`` and ``_commit_edges`` on seeded random inputs:
  ids exact, distances within 1e-6;
- ``build_graph(as_arrays=True)`` at 600 x 24, ``(4, 48, 32, 8)``,
  ``wave_cap=128``, with f32 and with bf16 navigation: the same members
  per layer and, row for row, the same adjacency (a row that differs
  must have a neighbour-distance gap under 1e-6 at the place it
  differs: the f32 sums run in another order); recall@10 of the bf16
  graphs within 0.01 of each other;
- the wave schedule, the per-wave ``sub_caps`` (which members run an
  efc-wide beam at each upper layer) and ``wave_cap="auto"`` against
  the JAX package's own build loop, read through its ``make_wave_step``
  calls, at 600 rows and at sizes where the auto cap changes.

The two JAX wave builds run once each, in module-scoped fixtures."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vers_tpu.ops import hnsw_build as jb
from vers_tpu_torch.ops import hnsw_build as tb

torch.set_num_threads(2)

SHAPE = dict(num_layers=4, ef_construction=48, m=8, wave_cap=128)


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    return _normed(np.random.default_rng(21), 600, 24)


def _jax_build(x, nav):
    """The JAX wave build, recording each wave's (wave size, bucket,
    sub_caps) through its make_wave_step."""
    waves = []
    real = jb.make_wave_step

    def recording(*args, sub_caps, **kw):
        fn = real(*args, sub_caps=sub_caps, **kw)

        def step(vecs, rank_maps, adjs, dists, wave_ids, ins_l, entry, *rest):
            ids = np.asarray(wave_ids)
            waves.append((int((ids >= 0).sum()), ids.shape[0], tuple(sub_caps)))
            return fn(vecs, rank_maps, adjs, dists, wave_ids, ins_l, entry, *rest)

        return step

    jb.make_wave_step = recording
    try:
        _, graph = jb.build_graph(
            x, SHAPE["num_layers"], SHAPE["ef_construction"], SHAPE["m"],
            wave_cap=SHAPE["wave_cap"], as_arrays=True, nav_dtype=nav)
    finally:
        jb.make_wave_step = real
    return graph, waves


@pytest.fixture(scope="module")
def jax_f32(corpus):
    return _jax_build(corpus, "float32")


@pytest.fixture(scope="module")
def jax_bf16(corpus):
    return _jax_build(corpus, "bfloat16")


def _port_build(x, nav):
    waves = []
    real = tb.wave_caps

    def recording(ins_wave, num_layers, m, wsz, wave_cap, route_layers=True):
        out = real(ins_wave, num_layers, m, wsz, wave_cap, route_layers)
        waves.append((wsz, out[0], out[1]))
        return out

    tb.wave_caps = recording
    try:
        _, graph = tb.build_graph(
            x, SHAPE["num_layers"], SHAPE["ef_construction"], SHAPE["m"],
            wave_cap=SHAPE["wave_cap"], as_arrays=True, nav_dtype=nav,
            device="cpu")
    finally:
        tb.wave_caps = real
    return graph, waves


def _nav(x, nav):
    t = torch.from_numpy(x)
    if nav == "bfloat16":
        t = t.to(torch.bfloat16)
    return t.double().numpy()


def _assert_graphs_match(x, nav, got, want):
    """Same members; each adjacency row equal, or, where it differs,
    two of the distances from the row's node to the ids of either row
    (in the nav dtype, summed in f64) within 1e-6 of each other. Rows
    that agree hold distances within 1e-6. Returns the differing rows."""
    xn = _nav(x, nav)
    differing = 0
    for l, ((mt, at, dt), (mj, aj, dj)) in enumerate(zip(got, want)):
        assert np.array_equal(mt, mj), l
        assert at.shape == aj.shape, l
        for r in np.flatnonzero((at != aj).any(axis=1)):
            differing += 1
            u = mt[r]
            ids = sorted({int(i) for i in at[r] if i >= 0}
                         | {int(i) for i in aj[r] if i >= 0})
            d = np.sort(1.0 - xn[ids] @ xn[u])
            gaps = np.diff(d)
            assert gaps.size and gaps.min() < 1e-6, (l, r, at[r], aj[r])
        same = (at == aj).all(axis=1)
        assert np.allclose(dt[same], dj[same], rtol=0.0, atol=1e-6), l
    return differing


def test_draw_insertion_layers_exact():
    for n, L, m, seed in ((20000, 6, 12, 0), (1000, 12, 24, 3), (7, 2, 2, 9)):
        assert np.array_equal(tb.draw_insertion_layers(n, L, m, seed),
                              jb.draw_insertion_layers(n, L, m, seed))


@pytest.mark.parametrize("nav", ["float32", "bfloat16"])
@pytest.mark.parametrize("w,ef,m", [(16, 48, 8), (5, 12, 16), (9, 100, 24)])
def test_heuristic_select_matches(nav, w, ef, m):
    rng = np.random.default_rng(w * 100 + ef)
    n, d = 400, 24
    x = _normed(rng, n, d)
    q = x[:w]
    beam_i = np.stack([rng.choice(n, ef, replace=False) for _ in range(w)])
    beam_i[:, -3:] = -1  # padded tail
    beam_d = np.sort((1.0 - np.einsum("wd,wed->we", q, x[np.clip(beam_i, 0, None)]))
                     .astype(np.float32), axis=1)
    beam_d[:, -3:] = np.inf
    beam_i[1, 2] = beam_i[1, 3]  # an exact repeat, as a beam never holds
    jt = jnp.asarray(x, dtype=jnp.dtype(nav))
    want_d, want_i = jb._heuristic_select(jnp.asarray(q), jt, jnp.asarray(beam_d),
                                          jnp.asarray(beam_i, jnp.int32), m)
    tt = torch.from_numpy(x).to(getattr(torch, nav))
    got_d, got_i = tb._heuristic_select(None, tt, torch.from_numpy(beam_d),
                                        torch.from_numpy(beam_i).long(), m)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.allclose(got_d.numpy(), np.asarray(want_d), rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("w,s,slack", [(12, 9, 8), (40, 17, 3), (64, 5, 16)])
def test_commit_edges_matches(w, s, slack):
    rng = np.random.default_rng(w + s)
    n_pad, deg = 256, s
    members = np.sort(rng.choice(n_pad, 150, replace=False))
    rank = np.full((n_pad,), -1, np.int32)
    rank[members] = np.arange(members.size, dtype=np.int32)
    rows = members.size
    width = deg + slack
    # a partly filled graph: some rows hold edges already
    adj0 = np.full((rows, width), -1, np.int32)
    dist0 = np.full((rows, width), np.inf, np.float32)
    for r in range(0, rows, 3):
        k = int(rng.integers(1, deg + 1))
        adj0[r, :k] = rng.choice(members, k, replace=False)
        dist0[r, :k] = np.sort(rng.random(k).astype(np.float32))
    u_ids = rng.choice(members, w, replace=False)
    sel_i = np.stack([rng.choice(members, s, replace=False) for _ in range(w)])
    sel_d = np.sort(rng.random((w, s)).astype(np.float32), axis=1)
    sel_d[:, -2:] = np.inf
    sel_i[:, -2:] = -1
    sel_d[0, 0] = sel_d[1, 0]  # equal distances into one row
    sel_i[1, 0] = sel_i[0, 0]
    connect = rng.random(w) < 0.85
    u_ids[3] = -1  # a dead wave row
    # JAX buffers: pow2 rows, dump = rows_total (scatters dropped)
    rows_j = 1 << (rows - 1).bit_length()
    aj = np.full((rows_j, width), -1, np.int32)
    dj = np.full((rows_j, width), np.inf, np.float32)
    aj[:rows], dj[:rows] = adj0, dist0
    want = jax.jit(jb._commit_edges, static_argnums=(7, 8))(
                            jnp.asarray(aj), jnp.asarray(dj), jnp.asarray(rank),
                            jnp.asarray(u_ids, jnp.int32),
                            jnp.asarray(sel_i, jnp.int32), jnp.asarray(sel_d),
                            jnp.asarray(connect), deg, slack)
    # port buffers: the live rows and one dump row
    at = torch.full((rows + 1, width), -1, dtype=torch.int32)
    dt = torch.full((rows + 1, width), float("inf"))
    at[:rows], dt[:rows] = torch.from_numpy(adj0), torch.from_numpy(dist0)
    tb._commit_edges(at, dt, torch.from_numpy(rank), torch.from_numpy(u_ids),
                     torch.from_numpy(sel_i), torch.from_numpy(sel_d),
                     torch.from_numpy(connect), deg, slack)
    assert np.array_equal(at[:rows].numpy(), np.asarray(want[0])[:rows])
    assert np.allclose(dt[:rows].numpy(), np.asarray(want[1])[:rows],
                       rtol=0.0, atol=1e-6)


def test_build_graph_f32_matches_row_for_row(corpus, jax_f32):
    got, _ = _port_build(corpus, "float32")
    differing = _assert_graphs_match(corpus, "float32", got, jax_f32[0])
    # at 600 rows no neighbour distances come within 1e-6
    assert differing == 0


def test_build_graph_bf16_matches(corpus, jax_bf16):
    got, _ = _port_build(corpus, "bfloat16")
    _assert_graphs_match(corpus, "bfloat16", got, jax_bf16[0])


def _graph_recall(x, graph):
    """recall@10 of the layer-0 graph searched exhaustively from the
    true nearest node: the share of each node's true 10 nearest among
    its 2-hop neighbourhood."""
    mem, adj, _ = graph[0]
    nb = {int(m): [int(v) for v in row if v >= 0] for m, row in zip(mem, adj)}
    truth = np.argsort(-(x[:64] @ x.T), axis=1)[:, 1:11]
    hits = 0
    for i in range(64):
        reach = set(nb[i])
        for v in nb[i]:
            reach.update(nb[v])
        hits += len(reach & set(truth[i].tolist()))
    return hits / truth.size


def test_build_graph_bf16_recall(corpus, jax_bf16):
    from vers_tpu_torch.index.hnsw import HNSWIndex
    from vers_tpu_torch.utils.harness import recall_at_k

    got, _ = _port_build(corpus, "bfloat16")
    assert abs(_graph_recall(corpus, got) - _graph_recall(corpus, jax_bf16[0])) <= 0.01
    q = corpus[:64]
    truth = np.argsort(-(q @ corpus.T), axis=1)[:, :10]
    recs = []
    for g in (got, jax_bf16[0]):
        idx = HNSWIndex.from_numpy(corpus, g, 48, 32, 4, 8, device="cpu")
        recs.append(recall_at_k(idx.search_batch(q, 10).ids, truth))
    assert abs(recs[0] - recs[1]) <= 0.01, recs
    assert recs[0] > 0.85


def test_wave_decisions_match(corpus, jax_f32):
    _, port_waves = _port_build(corpus, "float32")
    assert port_waves == jax_f32[1]
    assert [w for w, _, _ in port_waves] == [8, 64, 128, 128, 128, 128, 15]


def _jax_schedule(n, d, num_layers, m, wave_cap):
    """The JAX build loop's per-wave (size, bucket, sub_caps) with a
    do-nothing wave step (no graph is built)."""
    waves = []
    real = jb.make_wave_step

    def recording(*args, sub_caps, **kw):
        def step(vecs, rank_maps, adjs, dists, wave_ids, ins_l, entry, *rest):
            ids = np.asarray(wave_ids)
            waves.append((int((ids >= 0).sum()), ids.shape[0], tuple(sub_caps)))
            return adjs, dists

        return step

    jb.make_wave_step = recording
    try:
        jb.build_graph(np.zeros((n, d), np.float32), num_layers, 40, m,
                       wave_cap=wave_cap, as_arrays=True)
    finally:
        jb.make_wave_step = real
    return waves


@pytest.mark.parametrize("n,num_layers,m", [
    (5_000, 5, 8), (70_000, 6, 16), (530_000, 12, 24)])
def test_auto_wave_cap_and_sub_caps_match(n, num_layers, m):
    want = _jax_schedule(n, 2, num_layers, m, "auto")
    ins = tb.draw_insertion_layers(n, num_layers, m, 0)
    ins[0] = num_layers - 1
    cap, steps, route = tb.resolve_build_knobs(n, 40, 8, "auto", "auto", "auto")
    assert (steps, route) == (12, 16)
    got = []
    for wave in tb.wave_schedule(n, cap)[1:]:
        wave = wave[np.argsort(-ins[wave], kind="stable")]
        bucket, caps = tb.wave_caps(ins[wave], num_layers, m, len(wave), cap)
        got.append((len(wave), bucket, caps))
    assert got == want
    assert max(w for w, _, _ in got) == {5_000: 1024, 70_000: 2048,
                                         530_000: 4096}[n]
