"""``HNSWIndex`` end to end on the CPU (``device="cpu"``) against
``vers_tpu``'s: one wave build on each side at 600 x 48,
``(4, 48, 32, 8)``, ``wave_cap=128`` (the JAX one in a module fixture),
then

- the port's own graph equal to the JAX graph;
- ``search_batch`` and ``search_batch_device`` on the default scan
  router with the classic beam, the inline beam forced by
  ``nav_inline_dp=32`` (the JAX basis carried over), and
  ``route_mode="beam"``;
- ``add`` on the device fast path: after three adds, ``_pending_graph``
  and ``_last_add_patch`` equal the reference's, on the classic and
  the inline index; ``add`` on the host path;
- ``_materialize_layers`` and a save equal to the reference's file,
  byte for byte;
- ``build_index_device`` on a padded tensor.

Ids must be equal; a row that differs must be traced to a gap under
1e-6 between bf16 nav distances; f32 distances within 1e-5."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from vers_tpu.config import HNSWConfig as JaxConfig
from vers_tpu.index.hnsw import HNSWIndex as JaxHNSW
from vers_tpu_torch.config import HNSWConfig
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.utils.harness import recall_at_k

torch.set_num_threads(2)

TOL = 1e-5
GAP = 1e-6
ARGS = (4, 48, 32, 8)  # num_layers, ef_construction, ef_search, M


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(21)
    x = _normed(rng, 600, 48)
    q = _normed(rng, 64, 48)
    extra = _normed(rng, 4, 48)
    j = JaxHNSW.build_index_batched(*ARGS, x, wave_cap=128)
    t = HNSWIndex.build_index_batched(*ARGS, x, wave_cap=128, device="cpu")
    return dict(x=x, q=q, extra=extra, jax=j, port=t)


def _cfg(cls, **kw):
    return cls(num_layers=4, ef_construction=48, ef_search=32, num_neighbours=8,
               **kw)


def _nav(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def _assert_ids(x, q, got_ids, want_ids):
    xn, qn = _nav(x), _nav(q)
    for r in np.flatnonzero((got_ids != want_ids).any(axis=1)):
        a = {int(i) for i in got_ids[r] if i >= 0}
        b = {int(i) for i in want_ids[r] if i >= 0}
        if a == b:
            continue
        d = np.sort(1.0 - xn[sorted(a | b)] @ qn[r])
        assert np.diff(d).min() < GAP, (r, sorted(a - b), sorted(b - a))


def _assert_pending_equal(got, want):
    assert len(got) == len(want)
    for l, ((mt, at, dt), (mj, aj, dj)) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(mt), np.asarray(mj)), l
        assert np.array_equal(at, aj), l
        assert np.allclose(dt, dj, rtol=0.0, atol=1e-6), l


def test_build_matches(pair):
    _assert_pending_equal(pair["port"]._pending_graph, pair["jax"]._pending_graph)
    assert (pair["port"].get_num_nodes_in_layers()
            == pair["jax"].get_num_nodes_in_layers())
    sec = pair["port"].build_seconds
    assert sec["waves"] == 7 and sec["wave_cap"] == 128


@pytest.mark.parametrize("kw", [{}, dict(route_mode="beam"),
                                dict(nav_dtype="float32"), dict(route_seeds=3),
                                dict(beam_expand=2, beam_steps=6)])
def test_search_matches(pair, kw):
    x, q = pair["x"], pair["q"]
    j = copy.copy(pair["jax"])
    j.config, j._device_cache = _cfg(JaxConfig, **kw), None
    want = j.search_batch(q, 10)
    t = HNSWIndex.from_numpy(x, pair["jax"]._pending_graph, 48, 32, 4, 8,
                             config=_cfg(HNSWConfig, **kw), device="cpu")
    got = t.search_batch(q, 10)
    _assert_ids(x, q, got.ids, want.ids)
    same = (got.ids == want.ids).all(axis=1)
    assert same.mean() > 0.95
    assert np.allclose(got.distances[same], want.distances[same], rtol=0.0,
                       atol=TOL)
    d, i = t.search_batch_device(q, 10)
    assert i.dtype == torch.int32 and d.dtype == torch.float32
    assert np.array_equal(i.numpy(), got.ids)
    if "beam_steps" not in kw:  # 6 steps of 2 expansions stop short
        truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
        assert recall_at_k(got.ids, truth) > 0.85


def test_inline_forced_matches(pair):
    x, q = pair["x"], pair["q"]
    j = copy.copy(pair["jax"])
    j.config, j._device_cache = _cfg(JaxConfig, nav_inline_dp=32), None
    want = j.search_batch(q, 10)
    basis = np.asarray(j._device_cache["inline"]["basis"])
    t = HNSWIndex.from_numpy(x, pair["jax"]._pending_graph, 48, 32, 4, 8,
                             config=_cfg(HNSWConfig, nav_inline_dp=32),
                             basis=basis, device="cpu")
    got = t.search_batch(q, 10)
    assert t._device_cache["inline"]["tab"].shape[1] == 32 * t._device_cache["adjs"][0].shape[1]
    _assert_ids(x, q, got.ids, want.ids)
    same = (got.ids == want.ids).all(axis=1)
    assert same.mean() > 0.95
    assert np.allclose(got.distances[same], want.distances[same], rtol=0.0,
                       atol=TOL)
    # the port's own basis: the same results up to near-ties
    own = HNSWIndex.from_numpy(x, pair["jax"]._pending_graph, 48, 32, 4, 8,
                               config=_cfg(HNSWConfig, nav_inline_dp=32),
                               device="cpu").search_batch(q, 10)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
    assert abs(recall_at_k(own.ids, truth) - recall_at_k(got.ids, truth)) <= 0.02


def _patch_equal(got, want):
    assert got["row"] == want["row"] and got["l1_added"] == want["l1_added"]
    assert set(got["adj0"]) == set(want["adj0"])
    for r in want["adj0"]:
        assert np.array_equal(got["adj0"][r], want["adj0"][r]), r


@pytest.mark.parametrize("kw", [{}, dict(nav_inline_dp=32)])
def test_add_fast_path_matches(pair, kw):
    x = pair["x"]
    j = copy.deepcopy(pair["jax"])
    j.config, j._device_cache = _cfg(JaxConfig, **kw), None
    basis = None
    if kw:
        basis = np.asarray(j._ensure_device_cache()["inline"]["basis"])
    t = HNSWIndex.from_numpy(x, pair["jax"]._pending_graph, 48, 32, 4, 8,
                             config=_cfg(HNSWConfig, **kw), basis=basis,
                             device="cpu")
    for k in range(3):
        v = pair["extra"][k]
        j.add(v, 600 + k)
        t.add(v, 600 + k)
        assert t._last_add_patch is not None
        _patch_equal(t._last_add_patch, j._last_add_patch)
    assert j._pending_graph is not None and t._pending_graph is not None
    _assert_pending_equal(t._pending_graph, j._pending_graph)
    res = t.search_batch(pair["extra"][:3], 1)
    assert list(res.ids[:, 0]) == [600, 601, 602]
    cache = t._device_cache
    assert cache["vecs"].shape[0] >= 603 and len(cache["node_ids"]) == 603
    if kw:
        # the inline rows the adds touched equal a rebuild of the table
        from vers_tpu_torch.ops.beam_inline import build_inline_table

        fresh = build_inline_table(cache["inline"]["proj"], cache["adjs"][0], 32)
        assert torch.equal(fresh, cache["inline"]["tab"])


def test_add_host_path_matches(pair):
    x = pair["x"]
    j = copy.deepcopy(pair["jax"])
    t = HNSWIndex.from_numpy(x, pair["jax"]._pending_graph, 48, 32, 4, 8,
                             device="cpu")
    # an id that does not append: the host path (materialize, then the
    # reference's insertion)
    j.add(pair["extra"][3], 5000)
    t.add(pair["extra"][3], 5000)
    assert t._pending_graph is None and t._last_add_patch is None
    for lj, lt in zip(j.layers, t.layers):
        assert list(lj.adjacency) == list(lt.adjacency)
        for nid, item in lj.adjacency.items():
            assert item.neighbours == lt.adjacency[nid].neighbours
    assert t.search_approximate(pair["extra"][3], 3)[0][0] == 5000
    assert t.search_batch(pair["extra"][3:4], 1).ids[0, 0] == 5000


def test_materialize_and_save_byte_identical(tmp_path, pair):
    # the JAX graph on both sides: the port's own build matches it with
    # distances to 1e-6 (f32 sums in another order), not bit for bit
    j = copy.deepcopy(pair["jax"])
    t = HNSWIndex.from_numpy(pair["x"], pair["jax"]._pending_graph, 48, 32, 4,
                             8, device="cpu")
    pending = HNSWIndex.from_numpy(pair["x"], pair["jax"]._pending_graph, 48,
                                   32, 4, 8, device="cpu")
    t._materialize_layers()
    assert t._pending_graph is None
    assert t.get_num_nodes_in_layers() == j.get_num_nodes_in_layers()
    pj, pt = tmp_path / "j.index", tmp_path / "t.index"
    j.save_index(str(pj))
    t.save_index(str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    # the materialized graph serves the same searches as the pending one
    a = pending.search_batch(pair["q"], 10)
    b = t.search_batch(pair["q"], 10)
    assert np.array_equal(a.ids, b.ids)


def test_build_index_device_on_a_tensor(pair):
    x = pair["x"]
    corpus = torch.zeros((640, 48))
    corpus[:600] = torch.from_numpy(x)
    h = HNSWIndex.build_index_device(*ARGS, corpus, n_valid=600, wave_cap=128)
    assert h.device == corpus.device
    _assert_pending_equal(h._pending_graph, pair["port"]._pending_graph)
    a = h.search_batch(pair["q"], 10)
    b = pair["port"].search_batch(pair["q"], 10)
    assert np.array_equal(a.ids, b.ids)
    assert h.search_approximate(x[9], 5)[0][0] == 9
    assert np.allclose(h._vecs[:600], x)
    with pytest.raises(ValueError):
        HNSWIndex.build_index_device(3, 16, 8, 4, torch.zeros((100, 8)))


def test_config_replace_rebuilds_cache(pair):
    t = copy.copy(pair["port"])
    t._device_cache = None
    t.config = dataclasses.replace(t.config, max_degree=5)
    t.search_batch(pair["q"][:4], 5)
    assert t._device_cache["adjs"][0].shape[1] == 5
