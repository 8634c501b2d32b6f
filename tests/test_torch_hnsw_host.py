"""HNSW's host side in the port against ``vers_tpu``: the reference's
sequential build (``build_index``, numpy, quirks kept) must give the
same layers, neighbour sets and distances (1e-6) and the same
``search_approximate``; bincode files must be byte-identical both ways
(the port saves and the JAX package loads, and back); ``load_index``
infers ``dim``; a one-layer index returns no results (the reference's
quirk). Everything runs on the CPU."""

import numpy as np
import pytest
import torch

from vers_tpu.index.hnsw import HNSWIndex as JaxHNSW
from vers_tpu_torch.index.hnsw import HNSWIndex

torch.set_num_threads(2)

TOL = 1e-6


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def built():
    x = _normed(np.random.default_rng(3), 300, 16)
    j = JaxHNSW.build_index(4, 32, 16, 8, x, seed=0)
    t = HNSWIndex.build_index(4, 32, 16, 8, x, seed=0, device="cpu")
    return x, j, t


def _assert_same_layers(j, t):
    assert len(j.layers) == len(t.layers)
    for lj, lt in zip(j.layers, t.layers):
        assert list(lj.adjacency) == list(lt.adjacency)  # insertion order too
        for nid, item in lj.adjacency.items():
            other = lt.adjacency[nid]
            assert item.neighbours == other.neighbours, nid
            a = item.items_sorted_ascending()
            b = other.items_sorted_ascending()
            assert [p.candidate_id for p in a] == [p.candidate_id for p in b]
            assert np.allclose([p.distance for p in a],
                               [p.distance for p in b], rtol=0.0, atol=TOL)


def test_sequential_build_matches(built):
    _, j, t = built
    assert t.get_num_nodes_in_layers() == j.get_num_nodes_in_layers()
    assert t.get_num_nodes_in_layers()[0] == 300
    _assert_same_layers(j, t)
    assert abs(t.layer_multiplier - j.layer_multiplier) < 1e-12


@pytest.mark.parametrize("probe", [0, 7, 99, 250])
def test_search_approximate_matches(built, probe):
    x, j, t = built
    want = j.search_approximate(x[probe], 10)
    got = t.search_approximate(x[probe], 10)
    assert [i for i, _ in got] == [i for i, _ in want]
    assert np.allclose([d for _, d in got], [d for _, d in want],
                       rtol=0.0, atol=TOL)
    assert got[0][0] == probe


def test_files_byte_identical_both_ways(tmp_path, built):
    x, j, t = built
    p_t, p_j = tmp_path / "port.index", tmp_path / "jax.index"
    t.save_index(str(p_t))
    j.save_index(str(p_j))
    assert p_t.read_bytes() == p_j.read_bytes()
    # the port's file through the JAX package, and back
    j2 = JaxHNSW.load_index(str(p_t), dim=16)
    p_j2 = tmp_path / "jax2.index"
    j2.save_index(str(p_j2))
    assert p_j2.read_bytes() == p_t.read_bytes()
    t2 = HNSWIndex.load_index(str(p_j), dim=16, device="cpu")
    p_t2 = tmp_path / "port2.index"
    t2.save_index(str(p_t2))
    assert p_t2.read_bytes() == p_j.read_bytes()
    _assert_same_layers(j2, t2)
    assert t2.search_approximate(x[5], 10) == t.search_approximate(x[5], 10)


def test_load_index_infers_dim(tmp_path, built):
    x, _, t = built
    p = tmp_path / "h.index"
    t.save_index(str(p))
    re = HNSWIndex.load_index(str(p), device="cpu")
    assert re.dim == 16
    assert re.get_num_nodes_in_layers() == t.get_num_nodes_in_layers()
    assert re.ef_search == t.ef_search and re.ef_construction == t.ef_construction
    assert np.array_equal(re._vecs[: re._rows_used], x)


def test_single_layer_quirk():
    x = _normed(np.random.default_rng(5), 50, 8)
    t = HNSWIndex.build_index(1, 16, 8, 4, x, device="cpu")
    j = JaxHNSW.build_index(1, 16, 8, 4, x)
    assert t.search_approximate(x[0], 5) == [] == j.search_approximate(x[0], 5)
    res = t.search_batch(x[:3], 5)
    assert (res.ids == -1).all() and np.isinf(res.distances).all()
    d, i = t.search_batch_device(x[:3], 5)
    assert (i == -1).all()


def test_add_host_path_matches(built):
    x, _, _ = built
    # a fresh pair: add mutates
    j = JaxHNSW.build_index(3, 24, 16, 6, x[:120], seed=1)
    t = HNSWIndex.build_index(3, 24, 16, 6, x[:120], seed=1, device="cpu")
    for k, v in enumerate(x[120:125]):
        j.add(v, 1000 + k)
        t.add(v, 1000 + k)
    _assert_same_layers(j, t)
    assert t.search_approximate(x[122], 3)[0][0] == 1002


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _normed(np.random.default_rng(6), 20, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        HNSWIndex.build_index(2, 8, 8, 4, x)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        HNSWIndex.build_index_batched(2, 8, 8, 4, x)
