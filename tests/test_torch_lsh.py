"""The RP-forest index as a whole: vers_tpu_torch's ANNIndex against
vers_tpu's on the same trees.

A JAX forest is built, its level tables carried over with
``ANNIndex.from_numpy``, and both packages answer the same queries
(the JAX side with its Pallas engine in interpret mode and with its
XLA engine). Ids are compared tie-aware, distances to atol 1e-4 (f32
sums in another order); host-side results (``search_approximate``, leaf
splits, bincode files) must be equal. Every port call runs on the CPU.
"""

import sys

import numpy as np
import pytest
import torch

import vers_tpu
import vers_tpu_torch
from vers_tpu.index.lsh import ANNIndex as JaxANNIndex
from vers_tpu_torch.core import device_id_map
from vers_tpu_torch.index.lsh import ANNIndex, _Tree
from vers_tpu_torch.io.bincode import Writer
from vers_tpu_torch.ops import cuda_binned
from vers_tpu_torch.utils.data import synthetic_gaussian
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

N, D, TREES, MAX_SIZE, Q = 3000, 32, 3, 24, 120


@pytest.fixture(scope="module")
def data():
    return synthetic_gaussian(N, D, n_clusters=12, n_queries=Q, seed=0,
                              normalized=True, query_noise=0.5)


@pytest.fixture(scope="module")
def jax_forest(data):
    x, _ = data
    return JaxANNIndex.build_index(
        TREES, MAX_SIZE, x, np.arange(N) * 2 + 1,
        config=vers_tpu.LSHConfig(num_trees=TREES, max_node_size=MAX_SIZE,
                                  engine="pallas"))


def _carry(jidx, engine="auto"):
    return ANNIndex.from_numpy(
        jidx.max_node_size, jidx._trees, jidx._values, jidx._ids,
        config=vers_tpu_torch.LSHConfig(engine=engine), device="cpu")


def _with_engine(jidx, engine):
    """The same JAX forest under another engine (the trees are shared,
    searches do not change them)."""
    return JaxANNIndex(jidx.max_node_size, jidx._trees, jidx._values,
                       jidx._ids, vers_tpu.LSHConfig(engine=engine))


def _match(got, want):
    assert got.ids.dtype == np.int64 and got.ids.shape == want.ids.shape
    assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                      rtol=0.0, atol=1e-4)


def test_lsh_config_matches_jax():
    assert (vers_tpu_torch.LSHConfig().__dict__
            == vers_tpu.LSHConfig().__dict__)


@pytest.mark.parametrize("probes", [None, 1, 4])
@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_search_batch_matches_jax(data, jax_forest, engine, probes):
    _, q = data
    jidx = _with_engine(jax_forest, engine)
    tidx = _carry(jax_forest, engine)
    if probes is None:  # the deficit rule is engaged, at the same depth
        assert tidx._auto_probes(10) == jidx._auto_probes(10) > 1
    _match(tidx.search_batch(q, 10, probes_per_tree=probes),
           jidx.search_batch(q, 10, probes_per_tree=probes))


@pytest.mark.parametrize("probes", [None, 2])
def test_search_batch_large_k_takes_counted_plain_route(data, jax_forest,
                                                        probes):
    _, q = data
    before = cuda_binned.LARGE_K_PLAIN
    got = _carry(jax_forest).search_batch(q[:30], 130, probes_per_tree=probes)
    assert cuda_binned.LARGE_K_PLAIN == before + TREES  # one scan a tree
    _match(got, _with_engine(jax_forest, "xla").search_batch(
        q[:30], 130, probes_per_tree=probes))


def test_unknown_engine_raises(data, jax_forest):
    with pytest.raises(ValueError, match="engine"):
        _carry(jax_forest, "nope").search_batch(data[1][:4], 5)


def test_search_batch_device_maps_external_ids(data, jax_forest):
    _, q = data
    tidx = _carry(jax_forest)
    dists, ext = tidx.search_batch_device(torch.from_numpy(q), 10)
    assert ext.dtype == torch.int32 and dists.dtype == torch.float32
    want = tidx.search_batch(q, 10)
    np.testing.assert_array_equal(ext.numpy(), want.ids)
    np.testing.assert_array_equal(dists.numpy(), want.distances)
    assert (want.ids[want.ids >= 0] % 2 == 1).all()  # external, not rows
    big = ANNIndex.from_numpy(
        jax_forest.max_node_size, jax_forest._trees, jax_forest._values,
        jax_forest._ids + 2**31, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        big.search_batch_device(q[:4], 5)
    assert (big.search_batch(q[:4], 5).ids >= 2**31).all()


@pytest.mark.parametrize("ids", [[], [0, 5, 2**31 - 1], [-(2**31), 7],
                                 [2**31], [-(2**31) - 1, 3]])
def test_device_id_map_matches_jax(ids):
    ids = np.asarray(ids, np.int64)
    want = vers_tpu.core.device_id_map(ids)
    got = device_id_map(ids, "cpu")
    if want is None:
        assert got is None
    else:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_search_approximate_matches_jax(data, jax_forest):
    _, q = data
    tidx = _carry(jax_forest)
    for i in range(8):
        assert tidx.search_approximate(q[i], 10) == jax_forest.search_approximate(
            q[i], 10)
    # more than one leaf can give: the deficit rule walks backup branches
    assert len(tidx.search_approximate(q[0], 60)) == 60
    assert tidx.search_approximate(q[0], 60) == jax_forest.search_approximate(
        q[0], 60)


def _assert_trees_equal(ttree, jtree):
    for name in ("coeff", "const", "split", "bucket", "leaf_of_vec"):
        np.testing.assert_array_equal(getattr(ttree, name),
                                      getattr(jtree, name), err_msg=name)
    assert ttree.num_buckets == jtree.num_buckets
    assert ttree.members == [list(map(int, m)) for m in jtree.members]


def test_add_with_leaf_split_matches_jax():
    """The same adds overflow the same leaves in both packages and
    `_split_leaf` grafts the same subtrees (numpy draws from one seed
    tuple); every other leaf is untouched."""
    rng = np.random.default_rng(33)
    x = rng.normal(size=(60, 8)).astype(np.float32)
    jidx = JaxANNIndex.build_index(2, 6, x, np.arange(60))
    tidx = ANNIndex.from_numpy(6, jidx._trees, jidx._values, jidx._ids,
                               device="cpu")
    splits = 0
    for i in range(25):
        emb = (x[3] + 0.05 * rng.normal(size=8)).astype(np.float32)
        before = [([list(m) for m in t.members],
                   tidx._descend_host_pos(t, emb)) for t in tidx._trees]
        jidx.add(emb, 100 + i)
        tidx.add(emb, 100 + i)
        assert not tidx._dirty_trees and not jidx._dirty_trees
        # the kept leaf sizes follow the trees
        assert tidx._max_bin() == jidx._max_bin()
        assert tidx._auto_probes(5) == jidx._auto_probes(5)
        for ttree, jtree, (members, (b, _, _, on_path)) in zip(
                tidx._trees, jidx._trees, before):
            assert on_path
            _assert_trees_equal(ttree, jtree)
            splits += len(members[b]) + 1 > 6
            for other, mem in enumerate(members):
                if other != b:
                    assert ttree.members[other] == mem
    assert splits >= 4  # the adds really overflowed leaves
    np.testing.assert_array_equal(tidx._values, jidx._values)
    np.testing.assert_array_equal(tidx._ids, jidx._ids)
    assert tidx._values.shape == (85, 8)
    q = x[:10]
    _match(tidx.search_batch(q, 5), jidx.search_batch(q, 5))
    got = tidx.search_batch(tidx._values[60:], 1)
    assert (got.distances[:, 0] < 1e-4).all() and (got.ids[:, 0] >= 100).all()
    for i in range(4):
        assert tidx.search_approximate(q[i], 5) == jidx.search_approximate(q[i], 5)


def test_members_from_one_sort_match_the_row_loop():
    rng = np.random.default_rng(2)
    lov = rng.integers(-1, 9, size=500).astype(np.int32)
    lov[lov == 4] = 5  # an empty leaf
    tree = _Tree(np.zeros((1, 1, 2)), np.zeros((1, 1)), np.zeros((1, 2)),
                 np.zeros((1, 2)), lov, 9)
    want = [[] for _ in range(9)]
    for i, b in enumerate(lov):
        if b >= 0:
            want[int(b)].append(i)
    assert tree.members == want and tree.members[4] == []
    assert all(type(i) is int for m in tree.members for i in m)


def _bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def test_bincode_files_are_byte_identical_both_ways(tmp_path, data, jax_forest):
    _, q = data
    a, b, c = (str(tmp_path / n) for n in ("jax.index", "torch.index", "re.index"))
    jax_forest.save_index(a)
    _carry(jax_forest).save_index(b)
    assert _bytes(a) == _bytes(b)
    loaded = ANNIndex.load_index(a, device="cpu")  # dim inferred
    assert loaded.dim == D and loaded.max_node_size == MAX_SIZE
    loaded.save_index(c)
    assert _bytes(c) == _bytes(a)
    back = JaxANNIndex.load_index(b)
    for ttree, jtree in zip(loaded._trees, back._trees):
        _assert_trees_equal(ttree, jtree)
    _match(loaded.search_batch(q, 10), jax_forest.search_batch(q, 10))
    assert loaded.search_approximate(q[0], 10) == jax_forest.search_approximate(
        q[0], 10)
    # grafted subtrees go through the recursive Node format too
    tidx = _carry(jax_forest)
    rng = np.random.default_rng(5)
    for i in range(30):
        emb = (q[0] + 0.01 * rng.normal(size=D)).astype(np.float32)
        tidx.add(emb, 9000 + i)
    tidx.save_index(b)
    re = ANNIndex.load_index(b, dim=D, device="cpu")
    assert len(re._values) == N + 30
    for t1, t2 in zip(tidx._trees, re._trees):
        assert sorted(map(tuple, t1.members)) == sorted(map(tuple, t2.members))
    assert re.search_approximate(q[1], 5) == tidx.search_approximate(q[1], 5)
    re.save_index(c)
    assert _bytes(c) == _bytes(b)


def test_deep_degenerate_tree_codec_and_query(tmp_path):
    """A 5000-deep single-chain tree: the iterative writer and parser
    round-trip it byte-identically under a strict recursion limit, and
    both packages read it alike."""
    dim, depth = 4, 5000
    n = depth + 1  # one member per leaf
    p = str(tmp_path / "deep.index")
    values = np.random.default_rng(3).normal(size=(n, dim)).astype(np.float32)
    with open(p, "wb") as fp:
        w = Writer(fp)
        w.u64(1)  # max_node_size
        w.u64(1)  # num_trees
        for i in range(depth):
            w.u32(0)  # Inner
            w.f32_array(np.full((dim,), 1.0, np.float32))
            w.f32(-0.5)
            w.u32(1)  # left = Leaf{[i]}; the right child continues the chain
            w.vec_u64(np.asarray([i], np.uint64))
        w.u32(1)  # final right = Leaf{[depth]}
        w.vec_u64(np.asarray([depth], np.uint64))
        w.vec_f32_matrix(values)
        w.vec_u64(np.arange(n, dtype=np.uint64))

    limit = sys.getrecursionlimit()
    try:
        sys.setrecursionlimit(900)
        idx = ANNIndex.load_index(p, device="cpu")  # dim inferred
        assert idx.dim == dim
        p2 = str(tmp_path / "deep_rt.index")
        idx.save_index(p2)
        assert _bytes(p) == _bytes(p2)
        res = idx.search_approximate(values[0], 3)
    finally:
        sys.setrecursionlimit(limit)
    jidx = JaxANNIndex.load_index(p)
    assert res == jidx.search_approximate(values[0], 3) and res[0][0] == 0
    _assert_trees_equal(idx._trees[0], jidx._trees[0])


def test_build_index_on_the_cpu(data):
    """The port's own build (its generator's draws): duplicates dropped,
    every row in one leaf of every tree, a stored row finds itself, and
    the seed fixes the forest."""
    x, q = data
    xd = np.concatenate([x, x[:5]])
    idx = ANNIndex.build_index(4, 40, xd, np.arange(N + 5), device="cpu")
    assert idx.device.type == "cpu" and idx._values.shape == (N, D)
    assert idx.config == vers_tpu_torch.LSHConfig(num_trees=4, max_node_size=40)
    assert set(idx.build_seconds) == {"dedup_host", "trees_device", "tables_host"}
    for tree in idx._trees:
        assert (tree.leaf_of_vec >= 0).all()
        sizes = [len(m) for m in tree.members]
        assert sum(sizes) == N and max(sizes) < 40 and min(sizes) > 0
    assert len({tuple(t.leaf_of_vec) for t in idx._trees}) == 4  # trees differ
    again = ANNIndex.build_index(4, 40, xd, np.arange(N + 5), device="cpu")
    for t1, t2 in zip(idx._trees, again._trees):
        _assert_trees_equal(t1, t2)
    res = idx.search_batch(x[:64], 10)
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(64))
    truth = vers_tpu_torch.FlatIndex(x, device="cpu").search_batch(q, 10).ids
    r1 = vers_tpu_torch.recall_at_k(idx.search_batch(q, 10, 1).ids, truth)
    r4 = vers_tpu_torch.recall_at_k(idx.search_batch(q, 10, 4).ids, truth)
    assert r4 > r1 > 0.3, (r1, r4)
    with pytest.raises(ValueError, match="max_node_size"):
        ANNIndex.build_index(2, 1, x, np.arange(N), device="cpu")


def test_rebuild_of_a_dirty_tree(data):
    x, _ = data
    idx = ANNIndex.build_index(2, 40, x[:500], np.arange(500), device="cpu")
    idx.search_batch(x[:4], 3)
    corpus = idx._shared["corpus_pad"]
    idx._dirty_trees.add(1)
    kept = idx._trees[0]
    res = idx.search_batch(x[:32], 3)
    assert not idx._dirty_trees and idx._trees[0] is kept
    assert idx._shared["corpus_pad"] is corpus  # the upload is kept
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(32))
    assert sum(len(m) for m in idx._trees[1].members) == 500


def test_entry_points_without_device_raise_without_a_card(monkeypatch, tmp_path,
                                                          data, jax_forest):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = data
    p = str(tmp_path / "f.index")
    jax_forest.save_index(p)
    for call in (
        lambda: ANNIndex.build_index(2, 40, x, np.arange(N)),
        lambda: ANNIndex.from_numpy(MAX_SIZE, jax_forest._trees,
                                    jax_forest._values, jax_forest._ids),
        lambda: ANNIndex.load_index(p),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_exports():
    assert vers_tpu_torch.ANNIndex is ANNIndex
    assert {"ANNIndex", "LSHConfig"} <= set(vers_tpu_torch.__all__)
