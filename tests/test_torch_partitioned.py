"""The port's corpus-partitioned indexes against ``vers_tpu.parallel``'s
on the CPU: ``PartitionedANNIndex`` (one forest a shard) over 8 shards
and ``PartitionedHNSWIndex`` (one subgraph a shard) over 4, the JAX
side on ``tests/conftest.py``'s virtual devices, the port on
``make_mesh(n, device="cpu")``.

The forests are carried over shard by shard from the JAX index
(``ANNIndex.from_numpy``); the HNSW subgraphs come from the host build
(``batched=False``), which gives the same graphs in both packages. For
the in-place cache patch, both packages' host-built shards get the same
array graph (the form a wave build leaves), so that ``add`` takes the
device fast path. Ids must be equal up to swaps between equal
distances; distances within 1e-4 on unit rows, scaled to |x|^2 on the
forest's unnormalized corpus (ROADMAP 3.3); files byte-identical both
ways.
"""

import pathlib

import numpy as np
import pytest
import torch

from vers_tpu.index.hnsw import _Layer as JaxLayer
from vers_tpu.index.lsh import ANNIndex as JaxANN
from vers_tpu.parallel.hnsw_partitioned import (
    PartitionedHNSWIndex as JaxPartHNSW,
)
from vers_tpu.parallel.lsh_partitioned import PartitionedANNIndex as JaxPartANN
from vers_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vers_tpu.utils.harness import exhaustive_batch
from vers_tpu_torch.index.hnsw import HNSWIndex, _Layer
from vers_tpu_torch.index.lsh import ANNIndex
from vers_tpu_torch.ops import beam, binned
from vers_tpu_torch.parallel import (
    PartitionedANNIndex,
    PartitionedHNSWIndex,
    make_mesh,
)
from vers_tpu_torch.utils.harness import recall_at_k
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

TOL = 1e-4


def _same(got, want, atol=TOL):
    assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                      rtol=0.0, atol=atol)


def _files(base):
    p = pathlib.Path(base)
    return {f.name[len(p.name):]: f.read_bytes()
            for f in sorted(p.parent.glob(p.name + "*"))}


def _assert_same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert fa.keys() == fb.keys() and ".manifest.json" in fa and ".ids" in fa
    for suffix in fa:
        assert fa[suffix] == fb[suffix], suffix


# -- PartitionedANNIndex ----------------------------------------------------


def _port_forests(j, tmesh):
    shards = [ANNIndex.from_numpy(s.max_node_size, s._trees, s._values,
                                  s._ids, device=dev)
              for s, dev in zip(j.shards, tmesh.devices)]
    return PartitionedANNIndex(shards, gids=[g.copy() for g in j.gids],
                               mesh=tmesh)


@pytest.fixture(scope="module")
def forest():
    rng = np.random.default_rng(12)
    centers = rng.normal(size=(40, 20)).astype(np.float32) * 3
    assign = rng.integers(0, 40, size=1600)
    x = (centers[assign] + rng.normal(size=(1600, 20)) * 0.4).astype(np.float32)
    jmesh, tmesh = jax_make_mesh(8), make_mesh(8, device="cpu")
    j = JaxPartANN.build_index(4, 32, x, mesh=jmesh)
    tol = max(TOL, 8 * np.finfo(np.float32).eps * float((x * x).sum(1).max()))
    return dict(x=x, jax=j, port=_port_forests(j, tmesh), jmesh=jmesh,
                tmesh=tmesh, tol=tol)


@pytest.mark.parametrize("probes", [None, 1, 2])
def test_forest_search_matches_jax(forest, probes):
    q = forest["x"][:64]
    with binned.captured_scans() as calls:
        res = forest["port"].search_batch(q, 10, probes_per_tree=probes)
    assert len(calls) == 8 * 4  # a packed scan per shard and tree
    _same(res, forest["jax"].search_batch(q, 10, probes_per_tree=probes),
          forest["tol"])


def test_forest_capacity_partitioned(forest):
    t = forest["port"]
    t.search_batch(forest["x"][:4], 3)
    cache = t._ensure_device_cache()
    # each shard holds its ~n/S rows once (128-row padded), not a replica
    assert cache["pern"] <= -(-1600 // 8 // 128) * 128
    assert cache["pern"] == forest["jax"]._ensure_device_cache()["pern"]
    assert all(len(s._ids) == 200 for s in t.shards)
    assert {s._shared["corpus_pad"].shape[0] for s in t.shards} == {256}
    np.testing.assert_array_equal(
        cache["row_to_gid"], forest["jax"]._ensure_device_cache()["row_to_gid"])


def test_forest_recall_vs_single_forest(forest):
    x = forest["x"]
    q = x[:128]
    truth = exhaustive_batch(x, q, 10)
    rec_part = recall_at_k(forest["port"].search_batch(q, 10).ids, truth)
    jsingle = JaxANN.build_index(4, 32, x, np.arange(len(x)))
    single = ANNIndex.from_numpy(32, jsingle._trees, jsingle._values,
                                 jsingle._ids, device="cpu")
    rec_single = recall_at_k(single.search_batch(q, 10).ids, truth)
    assert rec_part >= rec_single - 0.01, (rec_part, rec_single)
    assert rec_part > 0.7, rec_part


def test_forest_multiprobe_and_device_ids(forest):
    x, t = forest["x"], forest["port"]
    q = x[:32]
    res1 = t.search_batch(q, 5, probes_per_tree=1)
    res2 = t.search_batch(q, 5, probes_per_tree=2)
    assert (res1.ids[:, 0] == np.arange(32)).all()  # self-hit
    truth = exhaustive_batch(x, q, 5)
    assert recall_at_k(res2.ids, truth) >= recall_at_k(res1.ids, truth)
    d, dev_ids = t.search_batch_device(q, 5)
    assert dev_ids.dtype == torch.int32
    _, jdev = forest["jax"].search_batch_device(q, 5)
    np.testing.assert_array_equal(dev_ids.numpy()[:, 0], np.asarray(jdev)[:, 0])
    np.testing.assert_array_equal(dev_ids.numpy(), t.search_batch(q, 5).ids)


def test_forest_single_query_parity_path(forest):
    x = forest["x"]
    res = forest["port"].search_approximate(x[3], 10)
    assert len(res) == 10 and res[0][0] == 3
    assert res[0][1] == pytest.approx(0.0, abs=1e-4)
    want = forest["jax"].search_approximate(x[3], 10)
    assert [i for i, _ in res] == [i for i, _ in want]
    np.testing.assert_allclose([d for _, d in res], [d for _, d in want],
                               rtol=0.0, atol=1e-5)


def test_forest_roundtrip_and_add(tmp_path, forest):
    x, jmesh, tmesh = forest["x"], forest["jmesh"], forest["tmesh"]
    j = JaxPartANN.build_index(4, 32, x[:800], mesh=jmesh)
    t = _port_forests(j, tmesh)
    tb, jb = str(tmp_path / "port"), str(tmp_path / "jax")
    t.save_index(tb)
    j.save_index(jb)
    _assert_same_files(tb, jb)
    re = PartitionedANNIndex.load_index(jb, mesh=tmesh)
    jre = JaxPartANN.load_index(tb, mesh=jmesh)
    q = x[:16]
    np.testing.assert_array_equal(t.search_batch(q, 5).ids,
                                  re.search_batch(q, 5).ids)
    _same(re.search_batch(q, 5), jre.search_batch(q, 5), forest["tol"])
    # shard files are standard single-file layouts
    assert ANNIndex.load_index(tb + ".shard0", device="cpu").dim == 20
    with pytest.raises(ValueError, match="manifest format"):
        PartitionedHNSWIndex.load_index(tb, mesh=tmesh)
    # add routes to the emptiest shard and is findable, in both
    probe = x[900]
    re.add(probe, 777_000)
    jre.add(probe, 777_000)
    assert [len(g) for g in re.gids] == [len(g) for g in jre.gids]
    res = re.search_batch(probe[None], 3)
    assert res.ids[0, 0] == 777_000
    _same(res, jre.search_batch(probe[None], 3), forest["tol"])


def test_forest_external_ids_and_int32_guard(forest):
    x, jmesh, tmesh = forest["x"], forest["jmesh"], forest["tmesh"]
    ids = np.arange(800, dtype=np.int64) * 3 + 5_000_000
    j = JaxPartANN.build_index(4, 32, x[:800], vector_ids=ids, mesh=jmesh)
    t = _port_forests(j, tmesh)
    res = t.search_batch(x[:20], 5)
    assert (res.ids[:, 0] == ids[:20]).all()
    _same(res, j.search_batch(x[:20], 5), forest["tol"])
    big = PartitionedANNIndex(t.shards, gids=[g + 2**40 for g in t.gids],
                              mesh=tmesh)
    with pytest.raises(ValueError, match="int32"):
        big.search_batch_device(x[:2], 3)
    assert (big.search_batch(x[:2], 3).ids[:, 0] == ids[:2] + 2**40).all()


def test_forest_build_on_mesh(forest):
    x, tmesh = forest["x"], forest["tmesh"]
    t = PartitionedANNIndex.build_index(3, 32, x[:403], mesh=tmesh)
    assert [len(s._ids) for s in t.shards] == [51] * 7 + [46]
    assert all(s.device == torch.device("cpu") for s in t.shards)
    res = t.search_batch(x[:20], 3)
    assert (res.ids[:, 0] == np.arange(20)).all()
    with pytest.raises(ValueError, match="cannot partition"):
        PartitionedANNIndex.build_index(3, 32, x[:5], mesh=tmesh)


# -- PartitionedHNSWIndex ------------------------------------------------------


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def graphs():
    y = _normed(np.random.default_rng(5), 1200, 24)
    jmesh, tmesh = jax_make_mesh(4), make_mesh(4, device="cpu")
    j = JaxPartHNSW.build_index(3, 16, 16, 6, y[:800], mesh=jmesh,
                                batched=False)
    t = PartitionedHNSWIndex.build_index(3, 16, 16, 6, y[:800], mesh=tmesh,
                                         batched=False)
    return dict(y=y, jax=j, port=t, jmesh=jmesh, tmesh=tmesh)


def test_hnsw_graphs_identical(graphs):
    j, t = graphs["jax"], graphs["port"]
    assert t.get_num_nodes_in_layers() == j.get_num_nodes_in_layers()
    for js, ts in zip(j.shards, t.shards):
        assert ts.device == torch.device("cpu")
        for lj, lt in zip(js.layers, ts.layers):
            assert list(lj.adjacency) == list(lt.adjacency)
            for nid, item in lj.adjacency.items():
                assert item.neighbours == lt.adjacency[nid].neighbours


def test_hnsw_search_matches_jax(graphs):
    q = graphs["y"][:64]
    scans = []
    real = beam.route_scan

    def counting(*a, **k):
        scans.append(a[1].shape)
        return real(*a, **k)

    beam.route_scan = counting
    try:
        res = graphs["port"].search_batch(q, 10)
    finally:
        beam.route_scan = real
    assert len(scans) == 4  # one routing scan a shard
    _same(res, graphs["jax"].search_batch(q, 10))
    d, dev_ids = graphs["port"].search_batch_device(q, 10)
    assert dev_ids.dtype == torch.int32
    np.testing.assert_array_equal(dev_ids.numpy(), res.ids)


def test_hnsw_capacity_partitioned(graphs):
    t = graphs["port"]
    cache = t._ensure_device_cache()
    jcache = graphs["jax"]._ensure_device_cache()
    per = cache["per"]
    assert per == jcache["per"] and cache["n1_pad"] == jcache["n1_pad"]
    n_s = 800 // 4
    assert per <= n_s + max(64, n_s // 8) + 8
    for name in ("vecs", "vecs_nav", "adj0"):
        assert len(cache[name]) == 4
        assert {tuple(a.shape)[0] for a in cache[name]} == {per}
    assert cache["adj0"][0].shape[1] == jcache["adj0"].shape[1]
    assert all(s._rows_used == 200 for s in t.shards)
    np.testing.assert_array_equal(cache["n1s"], np.asarray(jcache["n1s"]))
    assert (cache["n1s"] > 0).all()
    np.testing.assert_array_equal(cache["row_to_gid"], jcache["row_to_gid"])


def test_hnsw_recall_vs_single_graph(graphs):
    y = graphs["y"][:800]
    q = y[:128]
    truth = exhaustive_batch(y, q, 10)
    rec_part = recall_at_k(graphs["port"].search_batch(q, 10).ids, truth)
    single = HNSWIndex.build_index(3, 16, 16, 6, y, device="cpu")
    rec_single = recall_at_k(single.search_batch(q, 10).ids, truth)
    assert rec_part >= rec_single - 0.01, (rec_part, rec_single)
    assert rec_part > 0.9, rec_part


def test_hnsw_single_query_parity_path(graphs):
    y = graphs["y"]
    res = graphs["port"].search_approximate(y[7], 10)
    assert len(res) == 10 and res[0][0] == 7
    assert res[0][1] == pytest.approx(0.0, abs=1e-5)
    want = graphs["jax"].search_approximate(y[7], 10)
    assert [i for i, _ in res] == [i for i, _ in want]


def test_hnsw_roundtrip(tmp_path, graphs):
    t, j, tmesh = graphs["port"], graphs["jax"], graphs["tmesh"]
    tb, jb = str(tmp_path / "port"), str(tmp_path / "jax")
    t.save_index(tb)
    j.save_index(jb)
    _assert_same_files(tb, jb)
    re = PartitionedHNSWIndex.load_index(jb, mesh=tmesh)
    jre = JaxPartHNSW.load_index(tb, mesh=graphs["jmesh"])
    q = graphs["y"][:16]
    a, b = t.search_batch(q, 5), re.search_batch(q, 5)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-5, atol=1e-6)
    _same(b, jre.search_batch(q, 5))
    # shard files are standard single-file HNSW layouts
    assert HNSWIndex.load_index(tb + ".shard0", device="cpu").dim == 24
    with pytest.raises(ValueError, match="shards for a 8-device mesh"):
        PartitionedHNSWIndex.load_index(tb, mesh=make_mesh(8, device="cpu"))


def test_hnsw_add_routes_to_emptiest_shard(graphs):
    y, jmesh, tmesh = graphs["y"], graphs["jmesh"], graphs["tmesh"]
    j = JaxPartHNSW.build_index(3, 16, 16, 6, y[:803], mesh=jmesh,
                                batched=False)
    t = PartitionedHNSWIndex.build_index(3, 16, 16, 6, y[:803], mesh=tmesh,
                                         batched=False)
    t.search_batch(y[:2], 3)  # the assembled cache, dropped by the add
    sizes_before = [s._rows_used for s in t.shards]
    probe = y[900]
    j.add(probe, 4321)
    t.add(probe, 4321)
    sizes_after = [s._rows_used for s in t.shards]
    assert sum(sizes_after) == sum(sizes_before) + 1
    assert sizes_after[3] == sizes_before[3] + 1  # the short last shard
    assert t._device_cache is None  # host path: re-assembled lazily
    res = t.search_batch(probe[None], 3)
    assert res.ids[0, 0] == 4321  # the new vector is its own NN
    _same(res, j.search_batch(probe[None], 3))
    _same(t.search_batch(y[:20], 5), j.search_batch(y[:20], 5))


def test_hnsw_external_ids_and_int32_guard(graphs):
    y, jmesh, tmesh = graphs["y"], graphs["jmesh"], graphs["tmesh"]
    ids = np.arange(800, dtype=np.int64) * 7 + 1_000_000
    j = JaxPartHNSW.build_index(3, 16, 16, 6, y[:800], vector_ids=ids,
                                mesh=jmesh, batched=False)
    t = PartitionedHNSWIndex(graphs["port"].shards, gids=[
        ids[s * 200 : (s + 1) * 200] for s in range(4)], mesh=tmesh)
    res = t.search_batch(y[:20], 5)
    assert (res.ids[:, 0] == ids[:20]).all()
    _same(res, j.search_batch(y[:20], 5))
    _, dev_ids = t.search_batch_device(y[:20], 5)
    assert (dev_ids.numpy()[:, 0] == ids[:20]).all()
    big = PartitionedHNSWIndex(graphs["port"].shards,
                               gids=[g + 2**40 for g in t.gids], mesh=tmesh)
    with pytest.raises(ValueError, match="int32"):
        big.search_batch_device(y[:2], 3)
    assert (big.search_batch(y[:2], 3).ids[:, 0] == ids[:2] + 2**40).all()


def _as_array_graph(shard, layer_cls):
    """Give a host-built shard the per-layer (members, adj, dist) array
    graph a wave build leaves (neighbours ascending, f32 cosine
    distances), so that ``add`` takes the device fast path."""
    pending = []
    for layer in shard.layers:
        mem = np.fromiter(layer.adjacency, np.int64, len(layer.adjacency))
        width = max((len(a.neighbours) for a in layer.adjacency.values()),
                    default=1)
        adj = np.full((len(mem), width), -1, np.int32)
        dist = np.full((len(mem), width), np.inf, np.float32)
        for i, nid in enumerate(mem):
            nb = np.asarray(sorted(layer.adjacency[int(nid)].neighbours),
                            np.int64)
            adj[i, : len(nb)] = nb
            dist[i, : len(nb)] = 1.0 - shard._vecs[nb] @ shard._vecs[int(nid)]
        pending.append((mem, adj, dist))
    shard._pending_graph = pending
    shard.layers = [layer_cls() for _ in shard.layers]
    shard._device_cache = None


def test_hnsw_add_patches_device_cache_in_place(graphs):
    """An insert on array-graph shards patches the assembled cache in
    place (row writes), in both packages, and the patched caches answer
    as the JAX package's."""
    y, jmesh, tmesh = graphs["y"], graphs["jmesh"], graphs["tmesh"]
    j = JaxPartHNSW.build_index(3, 16, 16, 6, y[:800], mesh=jmesh,
                                batched=False)
    t = PartitionedHNSWIndex.build_index(3, 16, 16, 6, y[:800], mesh=tmesh,
                                         batched=False)
    for js, ts in zip(j.shards, t.shards):
        _as_array_graph(js, JaxLayer)
        _as_array_graph(ts, _Layer)
    j.search_batch(y[:4], 3)
    t.search_batch(y[:4], 3)
    jcache, tcache = j._device_cache, t._device_cache
    for i in range(3):
        probe = y[1000 + i] + 0.3 * np.random.default_rng(17 + i).normal(size=24)
        probe = (probe / np.linalg.norm(probe)).astype(np.float32)
        j.add(probe, 99_000 + i)
        t.add(probe, 99_000 + i)
        assert j._device_cache is jcache  # patched, not rebuilt
        assert t._device_cache is tcache
        res = t.search_batch(probe[None], 3)
        assert res.ids[0, 0] == 99_000 + i  # the new vector is its own NN
        assert res.distances[0, 0] == pytest.approx(0.0, abs=1e-4)
    np.testing.assert_array_equal(tcache["n1s"], np.asarray(jcache["n1s"]))
    np.testing.assert_array_equal(tcache["row_to_gid"], jcache["row_to_gid"])
    q = y[:64]
    res = t.search_batch(q, 10)
    _same(res, j.search_batch(q, 10))
    assert recall_at_k(res.ids, exhaustive_batch(y[:800], q, 10)) > 0.9
    assert t.search_approximate(probe, 3)[0][0] == 99_002


def test_hnsw_batched_build_on_mesh(graphs):
    y, tmesh = graphs["y"], graphs["tmesh"]
    t = PartitionedHNSWIndex.build_index(3, 16, 16, 6, y[:400], mesh=tmesh,
                                         seed=2)
    for s, shard in enumerate(t.shards):
        assert shard.device == torch.device("cpu")
        assert shard._pending_graph is not None
        assert shard.build_seconds["wave_cap"] == 12  # min(1024, max(8, 100 // 8))
        assert shard.config.seed == 2 + s
    q = y[:32]
    assert recall_at_k(t.search_batch(q, 5).ids,
                       exhaustive_batch(y[:400], q, 5)) > 0.9
