"""HNSW's int8 navigation table (``HNSWConfig(nav_dtype="int8")``) in the
port against ``vers_tpu`` on the CPU:

- the int8 rows and their f32 scales equal the JAX package's bit for
  bit (a wave-built index, and a small host-built one with unnormalized
  rows and zero padding rows);
- ``beam_search_layer`` on the int8 table with its scales: ids equal up
  to near-ties of int8 nav distances (traced), distances within 1e-5;
- ``search_batch`` / ``search_batch_device`` with ``nav_dtype="int8"``,
  ``nav_inline_dp=None`` under both routers: ids traced as above,
  f32-rescored distances within 1e-5;
- ``add`` on the int8 cache (the device fast path, growing the tables):
  the new row's int8 values and scale, the pending graph and the patch
  equal the reference's;
- the inline table turns int8 into bf16 in both packages;
- ``ShardedHNSWIndex`` over the int8 index equal to its single-device
  beam route and to the JAX package's sharded search.

The JAX wave build runs once, in a module fixture."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vers_tpu.config import HNSWConfig as JaxConfig
from vers_tpu.index.hnsw import HNSWIndex as JaxHNSW
from vers_tpu.ops import beam as jbeam
from vers_tpu.parallel.hnsw import ShardedHNSWIndex as JaxShardedHNSW
from vers_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vers_tpu_torch.config import HNSWConfig
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.ops import beam
from vers_tpu_torch.parallel import ShardedHNSWIndex, make_mesh
from vers_tpu_torch.utils.harness import recall_at_k

torch.set_num_threads(2)

TOL = 1e-5
GAP = 1e-6
ARGS = (4, 48, 32, 8)  # num_layers, ef_construction, ef_search, M
INT8 = dict(nav_dtype="int8", nav_inline_dp=None)


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cfg(cls, **kw):
    return cls(num_layers=4, ef_construction=48, ef_search=32, num_neighbours=8,
               **kw)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(31)
    x = _normed(rng, 600, 40)
    q = _normed(rng, 48, 40)
    extra = _normed(rng, 3, 40)
    j = JaxHNSW.build_index_batched(*ARGS, x, wave_cap=128)
    return dict(x=x, q=q, extra=extra, jax=j)


def _jax_int8(pair, **kw):
    j = copy.deepcopy(pair["jax"])
    j.config, j._device_cache = _cfg(JaxConfig, **INT8, **kw), None
    return j


def _port_int8(pair, **kw):
    return HNSWIndex.from_numpy(pair["x"], pair["jax"]._pending_graph, 48, 32,
                                4, 8, config=_cfg(HNSWConfig, **INT8, **kw),
                                device="cpu")


def _int8_dist(cache, ids, q):
    """f64 int8 nav distances of the query ``q`` to ``ids``: the rows
    widened and scaled, the query rounded to bf16."""
    v = cache["vecs_nav"].double().numpy()[np.asarray(ids)]
    s = cache["nav_scales"].double().numpy()[np.asarray(ids)]
    qb = torch.from_numpy(np.asarray(q, np.float32)).to(torch.bfloat16)
    return 1.0 - (v @ qb.double().numpy()) * s


def _assert_traced(cache, q, got_i, want_i):
    """Rows whose live id sets differ: among the int8 nav distances of
    the ids of both results, the differing ids sit within GAP of
    another (a near-tie flipped one decision). Returns their count."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    n_diff = 0
    for r in range(got_i.shape[0]):
        a = {int(i) for i in got_i[r] if i >= 0}
        b = {int(i) for i in want_i[r] if i >= 0}
        if a == b:
            continue
        n_diff += 1
        d = np.sort(_int8_dist(cache, sorted(a | b), q[r]))
        assert np.diff(d).min() < GAP, (r, sorted(a - b), sorted(b - a))
    return n_diff


def test_int8_table_matches_jax(pair):
    t = _port_int8(pair)
    tc = t._ensure_device_cache()
    jc = _jax_int8(pair)._ensure_device_cache()
    assert tc["vecs_nav"].dtype == torch.int8
    assert tc["nav_scales"].dtype == torch.float32
    assert np.array_equal(tc["vecs_nav"].numpy(), np.asarray(jc["vecs_nav"]))
    assert np.array_equal(tc["nav_scales"].numpy(), np.asarray(jc["nav_scales"]))
    assert tc["nav_scales"].shape == (tc["vecs"].shape[0],)


def test_int8_table_matches_jax_unnormalized():
    # a host-built index (the same graph in both packages) over rows of
    # spread norms; 101 rows pad to 104, so three zero rows are quantized
    rng = np.random.default_rng(4)
    x = rng.normal(size=(101, 12)).astype(np.float32)
    x *= rng.uniform(0.01, 50.0, size=(101, 1)).astype(np.float32)
    x[7] = 0.0
    cfg = dict(num_layers=3, ef_construction=16, ef_search=8, num_neighbours=4,
               nav_dtype="int8", nav_inline_dp=None)
    j = JaxHNSW.build_index(3, 16, 8, 4, x)
    j.config, j._device_cache = JaxConfig(**cfg), None
    t = HNSWIndex.build_index(3, 16, 8, 4, x, device="cpu")
    t.config, t._device_cache = HNSWConfig(**cfg), None
    jc, tc = j._ensure_device_cache(), t._ensure_device_cache()
    assert tc["vecs_nav"].shape == (104, 12)
    assert not tc["vecs_nav"][101:].any() and not tc["vecs_nav"][7].any()
    assert np.array_equal(tc["vecs_nav"].numpy(), np.asarray(jc["vecs_nav"]))
    assert np.array_equal(tc["nav_scales"].numpy(), np.asarray(jc["nav_scales"]))


@pytest.mark.parametrize("ef,expand,seeds", [(16, 4, 1), (32, 8, 3), (24, 1, 1)])
def test_beam_search_layer_int8_matches(pair, ef, expand, seeds):
    jc = _jax_int8(pair)._ensure_device_cache()
    t = _port_int8(pair)
    tc = t._ensure_device_cache()
    q = pair["q"]
    rng = np.random.default_rng(ef + seeds)
    entry = np.stack([rng.choice(600, seeds, replace=False)
                      for _ in range(q.shape[0])]).astype(np.int32)
    want_d, want_i = jbeam.beam_search_layer(
        jnp.asarray(q), jc["vecs_nav"], jc["adjs"][0], jnp.asarray(entry),
        ef=ef, max_steps=64, expand_per_step=expand, scales=jc["nav_scales"])
    got_d, got_i = beam.beam_search_layer(
        torch.from_numpy(q), tc["vecs_nav"], tc["adjs"][0],
        torch.from_numpy(entry), ef=ef, max_steps=64, expand_per_step=expand,
        scales=tc["nav_scales"])
    assert got_d.shape == (q.shape[0], ef)
    _assert_traced(tc, q, got_i, want_i)
    same = (got_i.numpy() == np.asarray(want_i)).all(axis=1)
    assert same.mean() > 0.9
    assert np.allclose(got_d.numpy()[same], np.asarray(want_d)[same],
                       rtol=0.0, atol=TOL)
    # the scales matter: without them the int8 dots rank otherwise
    unscaled, _ = beam.beam_search_layer(
        torch.from_numpy(q), tc["vecs_nav"], tc["adjs"][0],
        torch.from_numpy(entry), ef=ef, max_steps=64, expand_per_step=expand)
    assert not torch.allclose(unscaled, got_d)


def test_int8_dots_round_queries_to_bf16(pair):
    """The query is rounded to bf16, not to the table's int8."""
    tc = _port_int8(pair)._ensure_device_cache()
    q = torch.from_numpy(pair["q"][:4])
    ids = torch.arange(12).reshape(4, 3)
    got = beam.cosine_to(tc["vecs_nav"], ids, beam.nav_queries(q, tc["vecs_nav"]),
                         tc["nav_scales"])
    for r in range(4):
        want = _int8_dist(tc, ids[r].numpy(), q[r].numpy())
        assert np.allclose(got[r].numpy(), want, rtol=0.0, atol=1e-6)
    assert beam.nav_queries(q, tc["vecs_nav"]).dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [{}, dict(route_mode="beam"),
                                dict(route_seeds=3, beam_expand=4)])
def test_search_int8_matches(pair, kw):
    x, q = pair["x"], pair["q"]
    want = _jax_int8(pair, **kw).search_batch(q, 10)
    t = _port_int8(pair, **kw)
    got = t.search_batch(q, 10)
    cache = t._device_cache
    assert cache["vecs_nav"].dtype == torch.int8 and cache["inline"] is None
    _assert_traced(cache, q, got.ids, want.ids)
    same = (got.ids == want.ids).all(axis=1)
    assert same.mean() > 0.9
    # distances come from the f32 rescore
    assert np.allclose(got.distances[same], want.distances[same], rtol=0.0,
                       atol=TOL)
    d, i = t.search_batch_device(q, 10)
    assert i.dtype == torch.int32 and np.array_equal(i.numpy(), got.ids)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
    assert recall_at_k(got.ids, truth) > 0.85


def test_add_int8_matches(pair):
    j = _jax_int8(pair)
    t = _port_int8(pair)
    j.search_batch(pair["q"][:2], 5)  # build both caches before the adds
    t.search_batch(pair["q"][:2], 5)
    assert t._device_cache["vecs"].shape[0] == 600  # the first add grows it
    for k, v in enumerate(pair["extra"]):
        j.add(v, 600 + k)
        t.add(v, 600 + k)
        assert t._last_add_patch is not None
        assert t._last_add_patch["row"] == j._last_add_patch["row"] == 600 + k
        for r, row in j._last_add_patch["adj0"].items():
            assert np.array_equal(t._last_add_patch["adj0"][r], row), r
    jc, tc = j._device_cache, t._device_cache
    assert tc["vecs_nav"].shape[0] == 728 and tc["nav_scales"].shape[0] == 728
    assert np.array_equal(tc["vecs_nav"].numpy(), np.asarray(jc["vecs_nav"]))
    assert np.array_equal(tc["nav_scales"].numpy(), np.asarray(jc["nav_scales"]))
    for (mt, at, dt), (mj, aj, dj) in zip(t._pending_graph, j._pending_graph):
        assert np.array_equal(np.asarray(mt), np.asarray(mj))
        assert np.array_equal(at, aj)
        assert np.allclose(dt, dj, rtol=0.0, atol=1e-6)
    res = t.search_batch(pair["extra"], 1)
    assert list(res.ids[:, 0]) == [600, 601, 602]


def test_inline_table_turns_int8_into_bf16(pair):
    j = _jax_int8(pair)
    j.config = dataclasses.replace(j.config, nav_inline_dp=32)
    t = _port_int8(pair)
    t.config = dataclasses.replace(t.config, nav_inline_dp=32)
    jc, tc = j._ensure_device_cache(), t._ensure_device_cache()
    assert tc["inline"] is not None and jc["inline"] is not None
    assert tc["vecs_nav"].dtype == torch.bfloat16
    assert jc["vecs_nav"].dtype == jnp.bfloat16
    assert tc["nav_scales"] is None and jc["nav_scales"] is None
    # "auto" decides the same way at >= 200k rows under the scan router
    from vers_tpu_torch.index import hnsw as thnsw

    assert thnsw.auto_nav_policy(HNSWConfig(nav_dtype="int8"), 200_000,
                                 200_000) == (32, 64)


def test_sharded_int8_matches_single_and_jax(pair):
    q = pair["q"][:45]  # uneven over the shards
    t = _port_int8(pair, route_mode="beam")
    single = t.search_batch(q, 10)
    multi = ShardedHNSWIndex(t, mesh=make_mesh(4, device="cpu")).search_batch(q, 10)
    np.testing.assert_array_equal(multi.ids, single.ids)
    np.testing.assert_array_equal(multi.distances, single.distances)
    j = _jax_int8(pair)
    want = JaxShardedHNSW(j, mesh=jax_make_mesh(4)).search_batch(q, 10)
    _assert_traced(t._device_cache, q, multi.ids, want.ids)
    same = (multi.ids == want.ids).all(axis=1)
    assert same.mean() > 0.9
    assert np.allclose(multi.distances[same], want.distances[same], rtol=0.0,
                       atol=TOL)
