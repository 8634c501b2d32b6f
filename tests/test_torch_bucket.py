"""The flat approximate engines of vers_tpu_torch against vers_tpu: the
bucket scan (kernel D's plain version, then kernel C's), the values
top-k, the approx scan, and ``FlatIndex(engine="bucket"/"approx")``.

Inputs come from numpy seeds and go through both packages; the JAX
Pallas kernels run in interpret mode, as their own tests run them on the
CPU. Distances are held to atol 1e-4 / rtol 1e-5 (f32 sums in another
order; 2.3e-5 is the largest gap seen, on unnormalized rows of squared
norm ~32); ids are compared tie-aware, and exactly where the test is
about tie order. The values top-k is selection only and must match
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vers_tpu
import vers_tpu_torch
from vers_tpu.ops.pallas_bucket import bucket_scan_topk as jax_bucket_scan_topk
from vers_tpu.ops.pallas_topk import distance_topk as jax_distance_topk
from vers_tpu.ops.pallas_topk import pallas_topk_values
from vers_tpu.ops.topk import approx_scan_topk as jax_approx_scan_topk
from vers_tpu_torch.ops import cuda_bucket, cuda_topk
from vers_tpu_torch.ops.cuda_bucket import (
    bucket_geometry,
    bucket_scan_topk,
    bucket_table_plain,
    compare_bucket_tables,
)
from vers_tpu_torch.ops.topk import approx_scan_topk
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

ATOL, RTOL = 1e-4, 1e-5


def _data(n, d, q_n, seed, normalized):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    if normalized:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def _duplicated(seed, normalized):
    """Every row twice, 256 rows apart (same bucket lane), and queries
    next to rows: exact ties everywhere."""
    base, _ = _data(256, 16, 1, seed, normalized)
    x = np.concatenate([base, base])
    q = base[:12] + np.float32(0.01)
    if normalized:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def _match(got, want):
    assert_topk_match(got[0], got[1], np.asarray(want[0]), np.asarray(want[1]),
                      rtol=RTOL, atol=ATOL)


def _match_results(got, want):
    _match((got.distances, got.ids), (want.distances, want.ids))


# (name, n rows, n_valid, k, chunk_size, target_buckets)
BUCKET_CASES = [
    ("superchunk_8", 4096, 4096, 10, 128, 512),   # 4 superchunks of 8 chunks
    ("n_valid_below_rows", 512, 300, 4, 128, 8192),
    ("k_above_valid_rows", 128, 6, 10, 128, 8192),
    ("ties_across_superchunks", 512, 512, 6, 128, 512),
    ("ties_inside_buckets", 512, 512, 6, 128, 128),
]


@pytest.mark.parametrize("rescore", [False, True])
@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("name,n,n_valid,k,chunk,target", BUCKET_CASES,
                         ids=[c[0] for c in BUCKET_CASES])
def test_bucket_scan_topk_matches_jax(rescore, metric, name, n, n_valid, k,
                                      chunk, target):
    normalized = metric == "cosine"
    if name.startswith("ties"):
        x, q = _duplicated(4, normalized)
    else:
        x, q = _data(n, 32, 16, 3, normalized)
    kw = dict(metric=metric, chunk_size=chunk, target_buckets=target,
              rescore=rescore)
    want = jax_bucket_scan_topk(jnp.asarray(q), jnp.asarray(x), n_valid, k,
                                interpret=True, **kw)
    got = bucket_scan_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid,
                           k, **kw)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _match(got, want)
    if name.startswith("ties"):
        # equal distances: the lower row, then the lower table column
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if n_valid < k:
        assert (got[1][:, n_valid:] == -1).all()
        assert torch.isinf(got[0][:, n_valid:]).all()


@pytest.mark.parametrize("n_rows,chunk_size,target,want", [
    (1_000_064, 2048, 8192, (2048, 7, 70)),  # 1M rows at their capacity
    (4096, 128, 512, (128, 8, 4)),
    (300, 2048, 8192, (384, 1, 1)),
    (16384, 2048, 8192, (2048, 1, 8)),
    (2_000_128, 2048, 8192, (2048, 15, 66)),  # after a capacity doubling
])
def test_bucket_geometry(n_rows, chunk_size, target, want):
    assert bucket_geometry(n_rows, chunk_size, target) == want


def test_bucket_geometry_rejects_partial_lanes():
    with pytest.raises(ValueError, match="multiple"):
        bucket_geometry(4096, 1000)


def _table_by_rule(q, x, n_valid, span, metric):
    """The bucket rule written out row by row: bf16-rounded inputs, f32
    products, each column's smallest distance, first row on ties."""
    qb = torch.from_numpy(q).to(torch.bfloat16).double()
    xb = torch.from_numpy(x).to(torch.bfloat16).double()
    dot = (qb @ xb.T).float().numpy()
    if metric == "cosine":
        dist = 1.0 - dot
    else:
        qq = (qb * qb).sum(1).float().numpy()[:, None]
        xx = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)[None, :]
        dist = np.maximum(qq + xx - 2.0 * dot, 0.0)
    dist[:, n_valid:] = np.inf
    n_super = -(-x.shape[0] // span)
    out_d = np.full((q.shape[0], n_super * 128), np.inf, np.float32)
    out_i = np.full((q.shape[0], n_super * 128), -1, np.int32)
    for r in range(x.shape[0]):
        c = (r // span) * 128 + r % 128
        win = dist[:, r] < out_d[:, c]
        out_d[win, c] = dist[win, r]
        out_i[win, c] = r
    return torch.from_numpy(out_d), torch.from_numpy(out_i)


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("n,n_valid,span", [(1000, 1000, 256), (640, 500, 128),
                                            (3000, 2999, 1024)])
def test_bucket_table_plain_follows_the_rule(metric, n, n_valid, span):
    x, q = _data(n, 24, 9, 5, metric == "cosine")
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    got = bucket_table_plain(qt, xt, n_valid, span, metric)
    want = _table_by_rule(q, x, n_valid, span, metric)
    assert got[0].shape == (9, -(-n // span) * 128)
    compare_bucket_tables(got, want, qt, xt, n_valid, span, metric)


def test_compare_bucket_tables_rejects_faults():
    x, q = _data(1000, 24, 9, 6, True)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    want = bucket_table_plain(qt, xt, 1000, 256)
    assert compare_bucket_tables(want, want, qt, xt, 1000, 256) == (0.0, 0)
    d = want[0].clone()
    d[2, 5] += 1e-3  # a distance beyond tolerance
    with pytest.raises(AssertionError, match="distance"):
        compare_bucket_tables((d, want[1]), want, qt, xt, 1000, 256)
    # column 5 is bucket (superchunk 0, lane 5): rows 5 and 133
    row = int(want[1][2, 5])
    assert row in (5, 133)
    for wrong, match in ((row + 1, "bucket"),      # another lane
                         (row + 256, "bucket"),    # another superchunk
                         (138 - row, "near-tie")):  # the bucket's other row
        i = want[1].clone()
        i[2, 5] = wrong
        with pytest.raises(AssertionError, match=match):
            compare_bucket_tables((want[0], i), want, qt, xt, 1000, 256)


def _values_data(kind):
    rng = np.random.default_rng(9)
    if kind == "ties":  # few distinct values: the lowest column wins
        vals = rng.integers(0, 5, size=(40, 700)).astype(np.float32)
    else:
        vals = rng.normal(size=(40, 700)).astype(np.float32)
    vals[3, 100:] = np.inf  # a row with few finite entries
    vals[7, :] = np.inf     # a row with none
    ids = rng.integers(0, 10_000, size=(40, 700)).astype(np.int32)
    return vals, ids


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("k", [1, 8, 128])
def test_topk_values_matches_pallas(kind, k):
    vals, ids = _values_data(kind)
    wd, wi = pallas_topk_values(jnp.asarray(vals), jnp.asarray(ids), k,
                                query_tile=16, chunk_size=256, interpret=True)
    before = cuda_topk.LAUNCHES_VALUES
    gd, gi = cuda_topk.topk_values(torch.from_numpy(vals),
                                   torch.from_numpy(ids), k)
    assert cuda_topk.LAUNCHES_VALUES == before  # CPU tensors never launch
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_topk_values_pads_k_above_width_and_counts_large_k():
    vals, ids = _values_data("random")
    gd, gi = cuda_topk.topk_values_plain(torch.from_numpy(vals[:, :50]),
                                         torch.from_numpy(ids[:, :50]), 60)
    assert gd.shape == (40, 60)
    assert torch.isinf(gd[:, 50:]).all() and (gi[:, 50:] == -1).all()
    before = cuda_topk.LARGE_K_PLAIN_VALUES
    got = cuda_topk.topk_values(torch.from_numpy(vals), torch.from_numpy(ids),
                                cuda_topk.MAX_K + 1)
    assert cuda_topk.LARGE_K_PLAIN_VALUES == before + 1
    want = cuda_topk.topk_values_plain(torch.from_numpy(vals),
                                       torch.from_numpy(ids), cuda_topk.MAX_K + 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("n,n_valid,k,chunk", [
    (1000, 950, 10, 256),   # four chunks, the last one short
    (640, 640, 7, 128),
    (300, 5, 8, 128),       # k > n_valid: (+inf, -1) tail
])
def test_approx_scan_topk_matches_jax(metric, n, n_valid, k, chunk):
    x, q = _data(n, 24, 21, 7, metric == "cosine")
    want = jax_approx_scan_topk(jnp.asarray(q), jnp.asarray(x), n_valid, k,
                                metric=metric, chunk_size=chunk)
    got = approx_scan_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid,
                           k, metric=metric, chunk_size=chunk)
    assert got[1].dtype == torch.int32
    _match(got, want)
    if n_valid < k:
        assert (got[1][:, n_valid:] == -1).all()
        assert torch.isinf(got[0][:, n_valid:]).all()


@pytest.mark.parametrize("force", ["approx", "bucket"])
def test_distance_topk_force_routes(force):
    x, q = _data(384, 16, 11, 8, False)
    want = jax_distance_topk(jnp.asarray(q), jnp.asarray(x), 380, 5,
                             force=force)
    got = cuda_topk.distance_topk(torch.from_numpy(q), torch.from_numpy(x),
                                  380, 5, force=force)
    _match(got, want)
    direct = (approx_scan_topk if force == "approx" else bucket_scan_topk)(
        torch.from_numpy(q), torch.from_numpy(x), 380, 5)
    assert torch.equal(got[0], direct[0]) and torch.equal(got[1], direct[1])


@pytest.mark.parametrize("engine,rescore", [("bucket", False), ("bucket", True),
                                            ("approx", False)])
@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_flat_engines_match_jax(engine, rescore, metric):
    # 1024 rows fill the store's capacity: the first add doubles it,
    # which moves the bucket geometry (chunk 1024 -> 2048)
    x, q = _data(1024, 32, 40, 10, metric == "cosine")
    ids = np.arange(1024, dtype=np.int64) * 3 + 7
    jcfg = vers_tpu.FlatConfig(metric=metric, engine=engine,
                               bucket_rescore=rescore)
    tcfg = vers_tpu_torch.FlatConfig(metric=metric, engine=engine,
                                     bucket_rescore=rescore)
    jidx = vers_tpu.FlatIndex(x, ids=ids, config=jcfg)
    tidx = vers_tpu_torch.FlatIndex.from_numpy(x, ids, config=tcfg,
                                               device="cpu")
    assert tidx._store.capacity == jidx._store.capacity == 1024
    _match_results(tidx.search_batch(q, 10), jidx.search_batch(q, 10))
    jidx.add(q[0], 5)
    tidx.add(q[0], 5)
    assert tidx._store.capacity == jidx._store.capacity == 2048
    got = tidx.search_batch(q, 10)
    assert got.ids[0, 0] == 5
    _match_results(got, jidx.search_batch(q, 10))


def test_cuda_wrappers_take_the_plain_version_on_cpu():
    x, q = _data(512, 16, 5, 11, False)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    before = cuda_bucket.LAUNCHES
    got = cuda_bucket.cuda_bucket_table(qt, xt, 500, 256)
    assert cuda_bucket.LAUNCHES == before
    want = bucket_table_plain(qt, xt, 500, 256)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_input_checks_reject_cpu_tensors():
    x = torch.zeros((256, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bucket._check_inputs(x, x, 256)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_topk._check_values(x, x.int(), 4)
