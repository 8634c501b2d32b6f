"""Kernel A's design on the CPU: the corpus split and its tie rule, the
split geometry and the launch plan of each route, and the 3xTF32
numerics of its tensor-core products.

``split_scan_topk_plain`` (the two-pass design in plain torch) is held
to ``fused_scan_topk`` and to ``vers_tpu``'s ``pallas_distance_topk`` in
interpret mode, on inputs made from numpy seeds. Distances: rtol 1e-4 /
atol 1e-5 with ids tie-aware, as in ``test_torch_topk.py`` (f32 sums in
other orders); integer-valued inputs give exact distances, and there the
split must equal the unsplit scan bit for bit, ties included.

    python -m pytest tests/test_torch_split_topk.py -q
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu.ops.pallas_topk import pallas_distance_topk
from vers_tpu_torch.ops import cuda_topk
from vers_tpu_torch.ops.topk import fused_scan_topk, split_scan_topk_plain, tf32_split
from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

torch.set_num_threads(2)

N, D, Q_N, K = 700, 24, 17, 8


def _data(metric, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(Q_N, D)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


@functools.lru_cache(maxsize=None)
def _pallas(metric, n_valid, k):
    x, q = _data(metric)
    d, i = pallas_distance_topk(jnp.asarray(q), jnp.asarray(x), n_valid, k,
                                metric=metric, query_tile=8, chunk_size=128,
                                interpret=True)
    return np.asarray(d), np.asarray(i)


def _assert_ties_ascend(d, i):
    d, i = np.asarray(d), np.asarray(i)
    same = (d[:, 1:] == d[:, :-1]) & np.isfinite(d[:, 1:])
    assert (i[:, 1:][same] > i[:, :-1][same]).all()


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("n_valid", [601, 250])  # mid-split; splits wholly past
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
def test_split_scan_matches_fused_and_pallas(metric, n_valid, n_split):
    x, q = _data(metric)
    split_rows = -(-N // n_split)
    got = split_scan_topk_plain(torch.from_numpy(q), torch.from_numpy(x),
                                n_valid, K, split_rows, metric=metric)
    assert got[0].shape == (Q_N, K) and got[1].dtype == torch.int32
    want = fused_scan_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid,
                           K, metric=metric, chunk_size=128)
    assert_topk_match(got[0], got[1], want[0], want[1])
    pd, pi = _pallas(metric, n_valid, K)
    assert_topk_match(got[0], got[1], pd, pi)
    assert max_abs_diff(got[0], pd) < 1e-4
    assert (got[1] < n_valid).all()


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_split_scan_k_above_split_rows(metric):
    """k = 10 over splits of 6 rows: each split's set ends in (+inf, -1)."""
    x, q = _data(metric, seed=1)
    x = x[:40]
    got = split_scan_topk_plain(torch.from_numpy(q), torch.from_numpy(x), 37,
                                10, 6, metric=metric)
    want = fused_scan_topk(torch.from_numpy(q), torch.from_numpy(x), 37, 10,
                           metric=metric)
    assert_topk_match(got[0], got[1], want[0], want[1])
    assert (got[1] >= 0).all() and torch.isfinite(got[0]).all()


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("split_rows", [37, 60, 61])
def test_split_scan_ties_across_boundaries(metric, split_rows):
    """Exact duplicates (rows r and r + 60) on both sides of a split
    boundary tie exactly: the lower row comes first, as unsplit."""
    rng = np.random.default_rng(2)
    base = rng.integers(-2, 3, size=(60, 12)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, base]))
    q = torch.from_numpy(base[:20] + rng.integers(-1, 2, (20, 12)).astype(np.float32))
    got = split_scan_topk_plain(q, x, 120, 9, split_rows, metric=metric)
    want = fused_scan_topk(q, x, 120, 9, metric=metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _assert_ties_ascend(*got)
    assert ((got[0][:, 1:] == got[0][:, :-1])).any()


def test_split_scan_nothing_valid():
    x, q = _data("sq_euclidean")
    d, i = split_scan_topk_plain(torch.from_numpy(q), torch.from_numpy(x), 0, K, 128)
    assert torch.isinf(d).all() and (i == -1).all()


@pytest.mark.parametrize("query_tile", [64, 128])
@pytest.mark.parametrize("n", [100, 41_368, 1_000_000])
@pytest.mark.parametrize("q_n", [1, 64, 256, 2048, 16384])
def test_split_geometry(q_n, n, query_tile):
    """The bf16 routes' split: whole tiles in row order covering [0, n),
    none empty, and the most splits whose blocks fit one wave of the
    card (132 SMs, a block an SM)."""
    sms = 132
    n_split, split_rows = cuda_topk.split_geometry(q_n, n, sms, query_tile)
    tiles = -(-n // cuda_topk.TILE_ROWS)
    q_tiles = -(-q_n // query_tile)
    assert split_rows % cuda_topk.TILE_ROWS == 0
    assert 1 <= n_split <= min(tiles, 65535)
    assert (n_split - 1) * split_rows < n <= n_split * split_rows  # none empty
    assert n_split == 1 or q_tiles * n_split <= sms  # one wave
    if q_tiles < sms and n_split < tiles:  # no fewer than whole tiles allow
        per = -(-tiles // (sms // q_tiles))
        assert n_split == -(-tiles // per)


@pytest.mark.parametrize("n", [100, 1_000_000])
@pytest.mark.parametrize("q_n", [1, 64, 2048, 16384])
def test_split_geometry_tf32(q_n, n):
    """The f32/highest route's split, as it was: at least two blocks an
    SM wherever the corpus has tiles enough."""
    sms = 132
    n_split, split_rows = cuda_topk.split_geometry_tf32(q_n, n, sms)
    tiles = -(-n // cuda_topk.TILE_ROWS)
    q_tiles = -(-q_n // cuda_topk.TF32_QUERY_TILE)
    assert split_rows % cuda_topk.TILE_ROWS == 0
    assert 1 <= n_split <= min(tiles, 65535)
    assert (n_split - 1) * split_rows < n <= n_split * split_rows  # none empty
    if tiles >= -(-2 * sms // q_tiles):
        assert q_tiles * n_split >= 2 * sms
    else:
        assert n_split == tiles


ROUTES = ("f32/highest", "bf16/highest", "bf16/high", "bf16/default",
          "f32/high", "f32/default")
PARTS = {"f32/highest": 0, "bf16/highest": 3, "bf16/high": 2,
         "bf16/default": 1, "f32/high": 2, "f32/default": 1}


@pytest.mark.parametrize("k", [1, 8, 10, 100, 128])
@pytest.mark.parametrize("d", [7, 16, 37, 300, 512])
@pytest.mark.parametrize("route", ROUTES)
def test_kernel_plan_fits(route, d, k):
    """Every route has a plan within a block's 227 KB at d <= 512 and k <=
    128, at any query count: a query tile of 64 or 128 (128 only with
    resident parts and more than 64 queries), 2 to SLOTS_MAX slots, the
    route's query parts, and a split of whole tiles covering the corpus
    in row order, none empty."""
    for q_n, n in ((1, 1_000_000), (64, 200), (65, 41_368), (2048, 41_368),
                   (16384, 1_000_000)):
        plan = cuda_topk.kernel_plan(route, q_n, n, d, k, 132)
        assert plan.route == route and plan.parts == PARTS[route]
        assert plan.smem_bytes <= cuda_topk.SMEM_BLOCK
        assert plan.blocks_per_sm >= 1
        assert plan.query_tile in (64, 128)
        if plan.query_tile == 128:
            assert plan.resident and q_n > 64
        assert 2 <= plan.slots <= cuda_topk.SLOTS_MAX
        assert plan.split_rows % cuda_topk.TILE_ROWS == 0
        assert (plan.n_split - 1) * plan.split_rows < n <= (
            plan.n_split * plan.split_rows)
        if route != "f32/highest":
            assert plan.smem_bytes == cuda_topk.bf16_smem_bytes(
                route, d, k, plan.query_tile, plan.slots, plan.resident)


def test_kernel_plan_layout():
    """The bf16/default plan of the 16384 x 1M x 300 scan, k = 10, byte by
    byte: 128 queries, three slots of a 16 KB slice (+1 KB where d % 8 ==
    4, + three mbarriers), 80 KB of resident query parts, the 64 KB
    distance tile, two mask copies, norms and kth, two tiles' |x|^2,
    four mbarriers, the best sets at pitch 11 and 1 KB to align."""
    plan = cuda_topk.kernel_plan("bf16/default", 16384, 1_000_000, 300, 10,
                                 132)
    assert (plan.query_tile, plan.slots, plan.resident) == (128, 3, True)
    want = (3 * (16384 + 1024 + 24) + 5 * 128 * 128 + 128 * 128 * 4
            + 2 * 128 * 16 + 2 * 128 * 4 + 2 * 128 * 4 + 4 * 8
            + 11 * 128 * 8 + 1024)
    assert plan.smem_bytes == want == 218216
    assert (plan.n_split, plan.blocks_per_sm) == (1, 1)
    # where the 128-query parts leave no room for three slots, 64 queries
    assert cuda_topk.tile_plan("bf16/high", 300, 10, 16384)[:3] == (64, 6, True)
    # and where even theirs leave none for two, queries split in registers
    assert cuda_topk.tile_plan("bf16/highest", 300, 128, 16384)[2] is False


@pytest.mark.parametrize("route", ROUTES)
def test_kernel_plan_raises_where_nothing_fits(route):
    """No plan quietly falls back: a k above MAX_K, or a card whose blocks
    hold too little shared memory, raises and names the shape."""
    with pytest.raises(ValueError, match="k <= 128"):
        cuda_topk.kernel_plan(route, 64, 1000, 300, 129, 132)
    with pytest.raises(ValueError, match=f"{route}.*d=300, k=10"):
        cuda_topk.kernel_plan(route, 64, 1000, 300, 10, 132,
                              smem_limit=48 * 1024)


def test_split_pass_refuses_cpu_tensors():
    x = torch.zeros((256, 8))
    with pytest.raises(ValueError):
        cuda_topk.split_pass(x, x, 256, 4)


def test_tf32_split_rounds_to_nearest_away():
    one = 1.0
    half_ulp = 2.0 ** -11  # half a tf32 ulp at 1.0
    v = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0 ** -23,
                      3.0, 0.0], dtype=torch.float32)
    hi, lo = tf32_split(v)
    assert hi.tolist() == [one + 2 * half_ulp, -(one + 2 * half_ulp), one, 3.0, 0.0]
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()


def _rows(n, scale, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 300))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return (x * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 15.0])
def test_three_term_tf32_dot_is_f32_accurate(scale):
    """hi*hi + hi*lo + lo*hi (the products exact, summed here in f64 to
    isolate the split) against the f64 dot: within 1e-6 * |q| |x|, and
    the kernel's f32 distance within 1e-6 * (|q|^2 + |x|^2). Rows of
    norm ~15 are ROADMAP queue 3's unnormalized case."""
    x, q = _rows(2000, scale, 0), _rows(50, scale, 1)
    xh, xl = (t.double() for t in tf32_split(torch.from_numpy(x)))
    qh, ql = (t.double() for t in tf32_split(torch.from_numpy(q)))
    exact = torch.from_numpy(q).double() @ torch.from_numpy(x).double().T
    three = qh @ xh.T + qh @ xl.T + ql @ xh.T
    assert (three - exact).abs().max().item() <= 1e-6 * scale * scale
    qf, xf = torch.from_numpy(q), torch.from_numpy(x)
    dist = ((qf * qf).sum(1)[:, None] + (xf * xf).sum(1)[None, :]
            - 2 * three.float()).clamp_min(0)
    want = torch.cdist(qf.double(), xf.double()) ** 2
    assert (dist.double() - want).abs().max().item() <= 1e-6 * 2 * scale * scale


@pytest.mark.parametrize("scale", [1.0, 15.0])
def test_one_pass_tf32_misses_the_tolerance(scale):
    """hi*hi alone (plain TF32) misses the 1e-4 distance tolerance on the
    same data: why the kernel spends three MMAs per product."""
    x, q = _rows(2000, scale, 0), _rows(50, scale, 1)
    xh, _ = tf32_split(torch.from_numpy(x))
    qh, _ = tf32_split(torch.from_numpy(q))
    one = qh.double() @ xh.double().T
    exact = torch.from_numpy(q).double() @ torch.from_numpy(x).double().T
    assert 2 * (one - exact).abs().max().item() > 1e-4
