"""vers_tpu_torch binned layout, work items, merge and kernel B's plain
version against vers_tpu on identical inputs.

The JAX packed-scan kernel runs in interpret mode, as in
tests/test_fused_binned.py, at the same shapes (q_blk=64, r_blk=256,
chunk=128). Layout and work-item arrays must be equal; scan results are
compared tie-aware with distances to rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu.ops import binned as jb
from vers_tpu.ops import pallas_binned as jpb
from vers_tpu_torch.ops import binned as tb
from vers_tpu_torch.ops import cuda_binned as tpb
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)


def _data(n, d, k, skew, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = ((rng.random(n) ** 3 * k).astype(np.int64) if skew
            else rng.integers(0, k, n))
    return x, bins, rng


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


LAYOUT_KEYS = ("corpus_sorted", "sorted_to_orig", "start", "size", "rbin",
               "sizes_host", "starts_host")


@pytest.mark.parametrize("n,k,skew", [(3000, 16, False), (997, 7, True)])
def test_make_layout_matches_jax(n, k, skew):
    x, bins, _ = _data(n, 8, k, skew)
    jl = jb.make_layout(x, bins, k)
    tl = tb.make_layout(x, bins, k)
    for key in LAYOUT_KEYS:
        np.testing.assert_array_equal(_np(tl[key]), _np(jl[key]), err_msg=key)
    assert tl["max_bin"] == jl["max_bin"] and tl["num_bins"] == jl["num_bins"]

    # the device-input variant, with padding rows past n_valid
    n_pad = ((n + 127) // 128) * 128
    xp = np.pad(x, ((0, n_pad - n), (0, 0)))
    bp = np.pad(bins, (0, n_pad - n)).astype(np.int32)
    jd = jb.make_layout_device(jnp.asarray(xp), jnp.asarray(bp), k, n)
    td = tb.make_layout_device(torch.from_numpy(xp), torch.from_numpy(bp), k, n)
    for key in LAYOUT_KEYS:
        np.testing.assert_array_equal(_np(td[key]), _np(jd[key]), err_msg=key)


def test_slacken_and_insert_match_jax():
    x, bins, rng = _data(1200, 8, 9, True)
    jl = jb.slacken_layout(jb.make_layout(x, bins, 9))
    tl = tb.slacken_layout(tb.make_layout(x, bins, 9))
    for step in range(12):
        row = rng.normal(size=8).astype(np.float32)
        c = int(rng.integers(0, 9))
        assert jb.layout_insert(jl, row, c, 1200 + step) == tb.layout_insert(
            tl, row, c, 1200 + step)
    for key in LAYOUT_KEYS + ("true_sizes_host", "caps_host"):
        np.testing.assert_array_equal(_np(tl[key]), _np(jl[key]), err_msg=key)
    assert tl["max_bin"] == jl["max_bin"]


@pytest.mark.parametrize("r_blk", [256, 1024])
def test_padded_group_layout_matches_jax(r_blk):
    x, bins, _ = _data(3000, 32, 16, True)
    jl, tl = jb.make_layout(x, bins, 16), tb.make_layout(x, bins, 16)
    np.testing.assert_array_equal(*(np.asarray(t[0]) for t in (
        tb.static_groups(tl, r_blk), jb.static_groups(jl, r_blk))))
    jp = jpb.padded_group_layout(jl, r_blk)
    tp = tpb.padded_group_layout(tl, r_blk)
    d = x.shape[1]
    jc = np.asarray(jp["corpus"])
    # the port does not pad the feature axis to 128 lanes
    assert tp["corpus"].shape == (jc.shape[0], d)
    np.testing.assert_array_equal(tp["corpus"].numpy(), jc[:, :d])
    assert not jc[:, d:].any()
    for key in ("rbin", "s2o", "g_first"):
        np.testing.assert_array_equal(_np(tp[key]), _np(jp[key]), err_msg=key)
    np.testing.assert_allclose(tp["xx"].numpy(), np.asarray(jp["xx"]), rtol=1e-6)
    for key in ("g_base", "n_groups", "g_max", "r_blk"):
        assert tp[key] == jp[key], key


@pytest.mark.parametrize("q_n,p,q_blk,sentinels", [
    (200, 1, 64, False), (500, 3, 64, True), (33, 2, 128, True),
])
def test_workitems_blocks_match_jax(q_n, p, q_blk, sentinels):
    x, bins, rng = _data(3000, 8, 16, True)
    layout = jb.make_layout(x, bins, 16)
    g_first = jpb.padded_group_layout(layout, 256)["g_first"][0]
    probes = rng.integers(0, 17 if sentinels else 16, size=(q_n, p))
    bins_flat = probes.T.reshape(-1)
    counts = np.bincount(bins_flat, minlength=17)[:16].astype(np.int32)
    q_pad_rank = -(-q_n // q_blk) * q_blk
    w_rank = p * q_pad_rank // q_blk + len(np.asarray(g_first)) + 1
    scratch = p * q_pad_rank // q_blk
    for rank_off in (0, q_pad_rank):
        jq, jg = jpb._workitems_blocks(jnp.asarray(counts), rank_off, g_first,
                                       q_blk, w_rank, scratch, g_base=3)
        tq, tg = tpb._workitems_blocks(torch.from_numpy(counts), rank_off,
                                       torch.from_numpy(np.array(g_first)),
                                       q_blk, w_rank, scratch, g_base=3)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_adaptive_probes_match_jax():
    x, bins, rng = _data(2000, 6, 24, True)
    sizes = np.bincount(bins, minlength=24).astype(np.int32)
    cents = rng.normal(size=(24, 6)).astype(np.float32)
    q = rng.normal(size=(150, 6)).astype(np.float32)
    for top_k in (5, 40):
        p_max = jb.adaptive_probe_depth(sizes, top_k)
        assert tb.adaptive_probe_depth(sizes, top_k) == p_max
        jp = jb.adaptive_probes(jnp.asarray(q), jnp.asarray(cents),
                                jnp.asarray(sizes), 24, p_max, top_k)
        tp = tb.adaptive_probes(torch.from_numpy(q), torch.from_numpy(cents),
                                torch.from_numpy(sizes), 24, p_max, top_k)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("p,k,dedup", [
    (4, 10, False), (6, 10, True),      # w <= 64: one rank-select
    (8, 10, False), (7, 10, True),      # w > 64: the tournament
    (16, 6, True), (3, 40, False),      # tournament / sort fallback
])
def test_merge_probe_results_matches_jax_exactly(p, k, dedup):
    rng = np.random.default_rng(7)
    w, q_n = p * k, 65
    d = rng.integers(0, 40, size=(q_n, w)).astype(np.float32)  # ties
    i = rng.integers(0, 200, size=(q_n, w)).astype(np.int32)
    sent = rng.random((q_n, w)) < 0.05
    d[sent], i[sent] = np.inf, -1
    jd, ji = jb.merge_probe_results(jnp.asarray(d), jnp.asarray(i), k,
                                    dedup=dedup)
    td, ti = tb.merge_probe_results(torch.from_numpy(d), torch.from_numpy(i), k,
                                    dedup=dedup)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _scan_inputs(n, d, k, q_n, p, skew, q_blk=64, r_blk=256):
    """Identical kernel-B inputs for both packages, built the way the
    combined (query, rank) pair path builds them, with some gated ranks."""
    x, bins, rng = _data(n, d, k, skew)
    layout = jb.make_layout(x, bins, k)
    padded = jpb.padded_group_layout(layout, r_blk)
    d_pad = np.asarray(padded["corpus"]).shape[1]
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    probes = rng.integers(0, k, size=(q_n, p))
    probes[rng.random((q_n, p)) < 0.1] = k  # gated ranks: sentinel bin
    pq = p * q_n
    q_pad_rank = -(-q_n // q_blk) * q_blk
    rows_pad = p * q_pad_rank
    bins_flat = probes.T.reshape(-1)
    order = np.argsort(bins_flat, kind="stable")
    tail = rows_pad - pq + q_blk
    q_stack = np.zeros((pq + tail, d_pad), np.float32)
    q_stack[:pq, :d] = q[order % q_n]
    qbin = np.full((1, pq + tail), -1, np.int32)
    qbin[0, :pq] = bins_flat[order]
    counts = np.bincount(bins_flat, minlength=k + 1)[:k].astype(np.int32)
    w_rank = rows_pad // q_blk + padded["g_max"] + 1
    qb, gb = jpb._workitems_blocks(jnp.asarray(counts), 0, padded["g_first"][0],
                                   q_blk, w_rank, rows_pad // q_blk)
    arrays = dict(q_stack=q_stack, qbin_stack=qbin, qb=np.array(qb),
                  gb=np.array(gb), corpus_padded=np.array(padded["corpus"]),
                  rbin_padded=np.array(padded["rbin"]),
                  xx_padded=np.array(padded["xx"]),
                  ids_padded=np.array(padded["s2o"])[None, :])
    statics = dict(top_k=10, q_blk=q_blk, chunk=128, r_chunks=r_blk // 128,
                   q_pad_rank=q_pad_rank)
    return arrays, statics, qbin[0], k


@pytest.mark.parametrize("kernel_ids", [False, True])
@pytest.mark.parametrize("n,d,k,q_n,p,skew", [
    (3000, 32, 16, 200, 1, False),
    (3000, 32, 16, 500, 3, True),
    (997, 16, 7, 33, 2, True),
])
def test_packed_scan_plain_matches_pallas_interpret(n, d, k, q_n, p, skew,
                                                    kernel_ids):
    arrays, statics, qbin, num_bins = _scan_inputs(n, d, k, q_n, p, skew)
    if not kernel_ids:
        arrays.pop("ids_padded")
    jd, ji = jpb.pallas_packed_scan(
        **{a: jnp.asarray(v) for a, v in arrays.items()}, **statics,
        interpret=True,
    )
    td, ti = tpb.packed_scan_plain(
        **{a: torch.from_numpy(v) for a, v in arrays.items()}, **statics,
    )
    live = (qbin >= 0) & (qbin < num_bins)  # rows with real work
    assert live.any()
    assert_topk_match(td.numpy()[live], ti.numpy()[live],
                      np.asarray(jd)[live], np.asarray(ji)[live])
    # rows no run covers hold the prefilled (+inf, -1)
    dead = qbin < 0
    assert torch.isinf(td[dead]).all() and (ti[dead] == -1).all()


@pytest.mark.parametrize("kernel_ids", [False, True])
@pytest.mark.parametrize("n,d,k,q_n,nprobe,skew", [
    (3000, 32, 16, 200, 1, False),
    (3000, 32, 16, 500, 3, True),
    (997, 16, 7, 33, 2, True),
])
def test_binned_topk_kernel_matches_pallas_path(n, d, k, q_n, nprobe, skew,
                                                kernel_ids):
    """The whole binned search (probe, pair sort, work items, scan,
    unsort, merge) against the JAX Pallas path in interpret mode."""
    x, bins, rng = _data(n, d, k, skew)
    cents = rng.normal(size=(k, d)).astype(np.float32)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    jd, ji = jb.binned_topk_pallas(
        jnp.asarray(q), jnp.asarray(cents), nprobe, jb.make_layout(x, bins, k),
        top_k=10, q_blk=64, r_blk=256, chunk=128, kernel_ids=kernel_ids,
    )
    td, ti = tb.binned_topk_kernel(
        torch.from_numpy(q), torch.from_numpy(cents), nprobe,
        tb.make_layout(x, bins, k), top_k=10, q_blk=64, r_blk=256, chunk=128,
        kernel_ids=kernel_ids,
    )
    assert_topk_match(td, ti, np.asarray(jd), np.asarray(ji))


def test_packed_scan_large_k_routes_plain_and_counts():
    arrays, statics, qbin, num_bins = _scan_inputs(997, 16, 7, 33, 1, True)
    statics["top_k"] = tpb.MAX_K + 1
    before = tpb.LARGE_K_PLAIN
    td, _ = tpb.packed_scan(**{a: torch.from_numpy(v) for a, v in arrays.items()},
                            **statics)
    assert tpb.LARGE_K_PLAIN == before + 1
    assert td.shape == (qbin.shape[0], tpb.MAX_K + 1)


def test_packed_scan_input_checks_reject_cpu_tensors():
    arrays, statics, _, _ = _scan_inputs(997, 16, 7, 33, 1, True)
    t = {a: torch.from_numpy(v) for a, v in arrays.items()}
    with pytest.raises(ValueError, match="CUDA"):
        tpb._check_inputs(*(t[a] for a in ("q_stack", "qbin_stack", "qb", "gb",
                                           "corpus_padded", "rbin_padded",
                                           "xx_padded", "ids_padded")),
                          statics["top_k"], statics["q_blk"], 256)


def test_check_work_items_bounds():
    arrays, statics, _, _ = _scan_inputs(3000, 32, 16, 500, 3, True)
    qb, gb = torch.from_numpy(arrays["qb"]), torch.from_numpy(arrays["gb"])
    n_rows = arrays["q_stack"].shape[0]
    n_corpus = arrays["corpus_padded"].shape[0]
    args = (n_rows, statics["q_blk"], n_corpus, 256)
    tpb.check_work_items(qb, gb, *args)  # items built by the JAX helper
    with pytest.raises(ValueError, match="qb outside"):
        tpb.check_work_items(qb + 1, gb, *args)  # the scratch block + 1
    with pytest.raises(ValueError, match="gb outside"):
        tpb.check_work_items(qb, gb - 1, *args)  # item 0 names group 0

