"""Kernel A's plain version (``ops/topk.fused_scan_topk``) at each of the
TPU's precision settings, over an f32 and a bf16 corpus, and the
dispatcher and bounds of kernel A's routes.

On the CPU, JAX computes every setting in f32, so ``default`` and
``high`` are held to the TPU's meaning written here in numpy (float64
sums of the products, which are exact): ``default`` one product of
bf16-rounded operands (round to nearest even), ``high`` the bf16_3x
split ``hi.hi + hi.lo + lo.hi``. ``highest`` and the bf16 corpus are
held to the JAX kernel itself (``pallas_distance_topk`` in interpret
mode), and so is cosine ``default`` on operands rounded beforehand,
where the TPU's products are exact too. |q|^2 and |x|^2 are f32 sums of
the operands as given at every setting.

Distances are held to atol 1e-5 on unit rows and 1e-4 / rtol 1e-5 on
rows of norm ~5 (f32 sums in another order); ids tie-aware.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu.ops.pallas_topk import pallas_distance_topk
from vers_tpu_torch.ops import cuda_topk
from vers_tpu_torch.ops.topk import (
    bf16_round,
    fused_scan_topk,
    product_operands,
)
from vers_tpu_torch.utils import roofline
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

PRECISIONS = ("highest", "high", "default")


def _bf16_np(a):
    """f32 -> bf16 -> f32 by the bits: round to nearest, ties to even."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def _tpu_topk(q, x, k, metric, precision):
    """The TPU's meaning of the setting, in numpy: (dists, ids) of the
    k nearest, ascending, lower row first on ties."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    if precision == "highest":
        dot = q64 @ x64.T
    else:
        qh, xh = _bf16_np(q), _bf16_np(x)
        dot = qh.astype(np.float64) @ xh.astype(np.float64).T
        if precision == "high":
            ql = _bf16_np(q - qh).astype(np.float64)
            xl = _bf16_np(x - xh).astype(np.float64)
            dot = dot + qh.astype(np.float64) @ xl.T + ql @ xh.astype(
                np.float64).T
    if metric == "cosine":
        dist = 1.0 - dot
    else:
        qq = np.sum(q.astype(np.float32) ** 2, axis=1, dtype=np.float64)
        xx = np.sum(x.astype(np.float32) ** 2, axis=1, dtype=np.float64)
        dist = np.maximum(qq[:, None] + xx[None, :] - 2.0 * dot, 0.0)
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dist, ids, axis=1).astype(np.float32), ids


def _data(n, d, q_n, seed, metric):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    else:  # rows of norm ~5: rounding moves the distances visibly
        x *= np.float32(5 / np.sqrt(d))
        q *= np.float32(5 / np.sqrt(d))
    return x, q


def _tol(metric):
    return dict(rtol=0.0, atol=1e-5) if metric == "cosine" else dict(
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("corpus", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_plain_scan_matches_the_tpu_meaning(precision, corpus, metric):
    x, q = _data(700, 40, 23, seed=1, metric=metric)
    xt = torch.from_numpy(x).to(getattr(torch, corpus))
    x_held = xt.float().numpy()  # the stored rows
    d, i = fused_scan_topk(torch.from_numpy(q), xt, 690, 10, metric=metric,
                           chunk_size=128, precision=precision)
    wd, wi = _tpu_topk(q, x_held[:690], 10, metric, precision)
    assert_topk_match(d, i, wd, wi, **_tol(metric))


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_the_settings_differ(metric):
    """The test data tells the settings apart: default moves distances
    far beyond the tolerance, high stays much closer to highest."""
    x, q = _data(700, 40, 23, seed=1, metric=metric)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    got = {p: fused_scan_topk(qt, xt, 700, 10, metric=metric, precision=p)[0]
           for p in PRECISIONS}
    off_default = float((got["default"] - got["highest"]).abs().max())
    off_high = float((got["high"] - got["highest"]).abs().max())
    assert off_default > 20 * _tol(metric)["atol"]
    assert off_high < off_default / 20


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("corpus", ["float32", "bfloat16"])
def test_highest_matches_the_jax_kernel(corpus, metric):
    """``highest`` over an f32 or a bf16 corpus (f32 queries against
    the stored rows) against ``pallas_distance_topk`` in interpret mode."""
    x, q = _data(600, 24, 19, seed=2, metric=metric)
    jd, ji = pallas_distance_topk(
        jnp.asarray(q), jnp.asarray(x, dtype=getattr(jnp, corpus)), 590, 8,
        metric=metric, interpret=True, chunk_size=256)
    xt = torch.from_numpy(x).to(getattr(torch, corpus))
    d, i = fused_scan_topk(torch.from_numpy(q), xt, 590, 8, metric=metric)
    assert_topk_match(d, i, np.asarray(jd), np.asarray(ji), **_tol(metric))


def test_cosine_default_on_rounded_operands_matches_the_jax_kernel():
    """HNSW's routing scan: bf16 queries and table at ``default``; the
    products are exact on the TPU and here, so the JAX kernel is the
    reference."""
    x, q = _data(520, 32, 17, seed=3, metric="cosine")
    jd, ji = pallas_distance_topk(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), 512, 8,
        metric="cosine", interpret=True, precision="default", chunk_size=256)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    d, i = fused_scan_topk(torch.from_numpy(q), xt, 512, 8, metric="cosine",
                           precision="default")
    assert_topk_match(d, i, np.asarray(jd), np.asarray(ji), rtol=0.0,
                      atol=1e-6)


def test_operands_of_each_setting():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(5, 12)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(7, 12)).astype(np.float32))
    a, b = product_operands(q, x, "highest")
    assert a is not None and torch.equal(a, q) and torch.equal(b, x)
    a, b = product_operands(q, x, "default")
    assert torch.equal(a, bf16_round(q)) and torch.equal(b, bf16_round(x))
    a, b = product_operands(q, x, "high")
    assert a.shape == (5, 36) and b.shape == (7, 36)
    hi, lo = a[:, :12], a[:, 24:]
    assert torch.equal(a[:, 12:24], hi) and torch.equal(b[:, 24:], b[:, :12])
    # hi + lo holds 16 of the 24 mantissa bits
    assert float(((hi + lo) - q).abs().max()) <= 2**-16 * float(q.abs().max())
    np.testing.assert_array_equal(bf16_round(q).numpy(), _bf16_np(q.numpy()))
    with pytest.raises(ValueError):
        product_operands(q, x, "fastest")


def test_three_bf16_parts_hold_an_f32():
    """Kernel A's bf16 routes at ``highest`` split each f32 query into
    three bf16 parts (each the rounding of what the parts before leave):
    their sum is the f32 value exactly, so the three exact products
    against a bf16 row are the f32 product. (Below 2^-100 the last part
    can fall under bf16's subnormal steps.)"""
    rng = np.random.default_rng(5)
    v = np.concatenate([
        rng.normal(size=20000).astype(np.float32),
        (rng.normal(size=2000) * 1e-25).astype(np.float32),
        (rng.normal(size=2000) * 1e30).astype(np.float32),
        np.array([1 + 2**-8, 1 + 3 * 2**-8, 1 - 2**-24, -(2**-100)],
                 np.float32),
    ])
    v = v[np.abs(v) >= 2.0**-100]
    parts, rest = [], v
    for _ in range(3):
        p = _bf16_np(rest)
        parts.append(p)
        rest = (rest - p).astype(np.float32)  # exact in f32
    assert not rest.any()
    total = sum(p.astype(np.float64) for p in parts)
    np.testing.assert_array_equal(total, v.astype(np.float64))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_dispatcher_passes_the_setting(precision):
    x, q = _data(300, 16, 9, seed=6, metric="sq_euclidean")
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    want = fused_scan_topk(qt, xt, 300, 5, precision=precision)
    for force in (None, "xla", "pallas"):
        got = cuda_topk.distance_topk(qt, xt, 300, 5, force=force,
                                      precision=precision)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = cuda_topk.distance_topk(qt, xt, 300, cuda_topk.MAX_K + 1,
                                  precision=precision)  # the k > 128 rule
    big = fused_scan_topk(qt, xt, 300, cuda_topk.MAX_K + 1, precision=precision)
    assert torch.equal(got[0], big[0])
    with pytest.raises(ValueError):
        cuda_topk.distance_topk(qt, xt, 300, 5, precision="fastest")
    with pytest.raises(ValueError):
        fused_scan_topk(qt, xt, 300, 5, precision="fastest")


def test_route_names():
    assert cuda_topk.route_name(torch.float32, "highest") == "f32/highest"
    assert cuda_topk.route_name(torch.bfloat16, "default") == "bf16/default"


def test_route_bounds_at_the_smoke_shapes():
    """Each route's least time at Q = 16384 over 1M x 300 (peaks 989
    TFLOP/s bf16, 495 TF32, 3.35 TB/s): default one bf16 product
    (9.83e12 flop, 9.94 ms), high three, a bf16 corpus at highest three
    (an f32 query in three bf16 parts) and at high two; the HNSW routing
    scan (41,547 bf16 rows, k = 8) 0.413 ms."""
    args = (16384, 1_000_000, 300, 10)
    one = 2.0 * 16384 * 1e6 * 300
    b = roofline.distance_topk_bound(*args, corpus="f32", precision="default")
    assert b["bound_by"] == "operations" and b["ops"] == one
    assert b["bound_ms"] == pytest.approx(9.94, abs=0.01)
    b = roofline.distance_topk_bound(*args, corpus="f32", precision="high")
    assert b["bound_ms"] == pytest.approx(3 * 9.94, abs=0.03)
    b = roofline.distance_topk_bound(*args, corpus="bf16", precision="highest")
    assert b["ops"] == 3 * one
    assert b["bytes"] == 4.0 * 16384 * 300 + 2.0 * 1e6 * 300 + 8.0 * 16384 * 10
    b = roofline.distance_topk_bound(*args, corpus="bf16", precision="high")
    assert b["ops"] == 2 * one
    r = roofline.distance_topk_bound(16384, 41547, 300, 8, corpus="bf16",
                                     precision="default")
    assert r["bound_ms"] == pytest.approx(0.413, abs=0.001)
    f = roofline.distance_topk_bound(*args)
    assert (f["bound_by"], round(f["bound_ms"], 1)) == ("operations", 59.6)
