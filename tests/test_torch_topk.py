"""vers_tpu_torch top-k and kernel A's plain path against vers_tpu.

Inputs come from numpy seeds and go through both packages; the JAX
Pallas kernel runs in interpret mode, as its own tests run it on the
CPU. Distances are held to rtol 1e-4 / atol 1e-5 (PARITY D9: f32
matmuls summed in different orders); ids are compared tie-aware.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu.ops.pallas_topk import pallas_distance_topk
from vers_tpu.ops.topk import fused_scan_topk as jax_fused_scan_topk
from vers_tpu.ops.topk import topk_smallest as jax_topk_smallest
from vers_tpu_torch.ops import cuda_topk
from vers_tpu_torch.ops.topk import fused_scan_topk, topk_smallest
from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

torch.set_num_threads(2)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_smallest_ties_lowest_index(k):
    rng = np.random.default_rng(0)
    dist = rng.integers(0, 4, size=(50, 20)).astype(np.float32)  # many ties
    dist[3, :] = np.inf
    jd, ji = jax_topk_smallest(jnp.asarray(dist), k)
    td, ti = topk_smallest(torch.from_numpy(dist), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the rule itself: among equal values, indices ascend
    for r in range(dist.shape[0]):
        for t in range(1, k):
            if td[r, t] == td[r, t - 1]:
                assert ti[r, t] > ti[r, t - 1]


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("n,n_valid,k,chunk", [
    (500, 500, 10, 128),
    (640, 601, 7, 256),
    (300, 5, 8, 64),  # k > n_valid: (+inf, -1) tail
])
def test_fused_scan_topk_matches_jax(metric, n, n_valid, k, chunk):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    q = rng.normal(size=(33, 24)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    jd, ji = jax_fused_scan_topk(jnp.asarray(q), jnp.asarray(x), n_valid, k,
                                 metric=metric, chunk_size=chunk)
    td, ti = fused_scan_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid,
                             k, metric=metric, chunk_size=chunk)
    assert ti.dtype == torch.int32
    assert_topk_match(td, ti, np.asarray(jd), np.asarray(ji))
    if n_valid < k:
        assert (ti[:, n_valid:] == -1).all()
        assert torch.isinf(td[:, n_valid:]).all()


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_distance_topk_matches_pallas_interpret(metric):
    """The port's dispatcher (plain path on CPU tensors) against the
    JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(2)
    n, d, q_n, k = 300, 24, 17, 8
    x = rng.normal(size=(384, d)).astype(np.float32)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    pd, pi = pallas_distance_topk(
        jnp.asarray(q), jnp.asarray(x), n, k, metric=metric,
        query_tile=8, chunk_size=128, interpret=True,
    )
    before = cuda_topk.launches()
    td, ti = cuda_topk.distance_topk(torch.from_numpy(q), torch.from_numpy(x),
                                     n, k, metric=metric)
    assert cuda_topk.launches() == before  # CPU tensors never launch
    assert_topk_match(td, ti, np.asarray(pd), np.asarray(pi))
    assert max_abs_diff(td, np.asarray(pd)) < 1e-4


def test_distance_topk_large_k_routes_plain_and_counts():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    before = cuda_topk.LARGE_K_PLAIN
    td, ti = cuda_topk.distance_topk(torch.from_numpy(q), torch.from_numpy(x),
                                     400, cuda_topk.MAX_K + 2)
    assert cuda_topk.LARGE_K_PLAIN == before + 1
    jd, ji = jax_fused_scan_topk(jnp.asarray(q), jnp.asarray(x), 400,
                                 cuda_topk.MAX_K + 2)
    assert_topk_match(td, ti, np.asarray(jd), np.asarray(ji))


def test_distance_topk_unported_engines_raise():
    """"approx" and "bucket" are ported (tests/test_torch_bucket.py), and
    so is every precision (tests/test_torch_precision.py); an unknown
    engine or precision raises."""
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="force"):
        cuda_topk.distance_topk(x, x, 8, 2, force="nope")
    with pytest.raises(ValueError, match="precision"):
        cuda_topk.distance_topk(x, x, 8, 2, precision="fastest")
    d, i = cuda_topk.distance_topk(x, x, 8, 2, precision="default")
    assert d.shape == i.shape == (8, 2)


def test_kernel_input_checks_reject_cpu_tensors():
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_topk._check_inputs(x, x, 2)


def test_parity_helper_accepts_tie_swaps_only():
    want_d = np.array([[0.1, 0.2, 0.2, 0.5]], np.float32)
    want_i = np.array([[4, 7, 9, 1]])
    # equal distances in the other order: fine
    assert_topk_match(want_d, np.array([[4, 9, 7, 1]]), want_d, want_i)
    # a different id at a tie on the cut: fine
    tie_d = np.array([[0.1, 0.2, 0.5, 0.5]], np.float32)
    assert_topk_match(tie_d, np.array([[4, 7, 1, 3]]), tie_d,
                      np.array([[4, 7, 3, 1]]))
    assert_topk_match(tie_d, np.array([[4, 7, 1, 8]]), tie_d,
                      np.array([[4, 7, 1, 3]]))
    # same id set and same sorted distances, but ids paired with other
    # distances: rejected (a set-only comparison would pass this)
    with pytest.raises(AssertionError, match="id"):
        assert_topk_match(want_d, np.array([[7, 4, 9, 1]]), want_d, want_i)
    # an extra id that is not tied at the cut: rejected
    with pytest.raises(AssertionError, match="tied"):
        assert_topk_match(want_d, np.array([[4, 2, 9, 1]]), want_d, want_i)
    # distances beyond tolerance: rejected
    with pytest.raises(AssertionError, match="tolerance"):
        assert_topk_match(want_d + 1e-3, want_i, want_d, want_i)
