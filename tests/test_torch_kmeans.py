"""vers_tpu_torch k-means against vers_tpu.ops.kmeans on the same data.

Both packages get the same rows and, where the JAX side draws initial
centroids with jax.random, the port is handed those same centroids.
Tolerances: the segment-sum adds bf16-rounded rows in f32 in another
order (atol 1e-4 on sums and centroids); assignments are compared on
well-separated data, where f32 rounding cannot flip an argmin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu.ops import kmeans as jk
from vers_tpu_torch.ops import kmeans as tk

torch.set_num_threads(2)


def _blobs(n, d, k, seed, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d)).astype(np.float32)), centers


@pytest.mark.parametrize("n,n_valid,chunk", [(1024, 1000, 256), (640, 640, 4096)])
def test_partial_sums_matches_jax(n, n_valid, chunk):
    x, _ = _blobs(n, 16, 6, seed=0)
    rng = np.random.default_rng(1)
    cents = rng.normal(size=(9, 16)).astype(np.float32) * 4
    js, jc, jcost = jk.partial_sums(jnp.asarray(x), n_valid, jnp.asarray(cents),
                                    chunk_size=chunk)
    ts, tc, tcost = tk.partial_sums(torch.from_numpy(x), n_valid,
                                    torch.from_numpy(cents), chunk_size=chunk)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)


def test_centroids_from_sums_empty_cluster_is_zero():
    rng = np.random.default_rng(2)
    sums = rng.normal(size=(5, 7)).astype(np.float32)
    counts = np.array([3, 0, 1, 7, 0], np.float32)
    want = np.asarray(jk.centroids_from_sums(jnp.asarray(sums), jnp.asarray(counts)))
    got = tk.centroids_from_sums(torch.from_numpy(sums), torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (got[1] == 0).all() and (got[4] == 0).all()


def _jax_inits(key, data, n_valid, k, attempts):
    keys = jax.random.split(key, attempts)
    return np.stack([
        np.asarray(jk.init_centroids(kk, data, n_valid, k)) for kk in keys
    ])


@pytest.mark.parametrize("attempts,iters", [(2, 10), (3, 2)])
def test_build_kmeans_restarts_with_jax_init(attempts, iters):
    x, _ = _blobs(1500, 12, 8, seed=3)
    n_pad = 1536
    xp = np.pad(x, ((0, n_pad - len(x)), (0, 0)))
    key = jax.random.PRNGKey(0)
    init = _jax_inits(key, jnp.asarray(xp), len(x), 8, attempts)
    jc, jcost = jk.build_kmeans_restarts(key, jnp.asarray(xp), len(x), 8,
                                         attempts, iters)
    tc, tcost = tk.build_kmeans_restarts(None, torch.from_numpy(xp), len(x), 8,
                                         attempts, iters,
                                         init=torch.from_numpy(init))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-4)


def test_assign_clusters_matches_jax():
    x, centers = _blobs(2000, 10, 12, seed=4)
    x = np.pad(x, ((0, 48), (0, 0)))
    ja = np.asarray(jk.assign_clusters(jnp.asarray(x), 2000, jnp.asarray(centers),
                                       chunk_size=512))
    ta = tk.assign_clusters(torch.from_numpy(x), 2000, torch.from_numpy(centers),
                            chunk_size=512)
    assert ta.dtype == torch.int32 and ta.shape == (2048,)
    np.testing.assert_array_equal(ta.numpy()[:2000], ja[:2000])


def test_build_kmeans_draws_rows_from_generator():
    """The port's own random init: k rows of the live data, reproducible
    from the generator's seed."""
    x, _ = _blobs(300, 4, 3, seed=5)
    xt = torch.from_numpy(np.pad(x, ((0, 84), (0, 0))))
    a = tk.init_centroids(torch.Generator().manual_seed(7), xt, 300, 16)
    b = tk.init_centroids(torch.Generator().manual_seed(7), xt, 300, 16)
    assert torch.equal(a, b)
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in a.tolist())
