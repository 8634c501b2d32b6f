"""The ported slice as a whole: vers_tpu_torch's FlatIndex and
IVFFlatIndex against vers_tpu's on the same index state.

A JAX index is built, its state carried over with ``from_numpy``, and
both packages answer the same queries. Ids are compared tie-aware,
distances to atol 1e-4 (f32 matmuls summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vers_tpu
import vers_tpu_torch
from vers_tpu.ops import kmeans as jk
from vers_tpu_torch.ops import cuda_binned
from vers_tpu_torch.utils.data import synthetic_gaussian
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

N, D, K, Q = 4000, 32, 24, 150


@pytest.fixture(scope="module")
def data():
    x, q = synthetic_gaussian(N, D, n_clusters=12, n_queries=Q, seed=0,
                              normalized=True, query_noise=0.5)
    return x, q


@pytest.fixture(scope="module")
def jax_ivf(data):
    x, _ = data
    idx = vers_tpu.IVFFlatIndex.build_index(K, 2, 10, x)
    idx._materialize_host()
    return idx


def _carry(jidx, config=None):
    kw = dict(device="cpu") if config is None else dict(config=config,
                                                         device="cpu")
    return vers_tpu_torch.IVFFlatIndex.from_numpy(
        jidx.num_centroids, jidx._values, jidx._centroids, jidx._assignments,
        jidx._ids, **kw,
    )


def _match(got, want, atol=1e-4):
    assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                      rtol=0.0, atol=atol)


@pytest.mark.parametrize("nprobe", [0, 1, 2, 4])
def test_ivf_search_batch_matches_jax(data, jax_ivf, nprobe):
    _, q = data
    tidx = _carry(jax_ivf)
    want = jax_ivf.search_batch(q, 10, nprobe=nprobe)
    got = tidx.search_batch(q, 10, nprobe=nprobe)
    assert got.ids.dtype == np.int64 and got.ids.shape == (Q, 10)
    _match(got, want)


def test_ivf_large_k_takes_counted_plain_path(data, jax_ivf):
    _, q = data
    before = cuda_binned.LARGE_K_PLAIN
    got = _carry(jax_ivf).search_batch(q[:20], 130, nprobe=2)
    assert cuda_binned.LARGE_K_PLAIN == before + 1
    _match(got, jax_ivf.search_batch(q[:20], 130, nprobe=2))


def test_ivf_kernel_engine_takes_any_precision(data, jax_ivf):
    """``precision`` reaches only the plain ("xla") engine; the kernel
    engine is f32-exact whatever it says, as in the JAX package."""
    _, q = data
    jcfg = vers_tpu.IVFFlatConfig(precision="default", engine="pallas")
    jidx = vers_tpu.IVFFlatIndex(
        jax_ivf.num_centroids, jax_ivf._values, jax_ivf._centroids,
        jax_ivf._assignments, jax_ivf._ids, jcfg)
    for engine in ("pallas", "auto"):
        tcfg = vers_tpu_torch.IVFFlatConfig(precision="default", engine=engine)
        _match(_carry(jax_ivf, tcfg).search_batch(q, 10, nprobe=2),
               jidx.search_batch(q, 10, nprobe=2))
    tcfg = vers_tpu_torch.IVFFlatConfig(precision="default", engine="xla")
    with pytest.raises(ValueError, match="precision"):
        _carry(jax_ivf, tcfg).search_batch(q, 10, nprobe=2)


def test_ivf_search_approximate_matches_jax(data, jax_ivf):
    _, q = data
    tidx = _carry(jax_ivf)
    for i in range(5):
        assert tidx.search_approximate(q[i], 10) == jax_ivf.search_approximate(
            q[i], 10)


def test_ivf_add_then_search_matches_jax(data):
    x, q = data
    jidx = vers_tpu.IVFFlatIndex.build_index(K, 1, 5, x)
    jidx._materialize_host()
    tidx = _carry(jidx)
    # build both layouts first, so add patches them in place
    jidx.search_batch(q[:4], 5, nprobe=1)
    tidx.search_batch(q[:4], 5, nprobe=1)
    new = q[:3] * 1.0001
    for v in new:
        jidx.add(v, 99999)  # caller ids are ignored (PARITY #7)
        tidx.add(v, 99999)
    got = tidx.search_batch(new, 5, nprobe=1)
    assert list(got.ids[:, 0]) == [N, N + 1, N + 2]
    _match(got, jidx.search_batch(new, 5, nprobe=1))
    _match(tidx.search_batch(q, 10, nprobe=0), jidx.search_batch(q, 10, nprobe=0))
    tidx.add_batch(q[3:6])
    jidx.add_batch(q[3:6])
    _match(tidx.search_batch(q, 10, nprobe=2), jidx.search_batch(q, 10, nprobe=2))


def test_ivf_build_with_jax_init_matches_jax(data):
    """The port's build, handed the JAX build's initial centroids,
    reaches the same centroids and assignments."""
    x, _ = data
    n_pad = ((N + 127) // 128) * 128
    xp = jnp.asarray(np.pad(x, ((0, n_pad - N), (0, 0))))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    init = np.stack([np.asarray(jk.init_centroids(kk, xp, N, K)) for kk in keys])
    jidx = vers_tpu.IVFFlatIndex.build_index(K, 2, 10, x)
    tidx = vers_tpu_torch.IVFFlatIndex.build_index(
        K, 2, 10, x, init=torch.from_numpy(init), device="cpu")
    np.testing.assert_allclose(tidx._centroids, jidx._centroids, atol=1e-4)
    np.testing.assert_array_equal(tidx._assignments, jidx._assignments)
    assert tidx._ids == jidx._ids


def test_ivf_build_index_device_matches_host_build(data):
    x, q = data
    n_pad = ((N + 127) // 128) * 128
    xt = torch.from_numpy(np.pad(x, ((0, n_pad - N), (0, 0))))
    host = vers_tpu_torch.IVFFlatIndex.build_index(K, 2, 5, x, device="cpu")
    dev = vers_tpu_torch.IVFFlatIndex.build_index_device(K, 2, 5, xt, n_valid=N)
    np.testing.assert_array_equal(dev._centroids_host(), host._centroids)
    a = dev.search_batch(q, 10, nprobe=2)
    b = host.search_batch(q, 10, nprobe=2)
    _match(a, b, atol=0.0)
    dev.add(q[0], 0)
    assert dev.search_batch(q[:1], 1, nprobe=1).ids[0, 0] == N
    dev._materialize_host()
    assert dev._values.shape == (N + 1, D)


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_flat_matches_jax(data, metric):
    x, q = data
    ids = np.arange(N, dtype=np.int64) * 3 + 7
    jcfg = vers_tpu.FlatConfig(metric=metric)
    tcfg = vers_tpu_torch.FlatConfig(metric=metric)
    jidx = vers_tpu.FlatIndex(x, ids=ids, config=jcfg)
    tidx = vers_tpu_torch.FlatIndex.from_numpy(x, ids, config=tcfg,
                                               device="cpu")
    _match(tidx.search_batch(q, 10), jidx.search_batch(q, 10))
    jidx.add(q[0], 5)
    tidx.add(q[0], 5)
    got = tidx.search_batch(q[:2], 3)
    assert got.ids[0, 0] == 5
    _match(got, jidx.search_batch(q[:2], 3))
    # a corpus smaller than top_k pads with (inf, -1)
    small = vers_tpu_torch.FlatIndex(x[:3], device="cpu")
    r = small.search_batch(q[:2], 5)
    assert (r.ids[:, 3:] == -1).all() and np.isinf(r.distances[:, 3:]).all()


def test_flat_unported_engines_raise(data):
    """Every engine of the JAX package is ported; an unknown one and the
    unported bf16 store raise."""
    x, q = data
    idx = vers_tpu_torch.FlatIndex(
        x[:100], config=vers_tpu_torch.FlatConfig(engine="nope"),
        device="cpu")
    with pytest.raises(ValueError, match="engine"):
        idx.search_batch(q, 5)
    with pytest.raises(ValueError, match="float32"):
        vers_tpu_torch.FlatIndex(
            x[:100], config=vers_tpu_torch.FlatConfig(dtype="bfloat16"),
            device="cpu")


def test_recall_and_exhaustive_match_jax(data):
    x, q = data
    assert vers_tpu_torch.search_exhaustive(x, q[0], 5) == vers_tpu.search_exhaustive(
        x, q[0], 5)
    truth = vers_tpu_torch.FlatIndex(x, device="cpu").search_batch(q, 10).ids
    pred = np.roll(truth, 1, axis=1)
    pred[:, 0] = -1
    assert vers_tpu_torch.recall_at_k(pred, truth) == vers_tpu.recall_at_k(pred, truth)
