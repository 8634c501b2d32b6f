"""The port's mesh layer against ``vers_tpu.parallel`` on the CPU: the
JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices
(``make_mesh(8)``), the port on ``make_mesh(8, device="cpu")``: eight
shards on one device, driven by one process.

- ``make_mesh``: shards per device, the CPU only when asked for;
- ``shard_rows``: the same padded rows and counts, shard by shard;
- ``all_gather`` / ``psum``: shard order;
- ``sharded_topk``: ids exact up to equal-distance swaps, |d| within
  1e-4, -1 where the distance is inf, on both metrics and with empty
  shards;
- ``sharded_lloyd_step`` and ``sharded_build_kmeans``: the same
  centroids from the same initial rows (the JAX draws are injected
  through ``init=``), within the bf16-rounded segment sums' tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu.parallel.kmeans import (
    sharded_build_kmeans as jax_build_kmeans,
    sharded_lloyd_step as jax_lloyd_step,
)
from vers_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vers_tpu.parallel.mesh import shard_rows as jax_shard_rows
from vers_tpu.parallel.search import sharded_topk as jax_sharded_topk
from vers_tpu.utils.harness import exhaustive_batch
from vers_tpu_torch.ops.kmeans import lloyd_step
from vers_tpu_torch.parallel import (
    make_mesh,
    shard_rows,
    sharded_build_kmeans,
    sharded_lloyd_step,
    sharded_topk,
)
from vers_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, all_gather, psum
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

TOL = 1e-4


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8), make_mesh(8, device="cpu")


def test_make_mesh_on_one_device():
    mesh = make_mesh(4, device="cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.shape[SHARD_AXIS] == 4 and mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.lead == torch.device("cpu")
    assert make_mesh(device="cpu").shape[SHARD_AXIS] == 1


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(4)


@pytest.mark.parametrize("n, cap", [(100, None), (37, None), (3, None),
                                    (0, None), (100, 40), (64, 9)])
def test_shard_rows_matches_jax(meshes, n, cap):
    jmesh, tmesh = meshes
    x = np.arange(max(n, 0) * 4, dtype=np.float32).reshape(n, 4) + 1
    jxs, jcounts = jax_shard_rows(x, jmesh, capacity_per_shard=cap)
    parts, counts = shard_rows(x, tmesh, capacity_per_shard=cap)
    assert len(parts) == 8
    assert all(p.device == torch.device("cpu") for p in parts)
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), np.asarray(jxs))
    assert int(counts.sum()) == n


def test_collectives_keep_shard_order():
    parts = [torch.full((2, 3), float(s)) for s in range(4)]
    g = all_gather(parts, 1)
    assert g.shape == (2, 12)
    assert g[0].tolist() == [0.0] * 3 + [1.0] * 3 + [2.0] * 3 + [3.0] * 3
    assert torch.equal(psum(parts), torch.full((2, 3), 6.0))
    assert torch.equal(parts[0], torch.zeros(2, 3))  # psum copies


def _global_to_orig(per, counts):
    """Map global padded rows back to original row ordinals."""
    mapping = np.full(per * len(counts), -1, np.int64)
    orig = 0
    for s, c in enumerate(counts):
        mapping[s * per : s * per + c] = np.arange(orig, orig + c)
        orig += c
    return mapping


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("n, k", [(500, 10), (5, 10), (61, 1)])
def test_sharded_topk_matches_jax(meshes, metric, n, k):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    jxs, jcounts = jax_shard_rows(x, jmesh)
    jd, ji = jax_sharded_topk(jnp.asarray(q), jxs, jcounts, k, jmesh,
                              metric=metric, chunk_size=64)
    parts, counts = shard_rows(x, tmesh)
    td, ti = sharded_topk(q, parts, counts, k, tmesh, metric=metric,
                          chunk_size=64)
    assert td.shape == (9, k) and ti.dtype == torch.int64
    assert_topk_match(td, ti, np.asarray(jd), np.asarray(ji), rtol=0.0,
                      atol=TOL)
    # -1 exactly where the distance is inf (k > n leaves empty slots)
    assert torch.equal(ti < 0, torch.isinf(td))
    assert int((ti >= 0).sum(dim=1).min()) == min(k, n)


def test_sharded_topk_exact(meshes, rng):
    _, tmesh = meshes
    x = rng.normal(size=(500, 16)).astype(np.float32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    parts, counts = shard_rows(x, tmesh)
    _, i = sharded_topk(torch.from_numpy(q), parts, counts, 10, tmesh,
                        chunk_size=64)
    got = _global_to_orig(parts[0].shape[0], counts)[i.numpy()]
    truth = exhaustive_batch(x, q, 10)
    for r in range(q.shape[0]):
        assert set(got[r]) == set(truth[r])


def test_sharded_topk_rejects_a_wrong_shard_count(meshes):
    _, tmesh = meshes
    parts, counts = shard_rows(np.ones((16, 4), np.float32),
                               make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="4 shards"):
        sharded_topk(np.ones((1, 4), np.float32), parts, counts, 2, tmesh)


def test_sharded_lloyd_matches_jax(meshes, rng):
    jmesh, tmesh = meshes
    x = rng.normal(size=(300, 8)).astype(np.float32)
    c0 = x[:4].copy()
    jxs, jcounts = jax_shard_rows(x, jmesh)
    jc, jcost = jax_lloyd_step(jxs, jcounts, jnp.asarray(c0), jmesh,
                               chunk_size=64)
    parts, counts = shard_rows(x, tmesh)
    tc, tcost = sharded_lloyd_step(parts, counts, torch.from_numpy(c0), tmesh,
                                   chunk_size=64)
    # both sum bf16-rounded rows into f32, in other orders
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    # and the same step on one device, from the port's own k-means
    data = torch.from_numpy(x)
    sc, scost = lloyd_step(data, 300, torch.from_numpy(c0), chunk_size=64)
    np.testing.assert_allclose(tc.numpy(), sc.numpy(), rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(float(tcost), float(scost), rtol=1e-5)


def _jax_init(key, counts, per, x_padded, k):
    """The JAX package's initial centroids: k valid rows drawn by
    ``jax.random.randint`` (``parallel/kmeans.py:67-77``)."""
    valid = np.concatenate([s * per + np.arange(c) for s, c in enumerate(counts)])
    pick = np.asarray(jax.random.randint(key, (k,), 0, max(len(valid), 1)))
    return x_padded[valid[pick]]


def _counting(monkeypatch, module, steps):
    real = module.sharded_lloyd_step

    def step(*a, **kw):
        steps.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, "sharded_lloyd_step", step)


@pytest.mark.parametrize("k", [2, 6])
def test_sharded_build_kmeans_matches_jax(monkeypatch, meshes, k):
    """The same centroids and cost from the same initial rows, after the
    same number of Lloyd steps (4 at k = 2, 9 at k = 6, the final cost's
    step included): the bitwise convergence test stops both at the same
    iteration here, although their psums add in other orders."""
    import vers_tpu.parallel.kmeans as jax_kmeans
    import vers_tpu_torch.parallel.kmeans as port_kmeans

    jax_steps, port_steps = [], []
    _counting(monkeypatch, jax_kmeans, jax_steps)
    _counting(monkeypatch, port_kmeans, port_steps)
    jmesh, tmesh = meshes
    rng = np.random.default_rng(11)
    a = rng.normal(size=(64, 8)).astype(np.float32) + 10
    b = rng.normal(size=(69, 8)).astype(np.float32) - 10
    x = np.concatenate([a, b])
    jxs, jcounts = jax_shard_rows(x, jmesh)
    key = jax.random.PRNGKey(0)
    jc, jcost = jax_build_kmeans(key, jxs, jcounts, k, 10, jmesh, chunk_size=64)
    parts, counts = shard_rows(x, tmesh)
    init = _jax_init(key, counts, parts[0].shape[0], np.asarray(jxs), k)
    tc, tcost = sharded_build_kmeans(None, parts, counts, k, 10, tmesh,
                                     chunk_size=64,
                                     init=torch.from_numpy(init))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0.0, atol=1e-4)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    assert len(port_steps) == len(jax_steps) < 11, (port_steps, jax_steps)
    if k == 2:  # the two blobs
        np.testing.assert_allclose(sorted(tc.numpy().mean(1).tolist()),
                                   [-10, 10], atol=1.5)


def test_sharded_build_kmeans_draws_valid_rows(meshes):
    _, tmesh = meshes
    rng = np.random.default_rng(12)
    x = rng.normal(size=(37, 4)).astype(np.float32) + 5.0
    parts, counts = shard_rows(x, tmesh)
    gen = torch.Generator().manual_seed(3)
    c, cost = sharded_build_kmeans(gen, parts, counts, 12, 0, tmesh)
    # zero iterations: the draws themselves, each a live row (padding
    # rows are zero, the data is not)
    assert c.shape == (12, 4)
    assert bool((c.abs().sum(dim=1) > 0).all())
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in c.tolist())
    assert np.isfinite(float(cost))


def _no_mesh_calls():
    x = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    from vers_tpu_torch import parallel as par

    return {
        "ShardedFlatIndex": lambda: par.ShardedFlatIndex(x),
        "ShardedIVFFlatIndex": lambda: par.ShardedIVFFlatIndex.build_index(
            4, 1, 2, x),
        "ShardedANNIndex": lambda: par.ShardedANNIndex.build_index(2, 8, x),
        "ShardedHNSWIndex": lambda: par.ShardedHNSWIndex.build_index(
            2, 8, 8, 4, x),
        "PartitionedANNIndex": lambda: par.PartitionedANNIndex.build_index(
            2, 8, x),
        "PartitionedHNSWIndex": lambda: par.PartitionedHNSWIndex.build_index(
            2, 8, 8, 4, x),
    }


@pytest.mark.parametrize("name", sorted(_no_mesh_calls()))
def test_classes_without_a_mesh_need_a_card(monkeypatch, name):
    """No fallback: without a mesh every class asks ``make_mesh()`` for
    the cards, which raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _no_mesh_calls()[name]()
