"""Distributed Lloyd k-means (counterpart of ``vers_tpu.parallel.kmeans``):
per-shard assignment + accumulation (``ops/kmeans.partial_sums``, all
shards at once through ``mesh.map_shards``) and a ``psum`` of (sums,
counts, cost) across the mesh — the multi-device version of IVFFlat's
build (`vers/src/indexes/ivfflat.rs:73-100`, whose parallelism was a
rayon pool on one host).

The sums run in shard order on the lead device; the JAX package's
all-reduce may add them in another order, so centroids agree with it to
f32 rounding, not bit for bit, and the bitwise convergence test may stop
one package an iteration before the other.

Random draws. The JAX package draws the initial rows with
``jax.random.randint``; ``sharded_build_kmeans`` draws them with a
``torch.Generator`` instead, or takes them injected (``init``).
"""

from __future__ import annotations

import torch

from vers_tpu_torch.core import bitwise_equal
from vers_tpu_torch.ops.kmeans import centroids_from_sums, partial_sums
from vers_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, map_shards, psum


def _psum_partials(data_sharded, counts_sharded, centroids, mesh: Mesh,
                   chunk_size: int):
    def body(s, dev, x, count):
        return partial_sums(x, int(count), centroids.to(dev), chunk_size)

    sums, counts, costs = zip(*map_shards(mesh, body, data_sharded,
                                          counts_sharded))
    return psum(sums), psum(counts), psum(costs)


def sharded_lloyd_step(
    data_sharded,
    counts_sharded,
    centroids: torch.Tensor,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    chunk_size: int = 65536,
):
    """One global Lloyd iteration. Returns (new_centroids, cost of the
    old ones) on the lead device."""
    sums, counts, cost = _psum_partials(
        data_sharded, counts_sharded, centroids.to(mesh.lead), mesh,
        chunk_size)
    return centroids_from_sums(sums, counts), cost


def sharded_build_kmeans(
    generator,
    data_sharded,
    counts_sharded,
    k: int,
    max_iterations: int,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    chunk_size: int = 65536,
    init: torch.Tensor | None = None,
):
    """Full distributed Lloyd run with the reference's bitwise
    convergence rule (`ivfflat.rs:84-93`). Host-orchestrated loop; every
    iteration is one sharded step. The initial centroids are ``init``
    (k, d) when given, else k VALID rows (shards are padded
    independently) drawn with replacement by ``generator``. Returns
    (centroids, cost) on the lead device."""
    lead = mesh.lead
    if init is not None:
        centroids = init.to(device=lead, dtype=torch.float32)
    else:
        per = data_sharded[0].shape[0]
        valid_rows = torch.cat([
            s * per + torch.arange(int(c)) for s, c in enumerate(counts_sharded)
        ])
        pick = torch.randint(0, max(len(valid_rows), 1), (k,),
                             generator=generator,
                             device=generator.device).cpu()
        rows = valid_rows[pick]
        shard_of, local = rows // per, rows % per
        centroids = torch.empty((k,) + data_sharded[0].shape[1:],
                                dtype=torch.float32, device=lead)
        for s, (x, dev) in enumerate(zip(data_sharded, mesh.devices)):
            mine = shard_of == s
            if bool(mine.any()):
                centroids[mine.to(lead)] = x[local[mine].to(dev)].to(lead)

    for _ in range(max_iterations):
        new_centroids, _ = sharded_lloyd_step(
            data_sharded, counts_sharded, centroids, mesh, axis, chunk_size
        )
        if bitwise_equal(centroids, new_centroids):
            break
        centroids = new_centroids
    _, final_cost = sharded_lloyd_step(
        data_sharded, counts_sharded, centroids, mesh, axis, chunk_size
    )
    return centroids, final_cost
