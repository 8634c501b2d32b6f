"""Sharded exact search (counterpart of ``vers_tpu.parallel.search``):
each shard runs the fused distance + top-k scan over its corpus rows
(kernel A on a CUDA shard, its plain version on a CPU shard; kernel C
takes a shard's final k where kernel A split its rows), all shards at
once (``mesh.map_shards``), then the k·n_shards candidates gather on the
lead device for one re-top-k.
"""

from __future__ import annotations

import torch

from vers_tpu_torch.core import as_query_matrix
from vers_tpu_torch.ops.cuda_topk import distance_topk
from vers_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, map_shards, merge_topk


def sharded_topk(
    queries,
    corpus_sharded,          # per shard (per, d), as shard_rows returns
    counts_sharded,          # (S,) valid rows per shard
    k: int,
    mesh: Mesh,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
    axis: str = SHARD_AXIS,
):
    """Replicated queries, sharded corpus -> exact global top-k.
    Returns (dists (Q, k) f32, global padded row ids (Q, k) int64, -1
    where the distance is inf) on the lead device. Equal distances keep
    the lower shard, then the lower row."""
    if len(corpus_sharded) != mesh.shape[axis]:
        raise ValueError(
            f"{len(corpus_sharded)} shards for a {mesh.shape[axis]}-shard mesh")

    def body(s, dev, x, count):
        d, i = distance_topk(as_query_matrix(queries, dev), x, int(count), k,
                             metric=metric, chunk_size=chunk_size)
        i = i.to(torch.int64)
        return d, torch.where(i >= 0, i + s * x.shape[0], -1)

    parts = map_shards(mesh, body, corpus_sharded, counts_sharded)
    return merge_topk([d for d, _ in parts], [i for _, i in parts], k)
