"""PartitionedANNIndex: a corpus-partitioned RP-forest, the capacity
axis (counterpart of ``vers_tpu.parallel.lsh_partitioned``).

The reference holds the whole forest in one host's RAM
(`vers/src/indexes/lsh.rs:53`); ``parallel/lsh.ShardedANNIndex``
replicates that state per shard and splits the queries (throughput).
This class splits the corpus rows into contiguous blocks, one
independent forest per shard over its local rows, so each shard's
state is ~1/n_shards of the whole.

Each shard searches as the single-device forest does, all shards at
once (``mesh.map_shards``), on its own device and its own shared-corpus
tables (``ops/forest_shared``: its corpus block once, int32 index tables
per tree, one gathered tree view live at a time): the multiprobe
descent, then per tree a view gather, the packed scan (kernel B on the
card, one launch a tree) and the dedup merge. The queries are
replicated; each shard's result rows are offset into global padded rows
(``s * pern + row``), and the k·n_shards candidates gather
on the lead device for one top-k. Shards cover disjoint rows, so that
merge needs no dedup.

The JAX package pads every shard's tables to common shapes (r_blk,
G_max, num_bins) so that one compiled program serves all shards, and
keeps a tree-sorted layout for its XLA engine. Without a compiler
neither is needed: each shard's tiles are planned for its own tables
(``ANNIndex._shared_plan`` and ``ops/binned._fused_core``), which changes no result (each scan is the
exact top-k of the probed leaves), and the plain engine runs on the same
layout. The probe depth is the one all shards share: the largest of
their ``_auto_probes``, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vers_tpu_torch import graphs
from vers_tpu_torch.core import as_query_matrix, device_id_map, round_up
from vers_tpu_torch.index.lsh import ANNIndex
from vers_tpu_torch.ops.cuda_binned import scans_on_host
from vers_tpu_torch.ops.forest_shared import forest_search_shared
from vers_tpu_torch.parallel.lsh import _STATE
from vers_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    make_mesh,
    map_shards,
    merge_topk,
)
from vers_tpu_torch.parallel.partitioned import PartitionedIndexBase


class PartitionedANNIndex(PartitionedIndexBase):
    """One RP-forest per mesh shard over that shard's corpus rows.

    ``shards`` are single-device ``ANNIndex`` objects, shard s on
    ``mesh.devices[s]``, whose ids are LOCAL input ordinals
    (0..block_rows-1); ``gids[s]`` maps shard s's input ordinals to
    external ids.

    Adds always drop the assembled cache (the base default): a leaf
    split rewrites the shard's tree tables, and the cache is only the
    id map and the row padding, rebuilt on the host.
    """

    _manifest_format = "vers_tpu.partitioned_lsh.v1"
    _shard_cls = ANNIndex

    @staticmethod
    def _shard_rows(shard) -> int:
        return len(shard._ids)

    @classmethod
    def build_index(
        cls,
        num_trees: int,
        max_node_size: int,
        vectors: np.ndarray,
        vector_ids=None,
        config=None,
        mesh=None,
    ) -> "PartitionedANNIndex":
        """One forest per contiguous row block, each built on its
        shard's device."""
        mesh = mesh or make_mesh()
        n_shards = mesh.shape[SHARD_AXIS]
        vectors = np.asarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        if n < n_shards:
            raise ValueError(
                f"corpus of {n} rows cannot partition over {n_shards} shards"
            )
        if vector_ids is None:
            vector_ids = np.arange(n, dtype=np.int64)
        vector_ids = np.asarray(vector_ids, np.int64)
        base = -(-n // n_shards)
        shards, gids = [], []
        for s in range(n_shards):
            lo, hi = s * base, min((s + 1) * base, n)
            shard = ANNIndex.build_index(
                num_trees, max_node_size, vectors[lo:hi],
                np.arange(hi - lo), config=config, device=mesh.devices[s],
            )
            shards.append(shard)
            gids.append(vector_ids[lo:hi].copy())
        return cls(shards, gids=gids, mesh=mesh)

    # -- device cache ------------------------------------------------------

    def _ensure_device_cache(self):
        """The padded row space and its id maps: shard s's internal row
        r is global row ``s * pern + r``, with ``pern`` the largest
        shard's row count rounded up to 128 (the JAX package's
        layout)."""
        if self._device_cache is not None:
            return self._device_cache
        for s in self.shards:
            s._rebuild_dirty()
        n_shards = self.mesh.shape[SHARD_AXIS]
        if len({len(s._trees) for s in self.shards}) != 1:
            raise ValueError("all shards must share num_trees")
        pern = round_up(max(s._values.shape[0] for s in self.shards), 128)
        row_to_gid = np.full((n_shards * pern,), -1, np.int64)
        for s, shard in enumerate(self.shards):
            rows = shard._values.shape[0]
            # internal row -> local input ordinal -> external id
            row_to_gid[s * pern : s * pern + rows] = self.gids[s][shard._ids]
        self._device_cache = dict(
            pern=pern,
            row_to_gid=row_to_gid,
            row_to_gid_dev=device_id_map(row_to_gid, self.mesh.lead),
        )
        return self._device_cache

    # -- Index API -----------------------------------------------------------

    def _search_batch_rows(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ):
        """(dists (Q, k) f32, global padded rows (Q, k) int64, -1 =
        empty) on the lead device."""
        cache = self._ensure_device_cache()
        q = as_query_matrix(queries, self.mesh.lead)
        if probes_per_tree is None:
            n_probes = max(s._auto_probes(top_k) for s in self.shards)
            deficit_k = top_k if n_probes > 1 else 0
        else:
            n_probes = max(1, probes_per_tree)
            deficit_k = 0
        pern = cache["pern"]

        def body(s, dev, shard):
            engine = shard.config.engine
            if engine not in ("auto", "pallas", "xla"):
                raise ValueError(f"unknown engine {engine!r}")
            sh, plan = shard._shared_plan(top_k)
            plain = engine == "xla"

            def search(qs):
                d, rows = forest_search_shared(
                    qs, *(sh[k] for k in _STATE),
                    n_probes=n_probes, num_bins=sh["num_bins"], top_k=top_k,
                    deficit_k=deficit_k, plain=plain, **plan,
                )
                rows = rows.to(torch.int64)
                return d, torch.where(rows >= 0, rows + s * pern, -1)

            qs = q.to(shard.device)
            site = None if scans_on_host(top_k, plain) else self._graphs[s].site(
                ("forest", top_k, n_probes, deficit_k, pern), qs, sh)
            return graphs.run(site, "search", search, qs)

        parts = map_shards(self.mesh, body, self.shards)
        return merge_topk([d for d, _ in parts], [i for _, i in parts], top_k)
