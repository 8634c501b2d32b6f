"""ShardedANNIndex: a replicated shared-corpus forest, query-sharded
search (counterpart of ``vers_tpu.parallel.lsh``).

Scale-out of the RP-forest's throughput (the reference searches its
trees with a rayon pool inside one host's RAM, `vers/src/indexes/
lsh.rs:264-281`): every shard holds the whole forest in the
shared-corpus layout (``ops/forest_shared``: one corpus copy and int32
index tables per tree, the reference's own memory shape, `lsh.rs:44,53`)
and the QUERY batch splits across the shards. Each shard runs the
single-device search on its block of queries (multiprobe descent, then
per tree a view gather, the packed scan and the dedup merge: kernel B,
one launch a tree, on the card), all shards at once
(``mesh.map_shards``), so the query path needs no collective beyond
putting the blocks back in order.

Trees do not map to shards: they share the corpus, and candidates from
different trees must be deduplicated before ranking. Splitting the
queries keeps the dedup on each shard.

The query count is padded to a multiple of 64 rows a shard, the port's
query block (``index/lsh.Q_BLK``), and each shard's scans plan their
tiles for its own count (``ops/binned._fused_core``). A shard on another
device than the wrapped index searches a copy of its device state there,
made by the caller before the shards start.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vers_tpu_torch import graphs
from vers_tpu_torch.core import as_query_matrix
from vers_tpu_torch.index.lsh import Q_BLK, ANNIndex
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.ops.cuda_binned import scans_on_host
from vers_tpu_torch.ops.forest_shared import forest_search_shared
from vers_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    all_gather,
    make_mesh,
    map_shards,
    normalize_device,
)

# the device state that forest_search_shared reads, in argument order
_STATE = ("coeffs", "consts", "cbase", "splits", "buckets", "offsets",
          "sizes_dev", "corpus_pad", "xx", "src", "rbin", "g_first")


class ShardedANNIndex:
    """Query-sharded serving wrapper around a built ANNIndex.
    Construction, adds, and persistence delegate to the wrapped index;
    only the batched search fans out over the mesh."""

    def __init__(self, base: ANNIndex, mesh=None):
        self.base = base
        self.mesh = mesh or make_mesh()
        self.dim = base.dim
        self._replicas = {}  # device -> (base state it copies, the copy)
        # each shard's search graphs (``graphs``), replayed on its stream
        self._graphs = [graphs.GraphCache() for _ in self.mesh.devices]

    @classmethod
    def build_index(
        cls,
        num_trees: int,
        max_node_size: int,
        vectors: np.ndarray,
        vector_ids=None,
        config=None,
        mesh=None,
    ) -> "ShardedANNIndex":
        mesh = mesh or make_mesh()
        if vector_ids is None:
            vector_ids = np.arange(len(vectors))
        base = ANNIndex.build_index(
            num_trees, max_node_size, vectors, vector_ids, config=config,
            device=mesh.lead,
        )
        return cls(base, mesh=mesh)

    def save_index(self, file_path: str) -> None:
        self.base.save_index(file_path)

    @classmethod
    def load_index(cls, file_path: str, dim: Optional[int] = None,
                   mesh=None) -> "ShardedANNIndex":
        mesh = mesh or make_mesh()
        return cls(ANNIndex.load_index(file_path, dim=dim, device=mesh.lead),
                   mesh=mesh)

    def add(self, embedding, vec_id: int) -> None:
        self.base.add(embedding, vec_id)
        for g in self._graphs:
            g.invalidate()

    def search_approximate(self, query, top_k: int):
        return self.base.search_approximate(query, top_k)

    def _state_on(self, sh: dict, dev: torch.device) -> dict:
        """The base's device state ``sh`` as shard ``dev`` reads it:
        itself on the base's device, else a copy kept until the base's
        state changes."""
        if dev == normalize_device(self.base.device):
            return sh
        cached = self._replicas.get(dev)
        if cached is None or cached[0] is not sh:
            cached = (sh, {k: sh[k].to(dev) for k in _STATE})
            self._replicas[dev] = cached
        return cached[1]

    def _search_batch_rows(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ):
        """(dists (Q, k) f32, internal rows (Q, k) int32, -1 = empty)
        on the lead device."""
        base = self.base
        base._rebuild_dirty()
        q = as_query_matrix(queries, self.mesh.lead)
        q_n = q.shape[0]
        n_shards = self.mesh.shape[SHARD_AXIS]
        if probes_per_tree is None:
            n_probes = base._auto_probes(top_k)
            deficit_k = top_k if n_probes > 1 else 0
        else:
            n_probes = max(1, probes_per_tree)
            deficit_k = 0
        engine = base.config.engine
        if engine not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown engine {engine!r}")
        # per-shard blocks of whole query tiles: each shard's scans plan
        # for the PER-SHARD count
        q_pad = -(-q_n // (Q_BLK * n_shards)) * (Q_BLK * n_shards)
        q = torch.nn.functional.pad(q, (0, 0, 0, q_pad - q_n))
        q_local = q_pad // n_shards
        sh, plan = base._shared_plan(top_k)
        # the replicas, copied here so that no two shards copy one state
        states = [self._state_on(sh, dev) for dev in self.mesh.devices]

        plain = engine == "xla"

        def body(s, dev, st):
            def search(qs):
                return forest_search_shared(
                    qs, *(st[k] for k in _STATE),
                    n_probes=n_probes, num_bins=sh["num_bins"], top_k=top_k,
                    deficit_k=deficit_k, plain=plain, **plan,
                )

            qs = q[s * q_local : (s + 1) * q_local].to(dev)
            site = None if scans_on_host(top_k, plain) else self._graphs[s].site(
                ("forest", top_k, n_probes, deficit_k), qs, st)
            return graphs.run(site, "search", search, qs)

        parts = map_shards(self.mesh, body, states)
        dists = all_gather([d for d, _ in parts], 0)[:q_n]
        rows = all_gather([r for _, r in parts], 0)[:q_n]
        return dists, rows

    def search_batch(
        self, queries, top_k: int, probes_per_tree: Optional[int] = None
    ) -> SearchResult:
        dists, internal = self._search_batch_rows(
            queries, top_k, probes_per_tree
        )
        internal = internal.cpu().numpy()
        ids = self.base._ids
        ext = np.where(
            internal >= 0, ids[np.clip(internal, 0, len(ids) - 1)], -1
        )
        return SearchResult(ids=ext.astype(np.int64),
                            distances=dists.cpu().numpy())
