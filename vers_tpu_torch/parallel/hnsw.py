"""ShardedHNSWIndex: a replicated graph, query-sharded beam search
(counterpart of ``vers_tpu.parallel.hnsw``).

Scale-out of the graph index's throughput (the reference holds the whole
HNSW in one host's RAM and serves queries in one process,
`vers/src/indexes/hnsw.rs:26`): the navigation table and adjacency are
replicated on every shard and the QUERY batch splits across the shards,
each running the single-device descent on its block of queries, all
shards at once (``mesh.map_shards``). This is
the classic layer-by-layer descent from the entry row
(``ops/beam.full_descent``: routing beams on layers L-2..1, the layer-0
beam, the f32 rescore), as the JAX package runs it here, not the
scan-routed one: the single-device counterpart is ``HNSWIndex`` with
``route_mode="beam"``. The query path needs no collective beyond putting
the blocks back in order.

A shard on another device than the wrapped index searches a copy of its
serving tables there, made by the caller before the shards start. An int8 navigation table (``nav_dtype="int8"``)
travels with its per-row scales, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vers_tpu_torch import graphs
from vers_tpu_torch.core import as_query_matrix
from vers_tpu_torch.index.hnsw import HNSWIndex, resolve_beam_expand
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.ops.beam import full_descent
from vers_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    all_gather,
    make_mesh,
    map_shards,
    normalize_device,
)


class ShardedHNSWIndex:
    """Query-sharded serving wrapper around a (host- or device-built)
    HNSWIndex. Construction and persistence delegate to the wrapped
    index; only ``search_batch`` fans out over the mesh."""

    def __init__(self, base: HNSWIndex, mesh=None):
        self.base = base
        self.mesh = mesh or make_mesh()
        self.dim = base.dim
        self._replicas = {}  # device -> (base cache it copies, the copy)
        # each shard's search graphs (``graphs``), replayed on its stream
        self._graphs = [graphs.GraphCache() for _ in self.mesh.devices]

    @classmethod
    def build_index(
        cls,
        num_layers: int,
        ef_construction: int,
        ef_search: int,
        num_neighbours: int,
        vectors: np.ndarray,
        mesh=None,
        seed: int = 0,
        batched: bool = False,
    ) -> "ShardedHNSWIndex":
        mesh = mesh or make_mesh()
        build = HNSWIndex.build_index_batched if batched else HNSWIndex.build_index
        base = build(num_layers, ef_construction, ef_search, num_neighbours,
                     vectors, seed=seed, device=mesh.lead)
        return cls(base, mesh=mesh)

    def save_index(self, file_path: str) -> None:
        self.base.save_index(file_path)

    @classmethod
    def load_index(cls, file_path: str, dim: Optional[int] = None,
                   mesh=None) -> "ShardedHNSWIndex":
        mesh = mesh or make_mesh()
        return cls(HNSWIndex.load_index(file_path, dim=dim, device=mesh.lead),
                   mesh=mesh)

    def add(self, embedding, vec_id: int) -> None:
        self.base.add(embedding, vec_id)
        for g in self._graphs:
            g.invalidate()

    def search_approximate(self, query, top_k: int):
        return self.base.search_approximate(query, top_k)

    def _tables_on(self, cache: dict, dev: torch.device):
        """(vecs, vecs_nav, nav_scales, adjs) of the base's serving cache
        as shard ``dev`` reads them (``nav_scales`` None unless the nav
        table is int8): the cache's own on the base's device, else a
        copy kept until the base's cache changes."""
        scales = cache["nav_scales"]
        if dev == normalize_device(self.base.device):
            return cache["vecs"], cache["vecs_nav"], scales, cache["adjs"]
        cached = self._replicas.get(dev)
        if cached is None or cached[0] is not cache:
            cached = (cache, (cache["vecs"].to(dev), cache["vecs_nav"].to(dev),
                              None if scales is None else scales.to(dev),
                              [a.to(dev) for a in cache["adjs"]]))
            self._replicas[dev] = cached
        return cached[1]

    def _search_batch_rows(self, queries, top_k: int):
        """(dists (Q, k) f32, compact rows (Q, k) int64, -1 = empty) on
        the lead device."""
        base = self.base
        cache = base._ensure_device_cache()
        lead = self.mesh.lead
        q = as_query_matrix(queries, lead)
        q_n = q.shape[0]
        if cache["entry"] is None or len(base.layers) < 2:
            # quirk parity: no entrypoint / single layer -> no results
            return (
                torch.full((q_n, top_k), float("inf"), device=lead),
                torch.full((q_n, top_k), -1, dtype=torch.int64, device=lead),
            )
        n_shards = self.mesh.shape[SHARD_AXIS]
        q_local = -(-q_n // n_shards)
        q = torch.nn.functional.pad(q, (0, 0, 0, q_local * n_shards - q_n))
        ef = max(base.ef_search, top_k)
        ef_route = getattr(base.config, "ef_route", None)
        ef_r = max(1, min(ef_route, ef)) if ef_route else ef
        # the replicas, copied here so that no two shards copy one cache
        tables = [self._tables_on(cache, dev) for dev in self.mesh.devices]
        expand = resolve_beam_expand(base.config)
        steps_cap = getattr(base.config, "beam_steps", None)

        def body(s, dev, tabs):
            vecs, vecs_nav, scales, adjs = tabs
            qs = q[s * q_local : (s + 1) * q_local].to(dev)
            # the graphs read the base's cache (or this card's copy of it)
            site = self._graphs[s].site(
                ("hnsw", top_k, ef, ef_r, expand, steps_cap), qs, cache)
            return full_descent(
                qs, vecs, vecs_nav, adjs[: len(base.layers) - 1],
                torch.full((q_local,), cache["entry"], dtype=torch.int64,
                           device=dev),
                top_k=top_k, ef=ef, ef_r=ef_r,
                rescore=vecs_nav.dtype != vecs.dtype, expand=expand,
                steps_cap=steps_cap, scales=scales, site=site,
            )

        parts = map_shards(self.mesh, body, tables)
        return (all_gather([d for d, _ in parts], 0)[:q_n],
                all_gather([i for _, i in parts], 0)[:q_n])

    def search_batch(self, queries, top_k: int) -> SearchResult:
        bd, bi = self._search_batch_rows(queries, top_k)
        node_ids = self.base._ensure_device_cache()["node_ids"]  # int64
        bi = bi.cpu().numpy()
        ids = np.where(
            bi >= 0,
            node_ids[np.clip(bi, 0, max(len(node_ids) - 1, 0))],
            -1,
        )
        return SearchResult(ids=ids.astype(np.int64),
                            distances=bd.cpu().numpy())
