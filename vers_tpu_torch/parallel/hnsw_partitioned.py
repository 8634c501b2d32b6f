"""PartitionedHNSWIndex: a corpus-partitioned HNSW, the capacity axis
(counterpart of ``vers_tpu.parallel.hnsw_partitioned``).

The reference holds the whole graph in one host's RAM
(`vers/src/indexes/hnsw.rs:26`); ``parallel/hnsw.ShardedHNSWIndex``
replicates that state per shard. This class splits the corpus rows into
contiguous blocks with ONE independent HNSW subgraph per shard over its
local rows, so each shard holds ~1/n_shards of a single-graph index.

Query: every shard runs its full local descent on the replicated query
batch, on its own device: the layer-1 routing scan (kernel A on the
card, k = the seed count, cosine), the multi-seeded layer-0 beam and the
f32 rescore (``ops/beam.full_descent_scan``, the single-device scan
route). Its top-k rows are offset into global padded rows
(``s * per + row``) and the k·n_shards candidates gather on the lead
device for one top-k. Shards cover disjoint rows, so that merge needs
no dedup.

Recall: each sub-search is an ANN search over an n/S-row graph with the
full ef, so the union tends to beat one graph's search at the same ef,
at S times the scan work.

The serving tables stay per shard, each on its shard's device, padded
to the shapes the JAX package gives its row-sharded arrays (``per`` rows
and ``n1_pad`` layer-1 slots a shard, one adjacency width).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vers_tpu_torch.core import as_query_matrix, device_id_map, round_up
from vers_tpu_torch.index.hnsw import HNSWIndex, resolve_beam_expand
from vers_tpu_torch.ops.beam import full_descent_scan
from vers_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh, merge_topk
from vers_tpu_torch.parallel.partitioned import PartitionedIndexBase


class PartitionedHNSWIndex(PartitionedIndexBase):
    """One HNSW subgraph per mesh shard over that shard's corpus rows.

    ``shards`` are plain single-device ``HNSWIndex`` objects with LOCAL
    identity node ids (0..n_s-1); ``gids[s]`` maps shard s's local rows
    to external ids. Construction, the single-query parity search, adds
    and persistence all work per shard; only ``search_batch`` runs over
    the mesh. Incremental adds patch the assembled serving tables in
    place (``_patch_device_cache``): the shard's own fast add already
    computed the touched adjacency rows.
    """

    _manifest_format = "vers_tpu.partitioned_hnsw.v1"
    _shard_cls = HNSWIndex

    @staticmethod
    def _shard_rows(shard) -> int:
        return shard._rows_used

    # -- construction ----------------------------------------------------

    @classmethod
    def build_index(
        cls,
        num_layers: int,
        ef_construction: int,
        ef_search: int,
        num_neighbours: int,
        vectors: np.ndarray,
        vector_ids=None,
        mesh=None,
        seed: int = 0,
        batched: bool = True,
        **build_kwargs,
    ) -> "PartitionedHNSWIndex":
        """Split ``vectors`` into contiguous row blocks and build one
        independent subgraph per shard on its device (wave-parallel by
        default; the host build with ``batched=False``). Per-shard seeds
        (``seed + s``) keep layer assignment independent across
        shards."""
        mesh = mesh or make_mesh()
        n_shards = mesh.shape[SHARD_AXIS]
        vectors = np.asarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        if vector_ids is None:
            vector_ids = np.arange(n, dtype=np.int64)
        vector_ids = np.asarray(vector_ids, np.int64)
        base = -(-max(n, 1) // n_shards)
        shards, gids = [], []
        for s, dev in enumerate(mesh.devices):
            lo, hi = s * base, min((s + 1) * base, n)
            block = vectors[lo:hi]
            if batched and block.shape[0]:
                # small shards need proportionally smaller waves: a
                # 1024-row wave would insert most of a 300-row shard
                # against a ~70-node frozen graph, and the subgraph's
                # quality (hence recall) suffers
                kwargs = dict(build_kwargs)
                kwargs.setdefault(
                    "wave_cap", min(1024, max(8, block.shape[0] // 8))
                )
                shard = HNSWIndex.build_index_batched(
                    num_layers, ef_construction, ef_search,
                    num_neighbours, block, seed=seed + s, device=dev,
                    **kwargs,
                )
            else:
                shard = HNSWIndex.build_index(
                    num_layers, ef_construction, ef_search,
                    num_neighbours, block, seed=seed + s, device=dev,
                )
            shards.append(shard)
            gids.append(vector_ids[lo:hi].copy())
        return cls(shards, gids=gids, mesh=mesh)

    # -- device cache -----------------------------------------------------

    def _ensure_device_cache(self):
        """Assemble the serving tables: every shard's graph pads to the
        common shapes on the host, then each shard's tables go to its
        device (a device-resident shard corpus is copied there
        directly)."""
        if self._device_cache is not None:
            return self._device_cache
        graphs = [s._host_graph_arrays() for s in self.shards]
        # row slack (~12.5%, min 64) so incremental adds patch in place
        # for a long stream before a block fills and forces re-assembly;
        # padding rows are inert: adjacency -1, never seeded
        max_n = max(max(g["n"], 1) for g in graphs)
        per = round_up(max_n + max(64, max_n // 8), 8)
        deg = max(
            (g["adjs"][0].shape[1] if g["adjs"] else 1) for g in graphs
        )
        max_l1 = max(max(int(g["l1_rows"].size), 1) for g in graphs)
        n1_pad = round_up(max_l1 + 16, 8)
        n_shards = self.mesh.shape[SHARD_AXIS]

        vecs, vecs_nav, adj0, l1_tab, l1_members = [], [], [], [], []
        n1s = np.zeros((n_shards,), np.int64)
        row_to_gid = np.full((n_shards * per,), -1, np.int64)
        for s, (g, dev) in enumerate(zip(graphs, self.mesh.devices)):
            n_s = g["n"]
            v = torch.zeros((per, self.dim), dtype=torch.float32, device=dev)
            a0 = np.full((per, deg), -1, np.int32)
            members = np.zeros((n1_pad,), np.int64)
            if n_s:
                if g["vecs"] is not None:
                    v[:n_s] = torch.from_numpy(g["vecs"][:n_s]).to(dev)
                else:  # device-resident shard corpus
                    v[:n_s] = self.shards[s]._corpus_dev[:n_s].to(dev)
                if g["adjs"]:
                    a = g["adjs"][0]
                    rows = min(a.shape[0], per)
                    a0[:rows, : a.shape[1]] = a[:rows]
                l1 = g["l1_rows"]
                if l1.size == 0:
                    # tiny shard with an empty layer 1: seed the beam
                    # from the first local rows instead of returning
                    # nothing
                    l1 = np.arange(min(n_s, n1_pad), dtype=np.int64)
                n1s[s] = l1.size
                members[: l1.size] = l1
                # external ids follow the shard's compact row order
                row_to_gid[s * per : s * per + n_s] = self.gids[s][
                    g["node_ids"][:n_s]
                ]
            m = torch.from_numpy(members).to(dev)
            tab = v[m].to(torch.bfloat16)
            tab[int(n1s[s]):] = 0
            vecs.append(v)
            vecs_nav.append(v.to(torch.bfloat16))
            adj0.append(torch.from_numpy(a0).to(dev))
            l1_tab.append(tab)
            l1_members.append(m)
        self._device_cache = dict(
            vecs=vecs,
            vecs_nav=vecs_nav,
            adj0=adj0,
            l1_tab=l1_tab,
            l1_members=l1_members,
            n1s=n1s,
            n1_pad=n1_pad,
            per=per,
            row_to_gid=row_to_gid,
            row_to_gid_dev=device_id_map(row_to_gid, self.mesh.lead),
        )
        return self._device_cache

    # -- Index API ---------------------------------------------------------

    def _patch_device_cache(
        self, s: int, local_id: int, emb: np.ndarray, vec_id: int
    ) -> bool:
        """Apply one insert to the assembled tables in place: a handful
        of row writes on shard s's device instead of a full re-assembly.
        Returns False (cache dropped, lazily re-assembled) when the
        shard took its host add path, its block or layer-1 slots are
        full, or a touched row outgrew the cache's adjacency width."""
        cache = self._device_cache
        shard = self.shards[s]
        patch = getattr(shard, "_last_add_patch", None)
        if patch is None or patch.get("row") != local_id:
            return False  # host-path insert: graph dicts changed shape
        per = cache["per"]
        if local_id >= per:
            return False  # shard block full: re-assemble with new slack
        deg = int(cache["adj0"][s].shape[1])
        rows, mats = [], []
        for r, a in patch["adj0"].items():
            v = a[a >= 0]
            if len(v) > deg:
                return False  # would truncate edges
            packed = np.full((deg,), -1, np.int32)
            packed[: len(v)] = v
            rows.append(int(r))
            mats.append(packed)
        n1 = int(cache["n1s"][s])
        if patch["l1_added"] and n1 >= cache["n1_pad"]:
            return False  # layer-1 slots full
        dev = self.mesh.devices[s]
        q = torch.from_numpy(np.asarray(emb, np.float32)).to(dev)
        cache["vecs"][s][local_id] = q
        cache["vecs_nav"][s][local_id] = q.to(torch.bfloat16)
        if rows:
            cache["adj0"][s][torch.tensor(rows, device=dev)] = (
                torch.from_numpy(np.stack(mats)).to(dev))
        if patch["l1_added"]:
            cache["l1_members"][s][n1] = local_id
            cache["l1_tab"][s][n1] = q.to(torch.bfloat16)
            cache["n1s"][s] = n1 + 1
        grow = s * per + local_id
        cache["row_to_gid"][grow] = vec_id
        idmap = cache["row_to_gid_dev"]
        if idmap is not None:
            if -(2**31) <= vec_id < 2**31:
                idmap[grow] = int(vec_id)
            else:
                cache["row_to_gid_dev"] = None  # host mapping only
        return True

    def _search_batch_rows(self, queries, top_k: int):
        """(dists (Q, k) f32, global padded rows (Q, k) int64, -1 =
        empty) on the lead device."""
        cache = self._ensure_device_cache()
        q = as_query_matrix(queries, self.mesh.lead)
        ef = max(max(s.ef_search for s in self.shards), top_k)
        cfg = self.shards[0].config
        seeds = getattr(cfg, "route_seeds", 0) or min(ef, 8)
        per = cache["per"]
        parts_d, parts_i = [], []
        for s, dev in enumerate(self.mesh.devices):
            d, rows = full_descent_scan(
                q.to(dev), cache["vecs"][s], cache["vecs_nav"][s],
                cache["adj0"][s], cache["l1_tab"][s],
                cache["l1_members"][s], int(cache["n1s"][s]),
                top_k=top_k, ef=ef, seeds=seeds, rescore=True,
                expand=resolve_beam_expand(cfg),
                steps_cap=getattr(cfg, "beam_steps", None),
            )
            parts_d.append(d)
            parts_i.append(torch.where(rows >= 0, rows + s * per, -1))
        return merge_topk(parts_d, parts_i, top_k)

    def get_num_nodes_in_layers(self) -> List[int]:
        """Global per-layer node counts (sum over shards)."""
        per_shard = [s.get_num_nodes_in_layers() for s in self.shards]
        depth = max(len(p) for p in per_shard)
        return [
            sum(p[l] for p in per_shard if l < len(p))
            for l in range(depth)
        ]
