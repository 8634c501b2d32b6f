"""Shared scaffolding for corpus-partitioned indexes (counterpart of
``vers_tpu.parallel.partitioned``).

A partitioned index holds one independent single-device sub-index per
mesh shard over that shard's corpus rows (capacity scale-out: the
reference keeps each whole index in one host's RAM, e.g.
`vers/src/indexes/hnsw.rs:26`, `lsh.rs:53`). This base class carries
what the graph and forest variants share:

- emptiest-shard add routing (with a hook to patch the assembled device
  cache in place, so a single insert need not rebuild it),
- the single-query parity search (per-shard host descent, global merge),
- global-row -> external-id mapping for ``search_batch`` /
  ``search_batch_device`` (with the int32 guard on the device path),
- the manifest + per-shard-file + ids-file persistence layout.

Subclasses provide the device cache, the batched search and the shard
class; see ``parallel/hnsw_partitioned.py`` and
``parallel/lsh_partitioned.py``.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from vers_tpu_torch import graphs
from vers_tpu_torch.io.bincode import Reader, Writer
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh


class PartitionedIndexBase:
    """Common behavior for corpus-partitioned indexes.

    ``shards`` are plain single-device index objects with LOCAL ids
    (0..n_s-1), shard s on ``mesh.devices[s]``; ``gids[s]`` maps shard
    s's local rows to external ids.
    """

    _manifest_format: str = ""   # manifest "format" value
    _shard_cls = None            # single-device index class (save/load)

    def __init__(self, shards: List, gids=None, mesh=None):
        self.mesh = mesh or make_mesh()
        n_shards = self.mesh.shape[SHARD_AXIS]
        if len(shards) != n_shards:
            raise ValueError(
                f"{len(shards)} shards for a {n_shards}-device mesh"
            )
        self.shards = shards
        self.dim = next((s.dim for s in shards if s.dim), 0)
        if gids is None:
            offs = np.cumsum(
                [0] + [self._shard_rows(s) for s in shards]
            )
            gids = [
                np.arange(offs[i], offs[i + 1], dtype=np.int64)
                for i in range(n_shards)
            ]
        self.gids = [np.asarray(g, np.int64) for g in gids]
        self._device_cache = None
        # each shard's search graphs (``graphs``), replayed on its stream
        self._graphs = [graphs.GraphCache() for _ in shards]

    # -- subclass hooks ----------------------------------------------------

    @staticmethod
    def _shard_rows(shard) -> int:
        """Occupied row count of one shard (default-gids + routing)."""
        raise NotImplementedError

    def _ensure_device_cache(self) -> dict:
        """The assembled search state; holds at least ``row_to_gid``
        (global padded row -> external id, int64 host) and
        ``row_to_gid_dev`` (its int32 copy on the lead device, or None
        past int32)."""
        raise NotImplementedError

    def _search_batch_rows(self, queries, top_k: int, **kw):
        """Batched mesh search returning (dists, global padded rows)."""
        raise NotImplementedError

    def _patch_device_cache(
        self, s: int, local_id: int, emb: np.ndarray, vec_id: int
    ) -> bool:
        """Try to apply one insert to the assembled device cache in
        place. Return False to drop the cache instead (the next search
        re-assembles). Default: always re-assemble."""
        return False

    # -- Index API -----------------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """Route the insert to the emptiest shard (its local incremental
        add: leaf-split / graph-insert semantics live in the shard), so
        each shard's state stays ~1/n_shards as the index grows. The
        assembled device cache is patched in place when the subclass
        supports it, else dropped (re-assembled lazily)."""
        s = int(np.argmin([len(g) for g in self.gids]))
        shard = self.shards[s]
        for g in self._graphs:
            g.invalidate()
        emb = np.asarray(embedding, np.float32).reshape(-1)
        local_id = int(len(self.gids[s]))
        shard.add(emb, local_id)
        self.gids[s] = np.append(self.gids[s], np.int64(vec_id))
        if self._device_cache is not None and not self._patch_device_cache(
            s, local_id, emb, vec_id
        ):
            self._device_cache = None

    def search_approximate(self, query, top_k: int):
        """Single-query parity path: every shard's host descent, global
        merge by distance."""
        out = []
        for s, shard in enumerate(self.shards):
            for lid, dist in shard.search_approximate(query, top_k):
                out.append((float(dist), int(self.gids[s][lid])))
        out.sort()
        return [(gid, dist) for dist, gid in out[:top_k]]

    def search_batch(self, queries, top_k: int, **kw) -> SearchResult:
        bd, bi = self._search_batch_rows(queries, top_k, **kw)
        row_to_gid = self._device_cache["row_to_gid"]
        bi = bi.cpu().numpy()
        hi = max(len(row_to_gid) - 1, 0)
        ids = np.where(bi >= 0, row_to_gid[np.clip(bi, 0, hi)], -1)
        return SearchResult(
            ids=ids.astype(np.int64), distances=bd.cpu().numpy()
        )

    def search_batch_device(self, queries, top_k: int, **kw):
        """Device-resident variant: (dists (Q, k) f32, external ids
        (Q, k) int32) on the lead device. External ids must fit in
        int32; raises ValueError otherwise (use ``search_batch``)."""
        bd, bi = self._search_batch_rows(queries, top_k, **kw)
        idmap = self._device_cache["row_to_gid_dev"]
        if idmap is None:
            raise ValueError(
                "external ids exceed int32 range; use search_batch()"
            )
        ids = torch.where(
            bi >= 0, idmap[torch.clamp(bi, 0, idmap.shape[0] - 1)], -1
        )
        return bd, ids.to(torch.int32)

    # -- persistence -----------------------------------------------------------

    def save_index(self, file_path: str) -> None:
        """<path>.manifest.json + one <path>.shard{s} per shard (each a
        standard single-file bincode layout with LOCAL ids, loadable by
        the single-device class) + <path>.ids (bincode: one vec_u64 of
        external ids per shard, local-row order)."""
        manifest = {
            "format": self._manifest_format,
            "dim": self.dim,
            "num_shards": len(self.shards),
        }
        with open(file_path + ".manifest.json", "w") as fp:
            json.dump(manifest, fp)
        for s, shard in enumerate(self.shards):
            shard.save_index(f"{file_path}.shard{s}")
        with open(file_path + ".ids", "wb") as fp:
            w = Writer(fp)
            for g in self.gids:
                w.vec_u64(g.astype(np.uint64))

    @classmethod
    def load_index(
        cls, file_path: str, dim: Optional[int] = None, mesh=None
    ):
        """Each shard loads onto its own mesh device."""
        mesh = mesh or make_mesh()
        with open(file_path + ".manifest.json") as fp:
            manifest = json.load(fp)
        fmt = manifest.get("format")
        if fmt != cls._manifest_format:
            raise ValueError(
                f"{file_path}: manifest format {fmt!r} is not "
                f"{cls._manifest_format!r}"
            )
        if manifest["num_shards"] != mesh.size:
            raise ValueError(
                f"{manifest['num_shards']} shards for a {mesh.size}-device "
                "mesh"
            )
        dim = dim or manifest.get("dim")
        shards = [
            cls._shard_cls.load_index(f"{file_path}.shard{s}", dim=dim,
                                      device=mesh.devices[s])
            for s in range(manifest["num_shards"])
        ]
        with open(file_path + ".ids", "rb") as fp:
            r = Reader(fp)
            gids = [
                r.vec_u64().astype(np.int64)
                for _ in range(manifest["num_shards"])
            ]
        return cls(shards, gids=gids, mesh=mesh)
