"""ShardedFlatIndex (counterpart of ``vers_tpu.parallel.sharded_index``):
corpus rows sharded across a device mesh with the exact scan per shard
(``parallel/search.sharded_topk``: kernel A on CUDA shards) and a top-k
merge on the lead device; sharded save/load (one file per shard and a
manifest) with an export to the single-file Flat layout.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from vers_tpu_torch.core import device_id_map
from vers_tpu_torch.index.base import Index
from vers_tpu_torch.index.flat import FlatIndex
from vers_tpu_torch.io.bincode import Reader, Writer
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh, shard_rows
from vers_tpu_torch.parallel.search import sharded_topk


class ShardedFlatIndex(Index):
    """Exact search over a row-sharded corpus.

    External ids are arbitrary; rows are distributed in contiguous
    blocks across shards with per-shard padding.
    """

    def __init__(self, vectors, ids=None, mesh=None, metric: str = "sq_euclidean"):
        vectors = np.asarray(vectors, dtype=np.float32)
        self.mesh = mesh or make_mesh()
        self.metric = metric
        self.dim = vectors.shape[1]
        n = vectors.shape[0]
        ids = np.asarray(
            ids if ids is not None else np.arange(n), dtype=np.int64
        )
        # growable host mirrors (amortized O(1) appends)
        cap = max(64, n)
        self._host_buf = np.zeros((cap, self.dim), np.float32)
        self._host_buf[:n] = vectors
        self._ids_buf = np.zeros((cap,), np.int64)
        self._ids_buf[:n] = ids
        self._n = n
        self._place()

    @property
    def _host_vectors(self) -> np.ndarray:
        return self._host_buf[: self._n]

    @property
    def _ids(self) -> np.ndarray:
        return self._ids_buf[: self._n]

    @property
    def _per(self) -> int:
        """Padded rows per shard."""
        return self._data[0].shape[0]

    def _place(self):
        """(Re-)shard the corpus with ~25% per-shard headroom so
        subsequent ``add``s are in-place writes into a shard, not
        re-shards."""
        n_shards = self.mesh.shape[SHARD_AXIS]
        base = -(-max(self._n, 1) // n_shards)
        headroom = max(8, base // 4)
        self._data, self._counts = shard_rows(
            self._host_vectors, self.mesh,
            capacity_per_shard=base + headroom,
        )
        per = self._per
        # global padded row -> external id
        mapping = np.full(per * n_shards, -1, np.int64)
        orig = 0
        for s in range(n_shards):
            c = int(self._counts[s])
            mapping[s * per : s * per + c] = self._ids[orig : orig + c]
            orig += c
        self._row_to_id = mapping
        self._row_to_id_dev = None

    @classmethod
    def build_index(cls, vectors, ids=None, mesh=None, metric="sq_euclidean"):
        return cls(vectors, ids=ids, mesh=mesh, metric=metric)

    # -- Index API ----------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """O(1) append: the new row is written into the emptiest shard's
        headroom (one row copy to its device, no re-shard); only when
        every shard's capacity is exhausted does the corpus re-place
        with grown headroom (the VectorStore doubling trick,
        capacity-padded per shard)."""
        emb = np.asarray(embedding, dtype=np.float32).reshape(1, -1)
        if self._n >= self._host_buf.shape[0]:
            new_cap = max(64, self._host_buf.shape[0] * 2)
            grown = np.zeros((new_cap, self.dim), np.float32)
            grown[: self._n] = self._host_buf[: self._n]
            self._host_buf = grown
            grown_ids = np.zeros((new_cap,), np.int64)
            grown_ids[: self._n] = self._ids_buf[: self._n]
            self._ids_buf = grown_ids
        self._host_buf[self._n] = emb[0]
        self._ids_buf[self._n] = vec_id
        self._n += 1

        per = self._per
        s = int(np.argmin(self._counts))
        if self._counts[s] >= per:
            self._place()  # all shards full: re-shard with new headroom
            return
        r = int(self._counts[s])
        part = self._data[s]
        part[r] = torch.from_numpy(emb[0]).to(part.device)
        self._counts[s] += 1
        row = s * per + r
        self._row_to_id[row] = vec_id
        cached = self._row_to_id_dev
        if (
            cached is not None
            and cached[1] is not None
            and -(2**31) <= vec_id < 2**31
        ):
            # keep the device id map fresh with one element write
            cached[1][row] = int(vec_id)
        else:
            self._row_to_id_dev = None

    def _search_batch_rows(self, queries, top_k: int):
        """Sharded search returning (dists (Q,k) f32, global padded ROW
        indices (Q,k) int64, -1 = empty) on the lead device — id
        mapping left to the callers."""
        return sharded_topk(queries, self._data, self._counts, top_k,
                            self.mesh, metric=self.metric)

    def search_batch_device(self, queries, top_k: int):
        """Device-resident sharded search: (dists (Q,k) f32, external
        ids (Q,k) int32) tensors on the lead device (the id map is kept
        there).

        External ids must fit in int32; raises ValueError otherwise
        (use ``search_batch``, which maps ids on the host in int64)."""
        d, i = self._search_batch_rows(queries, top_k)
        cached = self._row_to_id_dev
        if cached is None or cached[0] is not self._row_to_id:
            self._row_to_id_dev = (
                self._row_to_id,
                device_id_map(self._row_to_id, self.mesh.lead),
            )
            cached = self._row_to_id_dev
        idmap = cached[1]
        if idmap is None:
            raise ValueError(
                "external ids exceed int32 range; the device-resident "
                "path cannot map them — use search_batch()"
            )
        ids = torch.where(
            i >= 0, idmap[torch.clamp(i, 0, idmap.shape[0] - 1)], -1
        )
        return d, ids.to(torch.int32)

    def search_batch(self, queries, top_k: int) -> SearchResult:
        d, i = self._search_batch_rows(queries, top_k)
        i = i.cpu().numpy()
        hi = max(len(self._row_to_id) - 1, 0)
        ids = np.where(i >= 0, self._row_to_id[np.clip(i, 0, hi)], -1)
        return SearchResult(
            ids=ids.astype(np.int64), distances=d.cpu().numpy()
        )

    # -- sharded persistence -------------------------------------------

    def save_index(self, file_path: str) -> None:
        """Writes <path>.manifest.json + one <path>.shard{k} file per
        shard (each shard file is the single-file Flat layout: values
        matrix + ids)."""
        n_shards = self.mesh.shape[SHARD_AXIS]
        per = self._per
        manifest = {
            "format": "vers_tpu.sharded_flat.v1",
            "dim": self.dim,
            "metric": self.metric,
            "num_shards": int(n_shards),
            "counts": self._counts.tolist(),
        }
        with open(file_path + ".manifest.json", "w") as fp:
            json.dump(manifest, fp)
        for s in range(n_shards):
            c = int(self._counts[s])
            rows = self._data[s][:c].cpu().numpy()
            ids = self._row_to_id[s * per : s * per + c]
            with open(f"{file_path}.shard{s}", "wb") as fp:
                w = Writer(fp)
                w.vec_f32_matrix(rows)
                w.vec_u64(ids.astype(np.uint64))

    @classmethod
    def load_index(
        cls, file_path: str, dim: Optional[int] = None, mesh=None
    ) -> "ShardedFlatIndex":
        with open(file_path + ".manifest.json") as fp:
            manifest = json.load(fp)
        dim = dim or manifest["dim"]
        all_rows: List[np.ndarray] = []
        all_ids: List[np.ndarray] = []
        for s in range(manifest["num_shards"]):
            with open(f"{file_path}.shard{s}", "rb") as fp:
                r = Reader(fp)
                all_rows.append(r.vec_f32_matrix(dim))
                all_ids.append(r.vec_u64().astype(np.int64))
        vectors = np.concatenate(all_rows) if all_rows else np.zeros((0, dim), np.float32)
        ids = np.concatenate(all_ids) if all_ids else np.zeros((0,), np.int64)
        return cls(vectors, ids=ids, mesh=mesh, metric=manifest["metric"])

    def export_single_file(self, file_path: str) -> None:
        """Export to the single-file Flat layout (loads in FlatIndex).
        Serialization only: the rows stay on the host."""
        FlatIndex(self._host_vectors, ids=self._ids,
                  device="cpu").save_index(file_path)
