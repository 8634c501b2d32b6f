"""ShardedIVFFlatIndex — IVFFlat over a device mesh (counterpart of
``vers_tpu.parallel.ivf``).

Build: global k-means by the psum-reduced Lloyd loop
(``parallel/kmeans.py``); the centroids are replicated on every shard.

Search: every shard stores its rows cluster-major (an ``ops/binned``
layout of its own rows). The queries probe the centroids once, on the
lead device; then each shard runs the packed binned scan over its own
members of the probed clusters (``ops/binned.binned_topk_kernel``: one
launch of kernel B a shard on the card, all probe ranks in that launch),
all shards at once (``mesh.map_shards``), and the shards' top-k
candidates gather on the lead device for one re-top-k. The JAX package scans one probe rank at a time in an XLA
``lax.scan`` over packed tiles; both compute the exact top-k over the
probed clusters, so the results are the same set, with equal distances
possibly in another order.

Row binning. The JAX package bins each shard's rows on the host with
numpy's difference form, ``argmin(sum((x - c)^2))``. Here the shard's
device computes the same form in the same float32 order
(``assign_difference_form``: numpy's pairwise summation replayed on
tensors), so every row lands in the JAX package's bin bit for bit, near
ties included. The single-device ``IVFFlatIndex`` bins by the matmul form
(``ops/kmeans.assign_clusters``), which may round a row within float32
rounding of two centroids the other way.

Persistence: per-shard files and a manifest (as ``ShardedFlatIndex``)
with the centroids in a sidecar; also an export to the reference's
single-file IVFFlat layout.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from vers_tpu_torch import graphs
from vers_tpu_torch.core import as_query_matrix
from vers_tpu_torch.index.base import Index
from vers_tpu_torch.io.bincode import Reader, Writer
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.ops.binned import binned_topk_kernel, kernel_plan, make_layout
from vers_tpu_torch.ops.cuda_binned import scans_on_host
from vers_tpu_torch.ops.distance import pairwise_sq_euclidean
from vers_tpu_torch.ops.topk import topk_smallest
from vers_tpu_torch.parallel.kmeans import sharded_build_kmeans
from vers_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    map_shards,
    merge_topk,
    shard_rows,
)


# numpy reduces at most this many elements of a row at a time (its
# iterator's buffer size), each run by pairwise summation
_NP_BUFFER = 8192
# numpy's pairwise summation sums runs of up to this many elements with
# eight strided accumulators
_NP_BLOCK = 128


def _pairwise_sq_sum(v, c, lo, n):
    """(rows, k) float32 sums of ``(v[:, lo:lo+n] - c[:, lo:lo+n])^2``
    over the columns, rounded as numpy's pairwise summation rounds them
    (``pairwise_sum`` of its float add loop), each square made as needed."""
    def sq(a, b):
        d = v[:, None, a:b] - c[None, :, a:b]
        return d.mul_(d)

    if n < 8:
        res = sq(lo, lo + 1)[..., 0]
        for i in range(lo + 1, lo + n):
            res = res + sq(i, i + 1)[..., 0]
        return res
    if n <= _NP_BLOCK:
        r = sq(lo, lo + 8)
        i = 8
        while i < n - n % 8:
            r.add_(sq(lo + i, lo + i + 8))
            i += 8
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
            (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for j in range(lo + i, lo + n):
            res = res + sq(j, j + 1)[..., 0]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sq_sum(v, c, lo, n2) + _pairwise_sq_sum(v, c, lo + n2, n - n2)


def assign_difference_form(v: torch.Tensor, c: torch.Tensor,
                           chunk_elems: int = 1 << 25) -> torch.Tensor:
    """(n,) int64 ``argmin_j sum((v_i - c_j)^2)`` on ``v``'s device, equal
    bit for bit to numpy's ``np.argmin(((v[:, None] - c[None]) ** 2)
    .sum(-1), axis=1)`` on the same float32 arrays: the same elementwise
    roundings, the same summation order, the first of equal minima.
    ``chunk_elems`` bounds the (rows, k, 8) squares made at a time."""
    n, d = v.shape
    k = c.shape[0]
    rows = max(1, chunk_elems // max(1, k * 8))
    out = []
    for r0 in range(0, n, rows):
        vc = v[r0 : r0 + rows]
        acc = None
        for lo in range(0, d, _NP_BUFFER):
            part = _pairwise_sq_sum(vc, c, lo, min(_NP_BUFFER, d - lo))
            acc = part if acc is None else acc + part
        out.append(torch.argmin(acc, dim=1))
    if not out:
        return torch.zeros((0,), dtype=torch.int64, device=v.device)
    return torch.cat(out)


class ShardedIVFFlatIndex(Index):
    def __init__(
        self,
        num_centroids: int,
        centroids: np.ndarray,
        shard_values: List[np.ndarray],   # per shard (n_s, d)
        shard_ids: List[np.ndarray],      # per shard (n_s,) global ids
        mesh: Optional[Mesh] = None,
        metric: str = "sq_euclidean",
    ):
        self.mesh = mesh or make_mesh()
        self.num_centroids = int(num_centroids)
        self.metric = metric
        self._centroids = np.array(centroids, np.float32)
        self._shard_values = [np.asarray(v, np.float32) for v in shard_values]
        self._shard_ids = [np.asarray(i, np.int64) for i in shard_ids]
        self.dim = self._centroids.shape[1]
        self._state = None
        # each shard's search graphs (``graphs``), replayed on its stream
        self._graphs = [graphs.GraphCache() for _ in self.mesh.devices]

    # -- build ----------------------------------------------------------

    @classmethod
    def build_index(
        cls,
        num_clusters: int,
        num_attempts: int,
        max_iterations: int,
        vectors: np.ndarray,
        mesh: Optional[Mesh] = None,
        seed: int = 0,
        init: Optional[torch.Tensor] = None,
    ) -> "ShardedIVFFlatIndex":
        """Distributed build: psum-reduced Lloyd with best-of-N
        restarts. ``init``: optional (num_attempts, k, d) initial
        centroids in place of the random valid rows that one
        ``torch.Generator`` seeded with ``seed`` draws."""
        mesh = mesh or make_mesh()
        vectors = np.asarray(vectors, np.float32)
        xs, counts = shard_rows(vectors, mesh)
        gen = torch.Generator(device=mesh.lead).manual_seed(seed)
        best = None
        for attempt in range(num_attempts):
            c, cost = sharded_build_kmeans(
                gen, xs, counts, num_clusters, max_iterations, mesh,
                init=None if init is None else init[attempt],
            )
            if best is None or float(cost) < best[1]:
                best = (c.cpu().numpy(), float(cost))
        del xs
        # shard splits on the host (build time only)
        shard_values, shard_ids = [], []
        offset = 0
        for c_s in counts.tolist():
            shard_values.append(vectors[offset : offset + c_s])
            shard_ids.append(np.arange(offset, offset + c_s, dtype=np.int64))
            offset += c_s
        return cls(num_clusters, best[0], shard_values, shard_ids, mesh)

    # -- device layout ----------------------------------------------------

    def _assign(self, s: int) -> np.ndarray:
        """(n_s,) int64 nearest-centroid ids of shard s's rows, computed
        on its device in the JAX package's difference form."""
        dev = self.mesh.devices[s]
        v = torch.from_numpy(self._shard_values[s]).to(dev)
        c = torch.from_numpy(self._centroids).to(dev)
        return assign_difference_form(v, c).cpu().numpy()

    def _ensure_state(self):
        """Per shard, its rows' bins and the cluster-major layout of its
        rows on its device, plus the (n, ) int64 map of the shards'
        concatenated rows to global ids."""
        if self._state is not None:
            return self._state
        layouts, bins = [], []
        for s, v in enumerate(self._shard_values):
            if len(v) == 0:
                layouts.append(None)  # nothing to scan
                bins.append(np.zeros((0,), np.int64))
                continue
            bins.append(self._assign(s))
            layouts.append(make_layout(v, bins[-1], self.num_centroids,
                                       device=self.mesh.devices[s]))
        offsets = np.cumsum([0] + [len(v) for v in self._shard_values])
        self._state = dict(
            layouts=layouts,
            bins=bins,
            offsets=offsets,
            ids=np.concatenate(self._shard_ids) if self._shard_ids
            else np.zeros((0,), np.int64),
            centroids=torch.from_numpy(self._centroids).to(self.mesh.lead),
        )
        return self._state

    # -- Index API --------------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """Appends to the least-loaded shard (rebalancing is a bulk op)."""
        emb = np.asarray(embedding, np.float32).reshape(1, -1)
        s = int(np.argmin([len(v) for v in self._shard_values]))
        self._shard_values[s] = np.concatenate([self._shard_values[s], emb])
        self._shard_ids[s] = np.append(self._shard_ids[s], np.int64(vec_id))
        self._state = None
        for g in self._graphs:
            g.invalidate()

    def _search_batch_rows(self, queries, top_k: int, nprobe: int = 1):
        """(dists (Q, k) f32, rows (Q, k) int64 into the shards'
        concatenated rows, -1 = empty) on the lead device."""
        state = self._ensure_state()
        lead = self.mesh.lead
        q = as_query_matrix(queries, lead)
        q_n = q.shape[0]
        nprobe = max(1, min(nprobe, self.num_centroids))
        # the probes, as the JAX package's stable host argsort of the
        # centroid distances orders them (the port's topk_smallest is a
        # stable sort)
        _, probes = topk_smallest(
            pairwise_sq_euclidean(q, state["centroids"]), nprobe)
        probes = probes.to(torch.int32)
        for layout in state["layouts"]:
            if layout is not None:  # its padded corpus, before any graph
                kernel_plan(layout, top_k)

        def body(s, dev, layout):
            if layout is None:
                return None  # nothing to scan
            offset = int(state["offsets"][s])

            def search(qs, ps):
                # dedup=False: a row lives in exactly one cluster and a
                # query's probes are distinct clusters
                d, pos = binned_topk_kernel(
                    qs, None, nprobe, layout, top_k=top_k,
                    metric=self.metric, probes=ps, dedup=False,
                )
                pos = pos.to(torch.int64)
                return d, torch.where(pos >= 0, pos + offset, -1)

            qs = q.to(dev)
            site = None if scans_on_host(top_k) else self._graphs[s].site(
                ("ivf", top_k, nprobe), qs, layout)
            return graphs.run(site, "search", search, qs, probes.to(dev))

        parts = [p for p in map_shards(self.mesh, body, state["layouts"])
                 if p is not None]
        parts_d, parts_i = [d for d, _ in parts], [i for _, i in parts]
        if not parts_d:
            return (torch.full((q_n, top_k), float("inf"), device=lead),
                    torch.full((q_n, top_k), -1, dtype=torch.int64,
                               device=lead))
        return merge_topk(parts_d, parts_i, top_k)

    def search_batch(
        self, queries, top_k: int, nprobe: int = 1
    ) -> SearchResult:
        d, rows = self._search_batch_rows(queries, top_k, nprobe)
        ids = self._ensure_state()["ids"]
        rows = rows.cpu().numpy()
        hi = max(len(ids) - 1, 0)
        out = np.where(rows >= 0, ids[np.clip(rows, 0, hi)], -1)
        return SearchResult(ids=out.astype(np.int64),
                            distances=d.cpu().numpy())

    # -- persistence -------------------------------------------------------

    def save_index(self, file_path: str) -> None:
        manifest = {
            "format": "vers_tpu.sharded_ivfflat.v1",
            "dim": self.dim,
            "metric": self.metric,
            "num_centroids": self.num_centroids,
            "num_shards": len(self._shard_values),
        }
        with open(file_path + ".manifest.json", "w") as fp:
            json.dump(manifest, fp)
        with open(file_path + ".centroids", "wb") as fp:
            Writer(fp).vec_f32_matrix(self._centroids)
        for s, (v, ids) in enumerate(zip(self._shard_values, self._shard_ids)):
            with open(f"{file_path}.shard{s}", "wb") as fp:
                w = Writer(fp)
                w.vec_f32_matrix(v)
                w.vec_u64(ids.astype(np.uint64))

    @classmethod
    def load_index(
        cls, file_path: str, dim: Optional[int] = None, mesh=None
    ) -> "ShardedIVFFlatIndex":
        with open(file_path + ".manifest.json") as fp:
            manifest = json.load(fp)
        dim = dim or manifest["dim"]
        with open(file_path + ".centroids", "rb") as fp:
            centroids = Reader(fp).vec_f32_matrix(dim)
        shard_values, shard_ids = [], []
        for s in range(manifest["num_shards"]):
            with open(f"{file_path}.shard{s}", "rb") as fp:
                r = Reader(fp)
                shard_values.append(r.vec_f32_matrix(dim))
                shard_ids.append(r.vec_u64().astype(np.int64))
        return cls(
            manifest["num_centroids"], centroids, shard_values, shard_ids,
            mesh=mesh, metric=manifest["metric"],
        )

    def export_single_file(self, file_path: str) -> None:
        """Export to the reference's single-file IVFFlat bincode layout
        (`ivfflat.rs:8-15`), with the search's own row binning. Ids in
        the reference format are row positions; rows are written in
        shard-then-insertion order. Serialization only: nothing stays on
        a device."""
        from vers_tpu_torch.index.ivfflat import IVFFlatIndex

        values = (np.concatenate(self._shard_values) if self._shard_values
                  else np.zeros((0, self.dim), np.float32))
        assign = np.concatenate(
            [self._assign(s) if len(v) else np.zeros((0,), np.int64)
             for s, v in enumerate(self._shard_values)]
        ) if self._shard_values else np.zeros((0,), np.int64)
        ids: List[List[int]] = [[] for _ in range(self.num_centroids)]
        for row, c in enumerate(assign):
            ids[int(c)].append(row)
        IVFFlatIndex(
            self.num_centroids, values, self._centroids, assign, ids,
            device="cpu",
        ).save_index(file_path)
