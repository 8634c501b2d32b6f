"""IVFFlat index (counterpart of ``vers_tpu.index.ivfflat``; the
reference is `vers/src/indexes/ivfflat.rs`).

Build: Lloyd k-means (``ops/kmeans.py``) with restarts, on the device of
the corpus tensor.

Search (batched): cluster-binned dense scan (``ops/binned.py``) — the
corpus is stored cluster-major so each probed cluster is one contiguous
row range, scanned by the packed-scan kernel (``ops/cuda_binned.py``) on
a CUDA index and by its plain version on a CPU index; per-query results
from nprobe probes merge with a final top-k.

Search (single query): exact behavioral parity with the reference's
adaptive cluster walk, including its remainder bookkeeping and the
take-top_k-per-cluster quirk (numpy, on the host).

Quirk parity: ``add`` ignores the caller's vec_id and assigns
``len(assignments)`` (`ivfflat.rs:209` shadows the argument) — kept.

With no ``device`` an index lives on the first CUDA card
(``core.resolve_device``); ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from vers_tpu_torch import graphs, trace
from vers_tpu_torch.config import IVFFlatConfig
from vers_tpu_torch.core import as_query_matrix, resolve_device, round_up
from vers_tpu_torch.index.base import Index
from vers_tpu_torch.io.bincode import Reader, Writer
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.ops import kmeans as kmeans_ops
from vers_tpu_torch.ops.binned import (
    adaptive_probe_depth,
    adaptive_probes,
    binned_topk_kernel,
    kernel_plan,
    layout_insert,
    make_layout,
    make_layout_device,
    slacken_layout,
)
from vers_tpu_torch.ops.cuda_binned import scans_on_host


class IVFFlatIndex(Index):
    def __init__(
        self,
        num_centroids: int,
        values: np.ndarray,
        centroids: np.ndarray,
        assignments: np.ndarray,
        ids: List[List[int]],
        config: IVFFlatConfig = IVFFlatConfig(),
        device=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.num_centroids = int(num_centroids)
        self._values = np.asarray(values, dtype=np.float32)
        self._centroids = np.array(centroids, dtype=np.float32)
        self._assignments = np.asarray(assignments, dtype=np.int64)
        self._ids = [list(map(int, c)) for c in ids]
        self.dim = self._values.shape[1]
        self._layout = None  # lazy cluster-major device layout
        self._centroids_dev = None
        self._values_dev = None
        self._assign_dev = None
        self._n_valid = self._values.shape[0]
        self._graphs = graphs.GraphCache()

    @classmethod
    def from_numpy(cls, num_centroids: int, values, centroids, assignments,
                   ids, config: IVFFlatConfig = IVFFlatConfig(), device=None):
        """An index over another package's state, as numpy arrays and id
        lists (``vers_tpu``'s ``_values``, ``_centroids``,
        ``_assignments`` and ``_ids`` after ``_materialize_host()``)."""
        return cls(num_centroids, values, centroids, assignments, ids,
                   config=config, device=device)

    # -- build ---------------------------------------------------------

    @classmethod
    def build_index(
        cls,
        num_clusters: int,
        num_attempts: int,
        max_iterations: int,
        vectors,
        config: Optional[IVFFlatConfig] = None,
        device=None,
        init: Optional[torch.Tensor] = None,
    ) -> "IVFFlatIndex":
        """Parity signature with `ivfflat.rs:102-136`. ``vectors``: (n, d)
        numpy array or tensor; the build runs on ``device``, else on the
        tensor's device, else on the first CUDA card. ``init``: optional
        (num_attempts, k, d) initial centroids in place of random rows.
        The build is the span ``ivf.build``; it ends in reads to the host."""
        with trace.span("ivf.build"):
            config = config or IVFFlatConfig(
                num_clusters=num_clusters,
                num_attempts=num_attempts,
                max_iterations=max_iterations,
            )
            if device is None and isinstance(vectors, torch.Tensor):
                device = vectors.device
            device = resolve_device(device)
            if isinstance(vectors, torch.Tensor):
                data = vectors.to(device=device, dtype=torch.float32)
                vectors_np = None
            else:
                vectors_np = np.asarray(vectors, dtype=np.float32)
                data = torch.as_tensor(vectors_np, device=device)
            n, d = data.shape
            data = torch.nn.functional.pad(data,
                                           (0, 0, 0, round_up(n, 128) - n))
            gen = torch.Generator(device=data.device).manual_seed(config.seed)
            centroids, _ = kmeans_ops.build_kmeans_restarts(
                gen, data, n, num_clusters, num_attempts, max_iterations,
                init=init,
            )
            assignments = kmeans_ops.assign_clusters(data, n, centroids)[:n]
            assignments = assignments.cpu().numpy().astype(np.int64)
            ids: List[List[int]] = [[] for _ in range(num_clusters)]
            for vec_id, c in enumerate(assignments):
                ids[int(c)].append(vec_id)
            if vectors_np is None:
                vectors_np = data[:n].cpu().numpy()
            return cls(num_clusters, vectors_np, centroids.cpu().numpy(),
                       assignments, ids, config, device=data.device)

    @classmethod
    def build_index_device(
        cls,
        num_clusters: int,
        num_attempts: int,
        max_iterations: int,
        data_dev: torch.Tensor,
        n_valid: Optional[int] = None,
        config: Optional[IVFFlatConfig] = None,
        init: Optional[torch.Tensor] = None,
    ) -> "IVFFlatIndex":
        """Build from a device-resident (n_pad, d) corpus: k-means,
        assignment and the cluster-major layout all stay on its device;
        the host sees only the (k,) size vector. Host-side state
        materializes lazily on first use."""
        config = config or IVFFlatConfig(
            num_clusters=num_clusters,
            num_attempts=num_attempts,
            max_iterations=max_iterations,
        )
        n_pad, d = data_dev.shape
        n = int(n_valid) if n_valid is not None else n_pad
        data_dev = data_dev.float()
        gen = torch.Generator(device=data_dev.device).manual_seed(config.seed)
        centroids_dev, _ = kmeans_ops.build_kmeans_restarts(
            gen, data_dev, n, num_clusters, num_attempts, max_iterations,
            init=init,
        )
        assign_dev = kmeans_ops.assign_clusters(data_dev, n, centroids_dev)
        idx = cls.__new__(cls)
        idx.config = config
        idx.device = data_dev.device
        idx.num_centroids = int(num_clusters)
        idx._values = None
        idx._centroids = None
        idx._assignments = None
        idx._ids = None
        idx._values_dev = data_dev
        idx._assign_dev = assign_dev
        idx._n_valid = n
        idx.dim = int(d)
        idx._layout = make_layout_device(data_dev, assign_dev, num_clusters, n)
        idx._centroids_dev = centroids_dev
        idx._graphs = graphs.GraphCache()
        return idx

    def _materialize_host(self):
        """Copy device-built state to the host for the host-side paths
        (add_batch, save_index, single-query search). No-op for
        host-built indexes."""
        if self._values is not None:
            return
        self._values = self._values_dev[: self._n_valid].cpu().numpy()
        self._centroids = self._centroids_dev.cpu().numpy()
        self._assignments = (
            self._assign_dev[: self._n_valid].cpu().numpy().astype(np.int64)
        )
        ids: List[List[int]] = [[] for _ in range(self.num_centroids)]
        for vec_id, c in enumerate(self._assignments):
            ids[int(c)].append(vec_id)
        self._ids = ids

    def _ensure_layout(self):
        """The cluster-major layout; its build is the span ``ivf.layout``."""
        if self._layout is not None:
            return self._layout
        with trace.span("ivf.layout"):
            if self._values is None and self._values_dev is not None:
                # device-built index whose layout was dropped (slack
                # exhaustion): rebuild on device
                self._layout = make_layout_device(
                    self._values_dev, self._assign_dev,
                    self.num_centroids, self._n_valid,
                )
            else:
                self._materialize_host()
                self._layout = make_layout(
                    self._values, self._assignments, self.num_centroids,
                    device=self.device,
                )
                self._centroids_dev = torch.as_tensor(self._centroids,
                                                      device=self.device)
        return self._layout

    def _centroids_host(self) -> np.ndarray:
        if self._centroids is None:
            self._centroids = self._centroids_dev.cpu().numpy()
        return self._centroids

    # -- Index API -------------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        """Quirk parity with `ivfflat.rs:200-213`: the caller's vec_id is
        ignored; the new row gets id == len(assignments).

        An existing cluster-major layout is patched in place: on first
        add it re-packs once WITH per-bin slack (``slacken_layout``),
        then each add writes into the assigned bin's slack. The search
        graphs are dropped: they read the layout as it was."""
        self._graphs.invalidate()
        emb = np.asarray(embedding, dtype=np.float32).reshape(-1)
        cent = self._centroids_host()
        d2 = np.sum((cent - emb[None, :]) ** 2, axis=1)
        c = int(np.argmin(d2))
        new_id = self._n_valid

        if self._values is not None:  # host mirrors exist: keep fresh
            self._values = np.concatenate([self._values, emb[None, :]], axis=0)
            self._assignments = np.append(self._assignments, c)
            self._ids[c].append(new_id)
        if self._values_dev is not None:  # device corpus: patch on device
            n_pad = int(self._values_dev.shape[0])
            if new_id >= n_pad:
                self._values_dev = torch.nn.functional.pad(
                    self._values_dev, (0, 0, 0, 128))
                self._assign_dev = torch.nn.functional.pad(
                    self._assign_dev, (0, 128))
            self._values_dev[new_id] = torch.as_tensor(emb).to(self.device)
            self._assign_dev[new_id] = c
        self._n_valid = new_id + 1

        if self._layout is not None:
            if not self._layout.get("slacked"):
                self._layout = slacken_layout(self._layout)
            if not layout_insert(self._layout, emb, c, new_id):
                self._layout = None  # slack exhausted: rebuild lazily

    def add_batch(self, embeddings, vec_ids=None) -> None:
        """Vectorized bulk insert: one assignment pass, one layout
        rebuild. Caller vec_ids are ignored (same quirk parity as
        ``add``: new rows get sequential ids)."""
        self._materialize_host()
        self._graphs.invalidate()
        embs = np.asarray(embeddings, dtype=np.float32)
        if embs.ndim == 1:
            embs = embs[None]
        d2 = (
            np.einsum("nd,nd->n", embs, embs)[:, None]
            + np.einsum("kd,kd->k", self._centroids, self._centroids)[None, :]
            - 2.0 * embs @ self._centroids.T
        )
        assign = np.argmin(d2, axis=1)
        base = len(self._assignments)
        self._values = np.concatenate([self._values, embs], axis=0)
        self._assignments = np.concatenate([self._assignments, assign])
        for i, c in enumerate(assign):
            self._ids[int(c)].append(base + i)
        self._n_valid = len(self._assignments)
        self._layout = None
        self._values_dev = None

    def search_batch_device(self, queries, top_k: int,
                            nprobe: Optional[int] = None):
        """Device-resident search: (dists (Q, k) f32, ids (Q, k) int32)
        tensors on the index's device, no host transfer: on a card the
        search enqueues without waiting for it, so calls chain and the
        caller drains once (the pipelined-serving model of
        ``docs/SERVING.md``). A fixed nprobe runs as one CUDA graph
        (``graphs``: a configuration's second call captures it, later
        calls replay it). The adaptive depth (``nprobe=0``) runs
        eagerly: it is bound by the card, so a graph gains nothing, and
        a graph would hold its working set (the widest of the searches,
        up to p_max probes a query) in a pool nothing else can use. The
        plain engine (``engine="xla"``) and top_k > 128 read their work
        items on the host and run eagerly.

        ``nprobe=0`` (the config default) selects per-query adaptive
        probe depth — the batched analogue of the reference's cluster
        walk (`ivfflat.rs:166-195`): each query probes just enough
        nearest clusters for their min(size, top_k) contributions to
        reach top_k, and the result is the exact top_k over those
        clusters' union. The call is the span ``ivf.search``."""
        with trace.span("ivf.search"):
            layout = self._ensure_layout()
            on_device = (isinstance(queries, torch.Tensor)
                         and queries.device == self.device)
            with (contextlib.nullcontext() if on_device
                  else trace.span("ivf.upload")):
                qdev = as_query_matrix(queries, self.device)
            nprobe = nprobe if nprobe is not None else self.config.nprobe
            p_max = None
            if nprobe == 0:
                # worst-case depth comes from OCCUPIED sizes: a slacked
                # layout's sizes_host holds per-bin capacities
                p_max = adaptive_probe_depth(
                    layout.get("true_sizes_host", layout["sizes_host"]), top_k
                )
                nprobe = min(p_max, layout["num_bins"])
            else:
                nprobe = max(1, min(nprobe, self.num_centroids))
            engine = self.config.engine
            if engine not in ("auto", "pallas", "xla"):
                raise ValueError(f"unknown engine {engine!r}")
            # precision reaches only the plain ("xla") engine, as in the JAX
            # package; the kernel engine is f32-exact whatever it says
            if engine == "xla" and self.config.precision != "highest":
                raise ValueError("engine='xla' exists only at "
                                 "precision='highest' (float32)")
            plain = engine == "xla"
            centroids = self._centroids_dev
            # the padded corpus (cached on the layout), made here on the
            # caller's stream rather than in a graph's warm-up
            with trace.span("ivf.plan"):
                kernel_plan(layout, qdev.shape[0], nprobe, top_k)

            def search(q):
                probes = None
                if p_max is not None:
                    with trace.stage("probe", q.device):
                        probes = adaptive_probes(
                            q, centroids, layout["size"], layout["num_bins"],
                            p_max, top_k)
                # dedup=False: every row lives in exactly ONE cluster and a
                # query's probes are distinct clusters, so probe ranks cover
                # disjoint ids
                return binned_topk_kernel(
                    q, centroids, nprobe, layout, top_k=top_k, probes=probes,
                    dedup=False, plain=plain,
                )

            eager = scans_on_host(top_k, plain) or p_max is not None
            site = None if eager else self._graphs.site(
                ("ivf", top_k, nprobe), qdev, layout)
            return graphs.run(site, "search", search, qdev)

    def search_batch(self, queries, top_k: int,
                     nprobe: Optional[int] = None) -> SearchResult:
        """``search_batch_device``, then its results read to the host (the
        span ``ivf.download``)."""
        dists, rows = self.search_batch_device(queries, top_k, nprobe)
        with trace.span("ivf.download"):
            return SearchResult(
                ids=rows.cpu().numpy().astype(np.int64),
                distances=dists.cpu().numpy(),
            )

    def search_approximate(self, query, top_k: int) -> List[Tuple[int, float]]:
        """Behavioral parity with the adaptive cluster walk
        (`ivfflat.rs:153-198`): scan clusters nearest-first, take at most
        top_k from each, stop once top_k candidates are collected."""
        self._materialize_host()
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        cd = np.sum((self._centroids - q[None, :]) ** 2, axis=1)
        nearest = np.argsort(cd, kind="stable")
        candidates: List[Tuple[int, float]] = []
        remainder = top_k
        for c in nearest:
            members = self._ids[int(c)]
            if members:
                m = np.asarray(members, dtype=np.int64)
                d2 = np.sum((self._values[m] - q[None, :]) ** 2, axis=1)
                o = np.argsort(d2, kind="stable")[:top_k]
                pc = [(int(m[i]), float(d2[i])) for i in o]
            else:
                pc = []
            if len(pc) < remainder:
                remainder -= len(pc)
                candidates.extend(pc)
            elif len(pc) > remainder:
                candidates.extend(pc[:remainder])
                break
            else:
                candidates.extend(pc)
                break
        return candidates

    # -- persistence (bincode parity: `ivfflat.rs:8-15` field order) ----

    def save_index(self, file_path: str) -> None:
        self._materialize_host()
        with open(file_path, "wb") as fp:
            w = Writer(fp)
            w.u64(self.num_centroids)
            w.vec_f32_matrix(self._values)
            w.vec_f32_matrix(self._centroids)
            w.vec_u64(self._assignments.astype(np.uint64))
            w.u64(len(self._ids))
            for cluster in self._ids:
                w.vec_u64(np.asarray(cluster, dtype=np.uint64))

    @classmethod
    def load_index(
        cls,
        file_path: str,
        dim: Optional[int] = None,
        config: IVFFlatConfig = IVFFlatConfig(),
        device=None,
    ) -> "IVFFlatIndex":
        if dim is None:
            # the file doesn't store dim (parity with the reference's
            # const-generic N, `base.rs:45-58`); solve it from the layout
            from vers_tpu_torch.io.infer import infer_dim_ivfflat

            dim = infer_dim_ivfflat(file_path)
        with open(file_path, "rb") as fp:
            r = Reader(fp)
            num_centroids = r.u64()
            values = r.vec_f32_matrix(dim)
            centroids = r.vec_f32_matrix(dim)
            assignments = r.vec_u64().astype(np.int64)
            n_clusters = r.u64()
            ids = [r.vec_u64().astype(np.int64).tolist() for _ in range(n_clusters)]
        return cls(num_centroids, values, centroids, assignments, ids, config,
                   device=device)
