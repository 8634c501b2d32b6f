"""Exact brute-force index (counterpart of ``vers_tpu.index.flat``): the
reference's ``search_exhaustive`` baseline (`vers/src/utils.rs:68-82`)
promoted to a first-class index. It is the parity anchor and the
ground truth every approximate index is measured against.

Search runs kernel A (``ops/cuda_topk.py``) on a CUDA index and its
plain version on a CPU index; the approximate engines are
``approx_scan_topk`` and the bucket scan (kernels D and C,
``ops/cuda_bucket.py``). A CUDA index keeps kernel D's bf16 copy of the
corpus and its |x|^2 from the first bucket search until ``add``.

``FlatConfig(dtype="bfloat16")`` keeps the corpus in bf16 (half the
bytes; each row rounded once on the way in). Its exact engine runs
kernel A's bf16-corpus route at precision "highest" (f32 queries against
the bf16 rows); the approx engine and the bucket engine's rescore read
the bf16 rows widened to f32; ``save_index`` writes them as f32.

With no ``device`` an index lives on the first CUDA card
(``core.resolve_device``); ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vers_tpu_torch.config import FlatConfig
from vers_tpu_torch.core import VectorStore, as_query_matrix
from vers_tpu_torch.index.base import Index
from vers_tpu_torch.io.bincode import Reader, Writer
from vers_tpu_torch.models.candidates import SearchResult
from vers_tpu_torch.ops.cuda_bucket import (
    bucket_scan_topk,
    prepare_bucket_corpus,
)
from vers_tpu_torch.ops.cuda_topk import distance_topk


class FlatIndex(Index):
    def __init__(
        self,
        vectors,
        ids=None,
        config: FlatConfig = FlatConfig(),
        device=None,
    ):
        if config.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got "
                             f"{config.dtype!r}")
        self.config = config
        self._store = VectorStore(vectors, dtype=getattr(torch, config.dtype),
                                  device=device)
        self._bucket_corpus = None  # kernel D's corpus, made on first use
        n = self._store.count
        self._ids = np.asarray(
            ids if ids is not None else np.arange(n), dtype=np.int64
        )
        if self._ids.shape[0] != n:
            raise ValueError("ids length must match vectors")
        self.dim = self._store.dim

    @classmethod
    def build_index(cls, vectors, ids=None, config: FlatConfig = FlatConfig(),
                    device=None):
        return cls(vectors, ids=ids, config=config, device=device)

    @classmethod
    def from_numpy(cls, values, ids, config: FlatConfig = FlatConfig(),
                   device=None):
        """An index over another package's state: (n, d) values and (n,)
        ids as numpy arrays (e.g. ``vers_tpu``'s ``FlatIndex``)."""
        return cls(np.asarray(values, np.float32), ids=np.asarray(ids),
                   config=config, device=device)

    @property
    def device(self) -> torch.device:
        return self._store.device

    # -- Index API ----------------------------------------------------

    def add(self, embedding, vec_id: int) -> None:
        self._store.append(embedding)
        self._bucket_corpus = None
        self._ids = np.append(self._ids, np.int64(vec_id))

    def bucket_corpus(self):
        """Kernel D's corpus for this store state
        (``prepare_bucket_corpus``), made once and kept until ``add``."""
        if self._bucket_corpus is None:
            self._bucket_corpus = prepare_bucket_corpus(self._store.data)
        return self._bucket_corpus

    def search_batch_device(self, queries, top_k: int):
        """Device-resident search: (dists (Q, top_k) f32, rows (Q, top_k)
        int32) tensors on the index's device, rows being corpus positions.
        Always exactly top_k columns; when the corpus is smaller than
        top_k the tail is (inf, -1).

        Engine selected by ``config.engine``: "auto" (= "exact", kernel
        A), "exact", "approx" (``approx_scan_topk``) or "bucket" (kernels
        D and C, at the default chunk of 2048 rows, with
        ``config.bucket_rescore``)."""
        engine = self.config.engine
        if engine not in ("auto", "exact", "approx", "bucket"):
            raise ValueError(f"unknown engine {engine!r}")
        queries = as_query_matrix(queries, self.device)
        k_eff = max(1, min(top_k, self._store.capacity))
        if engine == "bucket":
            dists, rows = bucket_scan_topk(
                queries, self._store.data, self._store.count, k_eff,
                metric=self.config.metric, rescore=self.config.bucket_rescore,
                prepared=self.bucket_corpus() if queries.is_cuda else None,
            )
        else:
            dists, rows = distance_topk(
                queries, self._store.data, self._store.count, k_eff,
                metric=self.config.metric, chunk_size=self.config.chunk_size,
                force="approx" if engine == "approx" else None,
            )
        if k_eff < top_k:
            pad = top_k - k_eff
            dists = torch.nn.functional.pad(dists, (0, pad), value=float("inf"))
            rows = torch.nn.functional.pad(rows, (0, pad), value=-1)
        return dists, rows

    def search_batch(self, queries, top_k: int) -> SearchResult:
        dists, rows = self.search_batch_device(queries, top_k)
        dists = dists.cpu().numpy()
        rows = rows.cpu().numpy()
        ids = np.where(
            rows >= 0, self._ids[np.clip(rows, 0, len(self._ids) - 1)], -1
        )
        return SearchResult(ids=ids, distances=dists)

    # -- persistence (the JAX package's extension format; the reference
    #    has no flat index): values Vec<Vector<N>>, ids Vec<u64>.

    def save_index(self, file_path: str) -> None:
        with open(file_path, "wb") as fp:
            w = Writer(fp)
            w.vec_f32_matrix(self._store.rows())
            w.vec_u64(self._ids.astype(np.uint64))

    @classmethod
    def load_index(cls, file_path: str, dim: Optional[int] = None,
                   config: FlatConfig = FlatConfig(), device=None):
        if dim is None:
            from vers_tpu_torch.io.infer import infer_dim_flat

            dim = infer_dim_flat(file_path)
        with open(file_path, "rb") as fp:
            r = Reader(fp)
            values = r.vec_f32_matrix(dim)
            ids = r.vec_u64().astype(np.int64)
        return cls(values, ids=ids, config=config, device=device)
