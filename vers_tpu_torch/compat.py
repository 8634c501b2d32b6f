"""The reference README's intended Python API (counterpart of
``vers_tpu.compat``).

The reference's README documents this surface (`README.md:83-97`):

    import vers
    embeddings = vers.load_wiki()
    hnsw = vers.HNSW(ef_construction=100, num_layers=8,
                     ef_search=32, num_neighbours=8)
    hnsw.build_index(embeddings)
    results = hnsw.search(embeddings.get("king"), top_k=10)

``vers_tpu_torch`` exposes the same shape over the port's indexes:
``load_wiki`` returns an ``Embeddings`` mapping words to vectors, and
``HNSW`` / ``LSH`` / ``IVFFlat`` are keyword-constructed wrappers with
instance ``build_index`` and ``search``. Results are ``(word,
distance)`` when the index was built from an ``Embeddings``,
``(row_id, distance)`` otherwise. Each wrapper takes ``device=``, which
reaches the index it builds; with none the index goes to the first CUDA
card (``core.resolve_device``). The full-control API (``HNSWIndex``
etc.) remains the primary surface.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


class Embeddings:
    """Word -> vector mapping with a dense (n, d) matrix view."""

    def __init__(self, words: Sequence[str], vectors: np.ndarray):
        self.words = list(words)
        self.vectors = np.asarray(vectors, dtype=np.float32)
        self._idx: Dict[str, int] = {w: i for i, w in enumerate(self.words)}

    def get(self, word: str) -> np.ndarray:
        return self.vectors[self._idx[word]]

    def __contains__(self, word: str) -> bool:
        return word in self._idx

    def __len__(self) -> int:
        return len(self.words)

    def word_of(self, row: int) -> str:
        return self.words[row]


def load_wiki(
    path: Optional[str] = None,
    dim: int = 300,
    max_rows: Optional[int] = None,
) -> Embeddings:
    """``vers.load_wiki()`` (`README.md:88`): the wiki fastText vectors,
    normalized, as an ``Embeddings``. Without ``path`` it looks in the
    conventional dataset spots (``VERS_DATA``, ``data/``, ...) and falls
    back to the synthetic royal-words corpus so the README flow always
    runs. Host data only: the device is chosen by the index."""
    from vers_tpu_torch.utils import data

    if path is None:
        path = data.dataset_path("wiki-news-300d-1M.vec")
    if path is None:
        words, vectors = data.synthetic_words_dataset(
            n_words=20000, dim=dim, seed=0
        )
        return Embeddings(words, data.normalize_np(vectors))
    words, vectors = data.load_vec_file(path, dim, max_rows=max_rows)
    return Embeddings(words, data.normalize_np(vectors))


ArrayLike = Union[Embeddings, np.ndarray]


class _ReadmeIndex:
    """Keyword-constructed wrapper: instance build_index/search, word
    results when built from an ``Embeddings``."""

    def __init__(self, device=None):
        self._index = None
        self._words: Optional[List[str]] = None
        self.device = device

    def _make(self, vectors: np.ndarray):
        raise NotImplementedError

    def build_index(self, embeddings: ArrayLike) -> None:
        if isinstance(embeddings, Embeddings):
            self._words = embeddings.words
            vectors = embeddings.vectors
        else:
            self._words = None
            vectors = np.asarray(embeddings, dtype=np.float32)
        self._index = self._make(vectors)

    def search(
        self, query: np.ndarray, top_k: int = 10
    ) -> List[Tuple[Union[str, int], float]]:
        if self._index is None:
            raise RuntimeError("build_index() first")
        out = self._index.search_approximate(
            np.asarray(query, dtype=np.float32), top_k
        )
        if self._words is None:
            return out
        return [
            (self._words[i] if 0 <= i < len(self._words) else i, d)
            for i, d in out
        ]

    def search_batch(self, queries, top_k: int = 10):
        if self._index is None:
            raise RuntimeError("build_index() first")
        return self._index.search_batch(queries, top_k)

    @property
    def index(self):
        """The underlying full-API index object."""
        return self._index


class HNSW(_ReadmeIndex):
    """``vers.HNSW(...)`` (`README.md:91`)."""

    def __init__(
        self,
        ef_construction: int = 100,
        num_layers: int = 8,
        ef_search: int = 32,
        num_neighbours: int = 8,
        batched_build: bool = True,
        seed: int = 0,
        device=None,
    ):
        super().__init__(device)
        self._params = (ef_construction, num_layers, ef_search,
                        num_neighbours, batched_build, seed)

    def _make(self, vectors):
        from vers_tpu_torch.index.hnsw import HNSWIndex

        efc, nl, efs, m, batched, seed = self._params
        build = (
            HNSWIndex.build_index_batched if batched else HNSWIndex.build_index
        )
        return build(nl, efc, efs, m, vectors, seed=seed, device=self.device)


class LSH(_ReadmeIndex):
    def __init__(self, num_trees: int = 8, max_node_size: int = 100,
                 device=None):
        super().__init__(device)
        self._params = (num_trees, max_node_size)

    def _make(self, vectors):
        from vers_tpu_torch.index.lsh import ANNIndex

        t, m = self._params
        return ANNIndex.build_index(t, m, vectors, np.arange(len(vectors)),
                                    device=self.device)


class IVFFlat(_ReadmeIndex):
    def __init__(
        self,
        num_clusters: int = 64,
        num_attempts: int = 2,
        max_iterations: int = 10,
        device=None,
    ):
        super().__init__(device)
        self._params = (num_clusters, num_attempts, max_iterations)

    def _make(self, vectors):
        from vers_tpu_torch.index.ivfflat import IVFFlatIndex

        k, a, it = self._params
        return IVFFlatIndex.build_index(k, a, it, vectors, device=self.device)


# -- vers_py module-function parity (vers-py/src/lib.rs:125-186) -------


def load_wiki_vector(path: str, dim: int = 300):
    """``vers_py.load_wiki_vector`` parity (`vers-py/src/lib.rs:126-141`):
    (vectors, word_to_idx, idx_to_word, test_embs) as the PyO3 function
    returns them: vectors normalized, the queen holdout raw in
    test_embs."""
    from vers_tpu_torch.utils.data import load_wiki_vector as _load

    return _load(path, dim=dim)


def test_wiki_ivfflat(
    vectors,
    word_to_idx,
    idx_to_word,
    num_clusters: int,
    num_attempts: int,
    max_iterations: int,
    test_embs,
    device=None,
):
    """``vers_py.test_wiki_ivfflat`` parity (`vers-py/src/lib.rs:144-170`):
    build an IVFFlat index on ``device`` and run the queen smoke harness
    (the shim wraps `utils::test_ivfflat`, which is `run_test` +
    build)."""
    import os
    import tempfile

    from vers_tpu_torch.index.ivfflat import IVFFlatIndex
    from vers_tpu_torch.utils.harness import run_test

    vectors = np.asarray(vectors, dtype=np.float32)
    index = IVFFlatIndex.build_index(
        num_clusters, num_attempts, max_iterations, vectors, device=device
    )
    # scratch save/reload file goes to the temp dir, not the CWD
    with tempfile.TemporaryDirectory(prefix="vers_tpu_torch_") as tmp:
        return run_test(
            index, os.path.join(tmp, "ivfflat.index"), vectors,
            dict(word_to_idx), dict(idx_to_word), test_embs,
        )


def get_sum(v1, v2) -> np.ndarray:
    """``vers_py.get_sum`` parity (`vers-py/src/lib.rs:173-177`):
    elementwise vector add (the crate's toy FFI smoke function)."""
    return (
        np.asarray(v1, dtype=np.float32) + np.asarray(v2, dtype=np.float32)
    )
