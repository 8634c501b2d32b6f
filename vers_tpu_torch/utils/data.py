"""Dataset loading.

``load_wiki_vector`` is the parity port of `vers/src/utils.rs:7-66`:
parse the fastText ``.vec`` text format, **hold out the word "queen"**
as the test query (`utils.rs:38-42`), L2-normalize everything else at
load (`utils.rs:48`). Held-out embeddings are returned RAW (the harness
normalizes them at insertion, `utils.rs:136`).

Because the benchmark hosts have no network egress, ``synthetic_words_dataset``
fabricates a deterministic wiki-like corpus with a royal-word cluster so
the queen smoke test has a meaningful known answer, and fvecs/ivecs
readers cover SIFT-style benchmark files when present.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from vers_tpu_torch.core import normalize_np

WikiData = Tuple[
    np.ndarray,  # (n, d) normalized vectors
    Dict[str, int],  # word -> idx
    Dict[int, str],  # idx -> word
    List[Tuple[str, np.ndarray]],  # held-out (word, RAW embedding)
]


def load_vec_file(
    path: str, dim: int, header: bool = True, max_rows: int | None = None
) -> Tuple[List[str], np.ndarray]:
    """Parse a fastText/GloVe ``.vec`` text file -> (words, (n, dim) f32).

    ``header=True`` skips the first "count dim" line (fastText);
    GloVe files have no header.

    The native C++ parser (``vers_tpu_torch.native``) where it is
    available, else ``parse_vec_python``, the behavioural reference.
    """
    from vers_tpu_torch import native

    out = native.parse_vec(path, dim, header=header, max_rows=max_rows)
    if out is not None:
        return out
    return parse_vec_python(path, dim, header=header, max_rows=max_rows)


def parse_vec_python(
    path: str, dim: int, header: bool = True, max_rows: int | None = None
) -> Tuple[List[str], np.ndarray]:
    """``load_vec_file``'s Python reader: one line at a time; lines with
    fewer than ``dim`` values are skipped."""
    words: List[str] = []
    rows: List[np.ndarray] = []
    with open(path, "r", encoding="utf-8", errors="replace") as fp:
        if header:
            fp.readline()
        for line in fp:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < dim + 1:
                parts = line.split()
                if len(parts) < dim + 1:
                    continue
            words.append(parts[0])
            rows.append(np.asarray(parts[1 : dim + 1], dtype=np.float32))
            if max_rows is not None and len(words) >= max_rows:
                break
    if not rows:
        return words, np.zeros((0, dim), dtype=np.float32)
    return words, np.stack(rows)


def load_wiki_vector(
    path: str,
    dim: int = 300,
    holdout: Sequence[str] = ("queen",),
    header: bool = True,
    max_rows: int | None = None,
) -> WikiData:
    """Parity port of `utils.rs:7-66`: queen (holdout) rows are excluded
    from the index and returned raw; all other rows are normalized."""
    words, embs = load_vec_file(path, dim, header=header, max_rows=max_rows)
    holdout_set = set(holdout)
    word_to_idx: Dict[str, int] = {}
    idx_to_word: Dict[int, str] = {}
    keep_rows: List[int] = []
    test_embs: List[Tuple[str, np.ndarray]] = []
    curr = 0
    for i, w in enumerate(words):
        if w in holdout_set:
            test_embs.append((w, embs[i].copy()))
            continue
        word_to_idx[w] = curr
        idx_to_word[curr] = w
        keep_rows.append(i)
        curr += 1
    vectors = normalize_np(embs[keep_rows]) if keep_rows else embs[:0]
    return vectors, word_to_idx, idx_to_word, test_embs


def write_vec_file(path: str, words: Sequence[str], embs: np.ndarray, header: bool = True) -> None:
    """Write a fastText-style ``.vec`` text file (for tests/fixtures)."""
    embs = np.asarray(embs, dtype=np.float32)
    with open(path, "w", encoding="utf-8") as fp:
        if header:
            fp.write(f"{len(words)} {embs.shape[1]}\n")
        for w, row in zip(words, embs):
            fp.write(w + " " + " ".join(f"{v:.4f}" for v in row) + "\n")


ROYAL_WORDS = [
    "king", "queen", "monarch", "prince", "princess",
    "ruler", "emperor", "empress", "throne", "crown",
    "royal", "kingdom", "kings", "queens", "reign",
]


def synthetic_words_dataset(
    n_words: int = 2000, dim: int = 64, seed: int = 0
) -> Tuple[List[str], np.ndarray]:
    """Deterministic wiki-like dataset: a tight cluster of royal words
    (so 'queen' has known royal neighbours) plus random filler words.
    Returns (words, RAW embeddings) — feed through load/normalize like
    a real .vec file."""
    rng = np.random.default_rng(seed)
    royal_center = rng.normal(size=dim).astype(np.float32) * 3.0
    words: List[str] = []
    rows: List[np.ndarray] = []
    for w in ROYAL_WORDS:
        words.append(w)
        rows.append(royal_center + rng.normal(size=dim).astype(np.float32) * 0.15)
    for i in range(max(0, n_words - len(ROYAL_WORDS))):
        words.append(f"word{i}")
        rows.append(rng.normal(size=dim).astype(np.float32))
    return words, np.stack(rows).astype(np.float32)


def synthetic_gaussian(
    n: int, d: int, n_clusters: int = 32, n_queries: int = 256,
    seed: int = 0, normalized: bool = False, query_noise: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Clustered benchmark corpus + queries drawn near corpus points
    (``query_noise`` controls difficulty: higher -> true neighbours
    spread over more clusters)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, size=n)
    data = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    qidx = rng.integers(0, n, size=n_queries)
    queries = data[qidx] + query_noise * rng.normal(size=(n_queries, d)).astype(
        np.float32
    )
    data = data.astype(np.float32)
    queries = queries.astype(np.float32)
    if normalized:
        data = normalize_np(data)
        queries = normalize_np(queries)
    return data, queries


TOPK_TABLE_KINDS = ["random", "equal", "few", "zeros", "sparse"]


def adversarial_topk_table(kind: str, q_n: int, w: int, seed: int = 0):
    """A (q_n, w) f32 table with int32 ids that stresses the order of a
    values top-k (stable by value, then column), by ``kind`` of
    ``TOPK_TABLE_KINDS``. Returns (vals, ids) as numpy arrays."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        vals = rng.normal(size=(q_n, w)).astype(np.float32)
    elif kind == "equal":  # every entry ties: columns 0 .. k - 1 win
        vals = np.full((q_n, w), 0.25, np.float32)
    elif kind == "few":  # duplicates 1, 4, 32 and 128 columns apart
        vals = rng.integers(0, 3, size=(q_n, w)).astype(np.float32)
    elif kind == "zeros":  # -0.0 and +0.0 tie; -1 beats both
        vals = np.where(rng.random((q_n, w)) < 0.5, -0.0, 0.0).astype(np.float32)
        vals[:, 1::5] = -1.0
    elif kind == "sparse":  # rows with fewer than k finite values
        vals = np.full((q_n, w), np.inf, np.float32)
        for r in range(q_n):
            hit = rng.choice(w, size=min(w, r % 4), replace=False)
            vals[r, hit] = rng.normal(size=hit.shape).astype(np.float32)
        vals[0, :1] = -np.inf  # selected first, id -1 as non-finite
    else:
        raise ValueError(kind)
    ids = rng.integers(0, 1 << 30, size=(q_n, w)).astype(np.int32)
    return vals, ids


def read_fvecs(path: str, max_rows: int | None = None) -> np.ndarray:
    """SIFT-style .fvecs reader: each row = i32 dim + dim f32 (LE)."""
    raw = np.fromfile(path, dtype="<i4")
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.float32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].view("<f4").copy()


def read_ivecs(path: str, max_rows: int | None = None) -> np.ndarray:
    """Ground-truth .ivecs reader: i32 dim + dim i32 per row."""
    raw = np.fromfile(path, dtype="<i4")
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.int32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].copy()


def dataset_path(name: str) -> str | None:
    """Look for benchmark datasets in conventional spots; None if absent
    (zero-egress environments fall back to synthetic corpora)."""
    for base in (os.environ.get("VERS_DATA", ""), "data", ".."):
        if not base:
            continue
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    return None
