"""Feature-dimension inference for the on-disk index formats.

The Rust reference needs no ``dim`` at load time because ``N`` is a
const generic baked into the binary (`vers/src/indexes/base.rs:45-58`);
the files themselves never store it. These helpers recover ``dim`` from
file structure instead, so ``load_index(path)`` works with no arguments
— ``dim=`` stays available as an override.

Strategies per format:
- Flat / IVFFlat: the layout is a fixed set of counted blocks, so the
  file size is an affine function of (n, k, d) — solve for d and verify
  an interior count field lands where it should.
- HNSW: the adjacency layers contain no vectors at all; stream-parse
  them d-free, then solve d from the trailing id->vec block.
- LSH: trees precede the vectors. If every root-reachable node is a
  leaf the trees parse d-free and the tail solves like Flat; otherwise
  candidate dims come from a structural scan of the first inner node
  (the u32 node tag following its coefficients must be 0 or 1) and each
  candidate is validated by a full strict parse to EOF.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

MAX_DIM = 1 << 16


def _u64_at(buf: bytes, off: int) -> int:
    return struct.unpack_from("<Q", buf, off)[0]


def infer_dim_flat(file_path: str) -> int:
    """[u64 n][n*d f32][u64 n][n u64 ids] -> d."""
    size = os.path.getsize(file_path)
    with open(file_path, "rb") as fp:
        head = fp.read(8)
        if len(head) < 8:
            raise ValueError(f"{file_path}: too short for a Flat index")
        n = _u64_at(head, 0)
        if n == 0:
            raise ValueError(
                f"{file_path}: empty Flat index stores no dim — pass dim="
            )
        rem = size - 16 - 8 * n
        if rem <= 0 or rem % (4 * n):
            raise ValueError(f"{file_path}: size does not fit a Flat layout")
        d = rem // (4 * n)
        fp.seek(8 + 4 * n * d)
        m = _u64_at(fp.read(8), 0)
        if m != n or d > MAX_DIM:
            raise ValueError(f"{file_path}: size does not fit a Flat layout")
        return int(d)


def infer_dim_ivfflat(file_path: str) -> int:
    """[u64 k][u64 n][n*d f32][u64 k][k*d f32][u64 n][n u64]
    [u64 k][k x vec_u64 totalling n] -> d.

    size = 40 + 4d(n+k) + 16n + 8k + 8k = 40 + 4d(n+k) + 16n + 16k?
    No: the per-cluster id lists hold n members total plus one u64
    length each: 8k + 8n. Full accounting (save_index field order,
    `ivfflat.rs:8-15`):
      8 (k) + 8+4nd (values) + 8+4kd (centroids) + 8+8n (assignments)
      + 8 (list count) + 8k + 8n (lists) = 40 + 4d(n+k) + 16n + 8k.
    """
    size = os.path.getsize(file_path)
    with open(file_path, "rb") as fp:
        head = fp.read(16)
        if len(head) < 16:
            raise ValueError(f"{file_path}: too short for an IVFFlat index")
        k = _u64_at(head, 0)
        n = _u64_at(head, 8)
        if n + k == 0:
            raise ValueError(
                f"{file_path}: empty IVFFlat index stores no dim — pass dim="
            )
        rem = size - 40 - 16 * n - 8 * k
        if rem <= 0 or rem % (4 * (n + k)):
            raise ValueError(f"{file_path}: size does not fit an IVFFlat layout")
        d = rem // (4 * (n + k))
        fp.seek(16 + 4 * n * d)
        k2 = _u64_at(fp.read(8), 0)
        if k2 != k or d > MAX_DIM:
            raise ValueError(f"{file_path}: size does not fit an IVFFlat layout")
        return int(d)


def infer_dim_hnsw(file_path: str) -> int:
    """Layers are d-free; solve d from the trailing id->vec block:
    remaining = count * (8 + 4d)."""
    size = os.path.getsize(file_path)
    with open(file_path, "rb") as fp:
        def u64():
            return _u64_at(fp.read(8), 0)

        fp.seek(24)  # ef_construction, ef_search, num_neighbours
        num_layers = u64()
        if num_layers > 1 << 20:
            raise ValueError(f"{file_path}: implausible HNSW layer count")
        for _ in range(num_layers):
            count = u64()
            for _ in range(count):
                fp.seek(8, 1)  # node id
                heap_len = u64()
                fp.seek(12 * heap_len, 1)  # (u64 id, f32 dist) pairs
                nbrs = u64()
                fp.seek(8 * nbrs, 1)
        fp.seek(4, 1)  # layer_multiplier f32
        n_vecs = u64()
        if n_vecs == 0:
            raise ValueError(
                f"{file_path}: empty HNSW index stores no dim — pass dim="
            )
        rem = size - fp.tell() - 8 * n_vecs
        if rem <= 0 or rem % (4 * n_vecs) or rem // (4 * n_vecs) > MAX_DIM:
            raise ValueError(f"{file_path}: size does not fit an HNSW layout")
        return int(rem // (4 * n_vecs))


def _lsh_try_parse(buf: bytes, dim: int) -> bool:
    """Strict structural parse of the whole LSH file at ``dim``;
    True iff it consumes exactly the file."""
    size = len(buf)
    num_trees = _u64_at(buf, 8)
    off = 16
    # iterative preorder walk: each inner node owes 2 children
    pending = num_trees
    while pending and off + 4 <= size:
        tag = struct.unpack_from("<I", buf, off)[0]
        off += 4
        pending -= 1
        if tag == 0:
            off += 4 * dim + 4
            pending += 2
        elif tag == 1:
            if off + 8 > size:
                return False
            cnt = _u64_at(buf, off)
            off += 8 + 8 * cnt
        else:
            return False
        if off > size:
            return False
    if pending:
        return False
    if off + 8 > size:
        return False
    n = _u64_at(buf, off)
    off += 8 + 4 * n * dim
    if off + 8 > size:
        return False
    m = _u64_at(buf, off)
    off += 8 + 8 * m
    return m == n and off == size


def infer_dim_lsh(file_path: str) -> int:
    """Trees precede the vectors, so no closed-form solve: generate
    candidate dims from the first inner node's structure (the u32 tag
    after its [f32; d] coefficients + f32 constant must be 0 or 1) and
    validate each with a full parse. All-leaf forests parse d-free and
    solve from the tail."""
    with open(file_path, "rb") as fp:
        buf = fp.read()
    if len(buf) < 20:
        raise ValueError(f"{file_path}: too short for an LSH index")

    # find the first inner node (d-free scan until one shows up)
    size = len(buf)
    num_trees = _u64_at(buf, 8)
    off = 16
    pending = num_trees
    first_inner: Optional[int] = None
    while pending and off + 4 <= size:
        tag = struct.unpack_from("<I", buf, off)[0]
        off += 4
        pending -= 1
        if tag == 0:
            first_inner = off  # coefficients start here
            break
        if tag != 1:
            raise ValueError(f"{file_path}: bad Node tag {tag}")
        cnt = _u64_at(buf, off)
        off += 8 + 8 * cnt
    if first_inner is None:
        # all leaves: the remainder is [u64 n][n*d f32][u64 n][n u64]
        if pending or off + 8 > size:
            raise ValueError(f"{file_path}: size does not fit an LSH layout")
        n = _u64_at(buf, off)
        if n == 0:
            raise ValueError(
                f"{file_path}: empty LSH index stores no dim — pass dim="
            )
        rem = size - off - 16 - 8 * n
        if rem <= 0 or rem % (4 * n) or rem // (4 * n) > MAX_DIM:
            raise ValueError(f"{file_path}: size does not fit an LSH layout")
        return int(rem // (4 * n))

    candidates: List[int] = []
    max_d = min(MAX_DIM, (size - first_inner - 8) // 4)
    for d in range(1, max_d + 1):
        tag_off = first_inner + 4 * d + 4
        if tag_off + 4 > size:
            break
        if struct.unpack_from("<I", buf, tag_off)[0] in (0, 1):
            candidates.append(d)
    for d in candidates:
        if _lsh_try_parse(buf, d):
            return d
    raise ValueError(
        f"{file_path}: could not infer dim (tried {len(candidates)} "
        "candidates) — pass dim="
    )
