"""Native (C++) host-side IO, bound with ctypes (counterpart of
``vers_tpu.native``).

``io_native.cpp`` (the port's own copy of the JAX package's source)
supplies the `.vec` dataset parser (`vers/src/utils.rs:7-66`) and a
one-pass HNSW bincode scanner (`vers/src/indexes/base.rs:31-58` +
`models.rs:149-153` layout). It is host file IO only; nothing here
touches a device.

The library is built with ``g++`` on first use into
``vers_tpu_torch/_build/`` (its file name carries a hash of the source,
so an edited source rebuilds). Where there is no toolchain, or with
``VERS_NATIVE=0``, ``available()`` is False, ``parse_vec`` and
``hnsw_scan`` return None, and the callers
(``utils.data.load_vec_file``, ``HNSWIndex.load_index``) take their
Python readers, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from vers_tpu_torch.utils.logging import get_logger

SOURCE = Path(__file__).resolve().parent / "io_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lib_tried = False


class _VecFile(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("words", ctypes.POINTER(ctypes.c_char)),
        ("word_ends", ctypes.POINTER(ctypes.c_uint64)),
        ("n_rows", ctypes.c_uint64),
        ("words_len", ctypes.c_uint64),
    ]


class _HnswScan(ctypes.Structure):
    _fields_ = [
        ("ef_construction", ctypes.c_uint64),
        ("ef_search", ctypes.c_uint64),
        ("num_neighbours", ctypes.c_uint64),
        ("num_layers", ctypes.c_uint64),
        ("layer_counts", ctypes.POINTER(ctypes.c_uint64)),
        ("n_nodes_total", ctypes.c_uint64),
        ("node_ids", ctypes.POINTER(ctypes.c_uint64)),
        ("heap_lens", ctypes.POINTER(ctypes.c_uint64)),
        ("nbr_lens", ctypes.POINTER(ctypes.c_uint64)),
        ("heap_ids", ctypes.POINTER(ctypes.c_uint64)),
        ("heap_dists", ctypes.POINTER(ctypes.c_float)),
        ("nbrs", ctypes.POINTER(ctypes.c_uint64)),
        ("heap_total", ctypes.c_uint64),
        ("nbr_total", ctypes.c_uint64),
        ("layer_multiplier", ctypes.c_float),
        ("n_vecs", ctypes.c_uint64),
        ("vec_ids", ctypes.POINTER(ctypes.c_uint64)),
        ("vecs", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_int),
    ]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libversio_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """g++ into a file of this process, then renamed into place (test
    workers may build at once)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        get_logger().warning("native IO: build skipped (%s); Python readers "
                             "in use", e)
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("VERS_NATIVE", "1") == "0":
        return None
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))
    lib.vers_parse_vec.restype = ctypes.POINTER(_VecFile)
    lib.vers_parse_vec.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
    ]
    lib.vers_free_vec.argtypes = [ctypes.POINTER(_VecFile)]
    lib.vers_hnsw_scan.restype = ctypes.POINTER(_HnswScan)
    lib.vers_hnsw_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vers_free_hnsw.argtypes = [ctypes.POINTER(_HnswScan)]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded: the path that
    ``load_vec_file`` and ``HNSWIndex.load_index`` take."""
    return _load() is not None


def parse_vec(
    path: str, dim: int, header: bool = True, max_rows: Optional[int] = None
) -> Optional[Tuple[List[str], np.ndarray]]:
    """Native `.vec` parse -> (words, (n, dim) float32); None where the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ptr = lib.vers_parse_vec(
        str(path).encode(), dim, 1 if header else 0, max_rows or 0
    )
    if not ptr:
        raise FileNotFoundError(path)
    try:
        v = ptr.contents
        n = int(v.n_rows)
        embs = (np.ctypeslib.as_array(v.data, shape=(n, dim)).copy() if n
                else np.zeros((0, dim), np.float32))
        ends = (np.ctypeslib.as_array(v.word_ends, shape=(n,)).copy() if n
                else np.zeros((0,), np.uint64))
        blob = ctypes.string_at(v.words, int(v.words_len))
        words, prev = [], 0
        for e in ends:
            words.append(blob[prev:int(e)].decode("utf-8", errors="replace"))
            prev = int(e)
        return words, embs
    finally:
        lib.vers_free_vec(ptr)


def hnsw_scan(path: str, dim: int) -> Optional[dict]:
    """One-pass native decode of an HNSW bincode file into flat numpy
    arrays (see io_native.cpp for the layout); None where the library
    is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ptr = lib.vers_hnsw_scan(str(path).encode(), dim)
    if not ptr:
        raise FileNotFoundError(path)
    try:
        s = ptr.contents
        if s.error:
            raise EOFError(f"truncated/corrupt HNSW file: {path}")

        def arr(p, n, dt):
            n = int(n)
            if n == 0:
                return np.zeros((0,), dt)
            return np.ctypeslib.as_array(p, shape=(n,)).astype(dt, copy=True)

        nv = int(s.n_vecs)
        return dict(
            ef_construction=int(s.ef_construction),
            ef_search=int(s.ef_search),
            num_neighbours=int(s.num_neighbours),
            num_layers=int(s.num_layers),
            layer_counts=arr(s.layer_counts, s.num_layers, np.int64),
            node_ids=arr(s.node_ids, s.n_nodes_total, np.int64),
            heap_lens=arr(s.heap_lens, s.n_nodes_total, np.int64),
            nbr_lens=arr(s.nbr_lens, s.n_nodes_total, np.int64),
            heap_ids=arr(s.heap_ids, s.heap_total, np.int64),
            heap_dists=arr(s.heap_dists, s.heap_total, np.float32),
            nbrs=arr(s.nbrs, s.nbr_total, np.int64),
            layer_multiplier=float(s.layer_multiplier),
            vec_ids=arr(s.vec_ids, s.n_vecs, np.int64),
            vecs=(np.ctypeslib.as_array(s.vecs, shape=(nv, dim)).copy() if nv
                  else np.zeros((0, dim), np.float32)),
        )
    finally:
        lib.vers_free_hnsw(ptr)
