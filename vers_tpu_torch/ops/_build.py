"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects
are linked into ONE shared library with a plain C interface, loaded with
``ctypes``. The build runs on first use from a CUDA tensor and lands in
``vers_tpu_torch/_build/``; the library's file name carries a hash of the
sources, so an edited source rebuilds and an unchanged one is reused.

Only CUDA code paths call ``load_library``; importing this module builds
nothing and needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as
# void*, sizes as int). Each returns a cudaError_t as int.
_SIGNATURES = {
    # q, x, out_d, out_i, Q, n_rows, d, n_valid, k, cosine, n_split,
    # split_rows, x_bf16, precision, query_tile, slots, resident, stream
    "vers_distance_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P],
    # d, k, x_bf16, precision, query_tile, slots, resident, out (2 ints:
    # shared bytes, blocks an SM)
    "vers_distance_topk_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
    # q_stack, qbin, qb, gb, corpus, rbin, xx, ids (nullable), out_d,
    # out_i, plan (3 ints of scratch a block, nullable), walked (an int a
    # block, nullable), n_rows, n_corpus, d, W, q_blk, r_blk, k, cosine,
    # split, stream
    "vers_packed_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # out (3 ints): the scan's query tile, corpus tile and plan limit
    "vers_packed_scan_constants": [_P],
    # vals, ids, out_d, out_i, Q, W, k, cap, stream
    "vers_topk_values": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q (bf16), x (bf16), qq, xx, out_d, out_i, Q, n_rows, d_pad, n_valid,
    # span, n_super, cosine, stream
    "vers_bucket_scan": [_P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _P],
    # stage (an index of trace.STAGES), stream
    "vers_trace_mark": [_I, _P],
    # beam_d, beam_i, expanded, qp, qn (nullable), adj, inline table,
    # vecs (nullable), active, Q, ef, e, deg, n_pad, dp, r, d, vw, stream
    "vers_beam_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
_LOAD_LOCK = threading.Lock()  # one build, whichever thread asks first
build_info: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvers_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library. Raises on any
    build or load failure; ``build_info`` records the build's seconds
    and the compiler's resource report (``-Xptxas -v``), which is kept
    beside the library for a later process that finds it built. Threads
    that ask at once wait for one build."""
    if _lib is None:
        with _LOAD_LOCK:
            if _lib is None:
                _load()
    return _lib


def _load() -> None:
    global _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [p.returncode for p in procs if p.returncode]
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", NVCC_FLAGS[0], NVCC_FLAGS[1], "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode else []
        for obj in objs:
            obj.unlink(missing_ok=True)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_info['log']}")
        path.with_suffix(".log").write_text(build_info["log"])
        os.replace(tmp, path)
    else:
        log = path.with_suffix(".log")
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", log.read_text() if log.exists() else "")
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vers_error_string.argtypes = [ctypes.c_int]
    lib.vers_error_string.restype = ctypes.c_char_p
    _lib = lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.vers_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
