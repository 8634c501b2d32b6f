"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, loaded with ``ctypes``.
The build runs on first use from a CUDA tensor and lands in
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
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as
# void*, sizes as int). Each returns a cudaError_t as int.
_SIGNATURES = {
    # q, x, xx, out_d, out_i, Q, n_rows, d, n_valid, k, cosine, stream
    "vers_distance_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q_stack, qbin, qb, gb, corpus, rbin, xx, ids (nullable), out_d,
    # out_i, n_rows, d, W, q_blk, r_blk, k, cosine, stream
    "vers_packed_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
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
    and the compiler's resource report (``-Xptxas -v``)."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{build_info['log']}"
            )
        os.replace(tmp, path)
    else:
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "")
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vers_error_string.argtypes = [ctypes.c_int]
    lib.vers_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.vers_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
