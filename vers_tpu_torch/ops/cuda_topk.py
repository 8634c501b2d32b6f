"""Kernel A: the fused distance + streaming top-k scan, hand-written in
CUDA C++ for Hopper (``csrc/distance_topk.cu``).

Replaces ``vers_tpu/ops/pallas_topk.py:pallas_distance_topk``. What
bounds it on the H100 and how the design answers that is in the source
note at the top of the ``.cu`` file. Its plain version is
``ops/topk.fused_scan_topk``.

One dispatch rule, by the input tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version. The JAX
package's k > 128 rule stays: such a k takes the plain version on any
device, counted in ``LARGE_K_PLAIN``.
"""

from __future__ import annotations

import torch

from vers_tpu_torch.ops import _build
from vers_tpu_torch.ops.topk import fused_scan_topk

MAX_K = 128

# Launches of the CUDA kernel (one per successful launch).
LAUNCHES = 0
# Calls routed to the plain version because k > MAX_K.
LARGE_K_PLAIN = 0

_METRICS = ("sq_euclidean", "cosine")


def _check_inputs(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> None:
    for name, t in (("queries", queries), ("corpus", corpus)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.device != corpus.device:
        raise ValueError(
            f"queries on {queries.device} but corpus on {corpus.device}"
        )
    if queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"feature dims differ: {queries.shape[1]} vs {corpus.shape[1]}"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"kernel takes 1 <= k <= {MAX_K}, got {k}")
    if max(queries.shape[0], corpus.shape[0]) >= 2**31:
        raise ValueError("row counts must fit the kernel's int32 sizes")


def cuda_distance_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
):
    """Exact top-k: (dists (Q, k) f32 ascending, ids (Q, k) int32), id
    -1 where the distance is inf. Corpus rows >= n_valid are ignored.

    CUDA tensors launch kernel A; CPU tensors take ``fused_scan_topk``
    (whose corpus chunk is ``chunk_size``; the kernel tiles itself)."""
    global LAUNCHES
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if not queries.is_cuda and not corpus.is_cuda:
        return fused_scan_topk(queries, corpus, n_valid, k, metric=metric,
                               chunk_size=chunk_size)
    _check_inputs(queries, corpus, k)
    q_n, d = queries.shape
    n_rows = corpus.shape[0]
    n_valid = max(0, min(int(n_valid), n_rows))
    xx = torch.sum(corpus * corpus, dim=1)
    out_d = torch.full((q_n, k), float("inf"), dtype=torch.float32,
                       device=queries.device)
    out_i = torch.full((q_n, k), -1, dtype=torch.int32, device=queries.device)
    lib = _build.load_library()
    with torch.cuda.device(queries.device):
        rc = lib.vers_distance_topk(
            queries.data_ptr(), corpus.data_ptr(), xx.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            q_n, n_rows, d, n_valid, k, int(metric == "cosine"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_distance_topk")
    LAUNCHES += 1
    return out_d, out_i


def distance_topk(
    queries,
    corpus,
    n_valid,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
    force: str | None = None,
    precision: str = "highest",
):
    """Dispatcher with ``vers_tpu.ops.pallas_topk.distance_topk``'s
    signature. ``force``: None (kernel on CUDA tensors, plain version on
    CPU tensors, plain version for k > MAX_K), "pallas" (the kernel
    route, k <= MAX_K), "xla" (the plain version). The JAX package's
    "approx" and "bucket" engines are not ported yet (ROADMAP queue 1,
    item 1.9) and raise."""
    global LARGE_K_PLAIN
    if precision != "highest":
        raise ValueError("only precision='highest' (float32) is ported")
    if force in ("approx", "bucket"):
        raise NotImplementedError(
            f"force={force!r}: the flat approximate engines are not ported "
            "yet (ROADMAP queue 1, item 1.9)"
        )
    if force not in (None, "pallas", "xla"):
        raise ValueError(f"unknown force={force!r}")
    if force == "xla":
        return fused_scan_topk(queries, corpus, n_valid, k, metric=metric,
                               chunk_size=chunk_size)
    if k > MAX_K:
        if force == "pallas":
            raise ValueError(f"the kernel takes k <= {MAX_K}, got {k}")
        LARGE_K_PLAIN += 1
        return fused_scan_topk(queries, corpus, n_valid, k, metric=metric,
                               chunk_size=chunk_size)
    return cuda_distance_topk(queries, corpus, n_valid, k, metric=metric,
                              chunk_size=chunk_size)
