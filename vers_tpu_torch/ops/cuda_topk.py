"""Kernels A and C, hand-written in CUDA C++ for Hopper.

Kernel A (``csrc/distance_topk.cu``), the fused distance + streaming
top-k scan, replaces ``vers_tpu/ops/pallas_topk.py:pallas_distance_topk``;
its plain version is ``ops/topk.fused_scan_topk``. Kernel C
(``csrc/topk_values.cu``), the smallest-k of a precomputed value array
with carried ids, replaces ``pallas_topk.py:pallas_topk_values``; its
plain version is ``ops/topk.topk_values_plain``. Kernel A takes an f32
or a bf16 corpus at each of the TPU's precision settings ("highest",
"high", "default"; ``topk.product_operands`` says what each computes),
six routes of one kernel (``route_name``). Kernel A cuts the
corpus into splits (``split_geometry``) and, when there is more than
one, takes the final k from the splits' best sets with kernel C. What
bounds each on the H100 and how the design answers that is in the
source note at the top of its ``.cu`` file.

One dispatch rule, by the input tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version. The JAX
package's k > 128 rule stays: such a k takes the plain version on any
device, counted in ``LARGE_K_PLAIN`` (kernel A) and
``LARGE_K_PLAIN_VALUES`` (kernel C).
"""

from __future__ import annotations

import functools

import torch

from vers_tpu_torch.core import COUNT_LOCK, count
from vers_tpu_torch.ops import _build
from vers_tpu_torch.ops.topk import (
    PRECISIONS,
    approx_scan_topk,
    fused_scan_topk,
    topk_values_plain,
)

MAX_K = 128

# Launches of kernel A by route (``route_name``: "f32/highest",
# "bf16/default", ...), one per successful launch; ``launches()`` is
# their sum. A call that splits the corpus also launches kernel C,
# counted in LAUNCHES_VALUES.
LAUNCHES_BY_ROUTE: dict = {}
# Calls routed to kernel A's plain version because k > MAX_K.
LARGE_K_PLAIN = 0
# Launches of kernel C.
LAUNCHES_VALUES = 0
# Calls routed to kernel C's plain version because k > MAX_K.
LARGE_K_PLAIN_VALUES = 0
# (Each counter moves by ``core.count``: shards launch from several
# threads at once.)

_METRICS = ("sq_euclidean", "cosine")


def launches() -> int:
    """Kernel A's launches over all its routes."""
    with COUNT_LOCK:
        return sum(LAUNCHES_BY_ROUTE.values())


def route_name(corpus_dtype: torch.dtype, precision: str) -> str:
    """Kernel A's route: the corpus dtype and the precision setting."""
    dt = "bf16" if corpus_dtype == torch.bfloat16 else "f32"
    return f"{dt}/{precision}"


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"kernel takes 1 <= k <= {MAX_K}, got {k}")


def check_query_corpus(queries: torch.Tensor, corpus: torch.Tensor,
                       corpus_dtypes=(torch.float32,)) -> None:
    """Raise unless queries (Q, d) f32 and corpus (N, d) of one of
    ``corpus_dtypes`` are contiguous CUDA tensors on one device with
    int32-sized row counts."""
    for name, t, dtypes in (("queries", queries, (torch.float32,)),
                            ("corpus", corpus, corpus_dtypes)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in dtypes:
            names = " or ".join(str(x).replace("torch.", "") for x in dtypes)
            raise TypeError(f"{name} must be {names}, got {t.dtype}")
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
    if max(queries.shape[0], corpus.shape[0]) >= 2**31:
        raise ValueError("row counts must fit the kernel's int32 sizes")


# corpus dtypes kernel A reads, and its precision settings' codes
CORPUS_DTYPES = (torch.float32, torch.bfloat16)
_PRECISION_CODE = {p: i for i, p in enumerate(PRECISIONS)}


def _check_inputs(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> None:
    check_query_corpus(queries, corpus, CORPUS_DTYPES)
    _check_k(k)


def _check_precision(precision: str) -> None:
    if precision not in _PRECISION_CODE:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")


# Kernel A's tiles (csrc/distance_tile.cuh: QT, CT).
QUERY_TILE = 64
TILE_ROWS = 128


@functools.lru_cache(maxsize=None)
def split_geometry(q_n: int, n_valid: int, sm_count: int):
    """Kernel A's corpus split: (n_split, split_rows), with split_rows a
    multiple of TILE_ROWS and the splits covering rows [0, n_valid).

    At least two blocks per SM are launched (query tiles x splits >=
    2 x sm_count) wherever the corpus has tiles enough. Among such
    splits, up to four times as many, the pick minimizes the block waves
    times the tiles per block (plus one for each block's set-up and
    flush), fewer splits on a tie."""
    tiles = max(1, -(-n_valid // TILE_ROWS))
    q_tiles = max(1, -(-q_n // QUERY_TILE))
    lo = min(tiles, -(-2 * sm_count // q_tiles))
    hi = min(tiles, max(lo, -(-8 * sm_count // q_tiles)), 65535)
    best = None
    for per in range(-(-tiles // lo), -(-tiles // hi) - 1, -1):
        n_split = -(-tiles // per)
        if n_split < lo:
            continue
        cost = -(-(q_tiles * n_split) // sm_count) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, n_split, per)
    if best is None:  # no split count in range reaches lo exactly
        per = max(1, tiles // lo)
        best = (0, -(-tiles // per), per)
    return best[1], best[2] * TILE_ROWS


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_pass(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    n_split: int | None = None,
    split_rows: int | None = None,
    precision: str = "highest",
):
    """Launch kernel A once: (vals, ids, n_split), each table (Q,
    n_split * k), columns [s * k, s * k + k) the ascending best set of
    split s. ``n_split`` / ``split_rows`` default to ``split_geometry``
    (given, they may leave splits wholly past n_valid: those hold (+inf,
    -1)). With one split the table is the result. The corpus is f32 or
    bf16; ``precision`` picks the kernel's route (the source note of
    ``csrc/distance_topk.cu``), counted in ``LAUNCHES_BY_ROUTE``."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    _check_precision(precision)
    _check_inputs(queries, corpus, k)
    q_n, d = queries.shape
    n_rows = corpus.shape[0]
    n_valid = max(0, min(int(n_valid), n_rows))
    if n_split is None:
        n_split, split_rows = split_geometry(q_n, n_valid,
                                             _sm_count(queries.device))
    width = n_split * k
    if n_split == 1:  # the result itself: prefilled as the contract says
        vals = torch.full((q_n, width), float("inf"), dtype=torch.float32,
                          device=queries.device)
        ids = torch.full((q_n, width), -1, dtype=torch.int32,
                         device=queries.device)
    else:  # every entry is written by the kernel
        vals = torch.empty((q_n, width), dtype=torch.float32,
                           device=queries.device)
        ids = torch.empty((q_n, width), dtype=torch.int32, device=queries.device)
    lib = _build.load_library()
    with torch.cuda.device(queries.device):
        rc = lib.vers_distance_topk(
            queries.data_ptr(), corpus.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), q_n, n_rows, d, n_valid, k,
            int(metric == "cosine"), n_split, split_rows,
            int(corpus.dtype == torch.bfloat16), _PRECISION_CODE[precision],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_distance_topk")
    count(LAUNCHES_BY_ROUTE, route_name(corpus.dtype, precision))
    return vals, ids, n_split


def cuda_distance_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
    precision: str = "highest",
):
    """Exact top-k: (dists (Q, k) f32 ascending, ids (Q, k) int32), id
    -1 where the distance is inf. Corpus rows >= n_valid are ignored.
    The corpus is f32 or bf16; ``precision`` rounds the products as
    ``topk.product_operands`` says.

    CUDA tensors launch kernel A (``split_pass``, counted in
    ``LAUNCHES_BY_ROUTE``) and, when the corpus was split, kernel C over the
    splits' best sets (counted in ``LAUNCHES_VALUES``). CPU tensors take
    ``fused_scan_topk`` (whose corpus chunk is ``chunk_size``; the kernel
    tiles itself)."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    _check_precision(precision)
    if not queries.is_cuda and not corpus.is_cuda:
        return fused_scan_topk(queries, corpus, n_valid, k, metric=metric,
                               chunk_size=chunk_size, precision=precision)
    vals, ids, n_split = split_pass(queries, corpus, n_valid, k, metric=metric,
                                    precision=precision)
    if n_split == 1:
        return vals, ids
    return cuda_topk_values(vals, ids, k)


def _check_values(vals: torch.Tensor, ids: torch.Tensor, k: int) -> None:
    for name, t, dtype in (("vals", vals, torch.float32),
                           ("ids", ids, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vals.device != ids.device:
        raise ValueError(f"vals on {vals.device} but ids on {ids.device}")
    if vals.shape != ids.shape:
        raise ValueError(
            f"shapes differ: {tuple(vals.shape)} vs {tuple(ids.shape)}"
        )
    _check_k(k)
    if vals.shape[0] >= 2**31 or vals.shape[1] >= 2**31:
        raise ValueError("sizes must fit the kernel's int32 sizes")


def values_buffer_keys(k: int) -> int:
    """Keys in a row's candidate buffer of kernel C: the power of two at
    or above 4 k (columns seen then grow about fourfold from one prune to
    the next, which costs the fewest compare-exchanges per row), at least
    k + 32 (one ballot's worth of room beside the kept k) and 64."""
    return 1 << (max(4 * k, k + 32, 64) - 1).bit_length()


def cuda_topk_values(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of each row with carried ids, as
    ``topk_values_plain``. CUDA tensors launch kernel C; CPU tensors
    take the plain version."""
    if not vals.is_cuda and not ids.is_cuda:
        return topk_values_plain(vals, ids, k)
    _check_values(vals, ids, k)
    q_n, w = vals.shape
    out_d = torch.full((q_n, k), float("inf"), dtype=torch.float32,
                       device=vals.device)
    out_i = torch.full((q_n, k), -1, dtype=torch.int32, device=vals.device)
    if q_n == 0 or w == 0:  # nothing to select from: no launch
        return out_d, out_i
    lib = _build.load_library()
    with torch.cuda.device(vals.device):
        rc = lib.vers_topk_values(
            vals.data_ptr(), ids.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), q_n, w, k, values_buffer_keys(k),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_topk_values")
    count(globals(), "LAUNCHES_VALUES")
    return out_d, out_i


def topk_values(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Dispatcher with ``vers_tpu.ops.pallas_topk.pallas_topk_values``'s
    contract: kernel C on CUDA tensors, the plain version on CPU tensors
    and for k > MAX_K."""
    if k > MAX_K:
        count(globals(), "LARGE_K_PLAIN_VALUES")
        return topk_values_plain(vals, ids, k)
    return cuda_topk_values(vals, ids, k)


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
    signature. ``force``: None (kernel A on CUDA tensors, plain version
    on CPU tensors, plain version for k > MAX_K), "pallas" (the kernel
    route, k <= MAX_K), "xla" (the plain version), "approx"
    (``approx_scan_topk``), "bucket" (``cuda_bucket.bucket_scan_topk``,
    kernels D and C). ``precision`` ("highest", "high", "default")
    reaches kernel A and its plain version; the approximate engines
    ignore it, as in the JAX package."""
    _check_precision(precision)
    if force == "approx":
        return approx_scan_topk(queries, corpus, n_valid, k, metric=metric)
    if force == "bucket":
        from vers_tpu_torch.ops.cuda_bucket import bucket_scan_topk

        return bucket_scan_topk(queries, corpus, n_valid, k, metric=metric)
    if force not in (None, "pallas", "xla"):
        raise ValueError(f"unknown force={force!r}")
    if force == "xla":
        return fused_scan_topk(queries, corpus, n_valid, k, metric=metric,
                               chunk_size=chunk_size, precision=precision)
    if k > MAX_K:
        if force == "pallas":
            raise ValueError(f"the kernel takes k <= {MAX_K}, got {k}")
        count(globals(), "LARGE_K_PLAIN")
        return fused_scan_topk(queries, corpus, n_valid, k, metric=metric,
                               chunk_size=chunk_size, precision=precision)
    return cuda_distance_topk(queries, corpus, n_valid, k, metric=metric,
                              chunk_size=chunk_size, precision=precision)
