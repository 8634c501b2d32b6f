"""Kernels A and C, hand-written in CUDA C++ for Hopper.

Kernel A (``csrc/distance_topk.cu``), the fused distance + streaming
top-k scan, replaces ``vers_tpu/ops/pallas_topk.py:pallas_distance_topk``;
its plain version is ``ops/topk.fused_scan_topk``. Kernel C
(``csrc/topk_values.cu``), the smallest-k of a precomputed value array
with carried ids, replaces ``pallas_topk.py:pallas_topk_values``; its
plain version is ``ops/topk.topk_values_plain``. Kernel A takes an f32
or a bf16 corpus at each of the TPU's precision settings ("highest",
"high", "default"; ``topk.product_operands`` says what each computes),
six routes of one kernel (``route_name``). Each call follows a plan
(``kernel_plan``, a pure function of the shapes and the card: query
tile, ring slots, where the query parts live, corpus splits); when the
corpus is split, kernel C takes the final k from the splits' best sets.
What bounds each on the H100 and how the design answers that is in the
source notes of ``csrc/distance_topk.cu`` and ``csrc/distance_bf16.cu``.

One dispatch rule, by the input tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version. The JAX
package's k > 128 rule stays: such a k takes the plain version on any
device, counted in ``LARGE_K_PLAIN`` (kernel A) and
``LARGE_K_PLAIN_VALUES`` (kernel C).
"""

from __future__ import annotations

import dataclasses
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


# Kernel A's shapes (csrc/distance_tile.cuh, csrc/distance_bf16.cu): corpus
# rows a tile; the f32/highest route's query tile and ring slots; the
# bf16 routes' most ring slots and bytes of a bf16 part of a slice.
TILE_ROWS = 128
TF32_QUERY_TILE = 64
TF32_SLOTS = 3
SLOTS_MAX = 8
_PART_BYTES = TILE_ROWS * 128
# Shared memory: what a block may opt into and what an SM holds (a block
# reserves 1 KB beside its own), on the H100.
SMEM_BLOCK = 232_448
SMEM_SM = 233_472

# (query parts, f32 corpus) of each bf16 route
_BF16_ROUTES = {
    "bf16/highest": (3, False),
    "bf16/high": (2, False),
    "bf16/default": (1, False),
    "f32/high": (2, True),
    "f32/default": (1, True),
}


@dataclasses.dataclass(frozen=True)
class Plan:
    """Kernel A's launch plan for one call: the query tile (rows a
    block), the ring's slots, whether the query parts are resident in
    shared memory (else split a slice at a time in registers), the bf16
    parts of each query in its products (0 on the 3xTF32 route), the
    block's shared bytes, the blocks an SM holds by those bytes, and the
    corpus split (``n_split`` splits of ``split_rows`` rows)."""

    route: str
    query_tile: int
    slots: int
    resident: bool
    parts: int
    smem_bytes: int
    blocks_per_sm: int
    n_split: int
    split_rows: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def tf32_smem_bytes(d: int, k: int, resident: bool) -> int:
    """``make_layout`` of csrc/distance_tile.cuh: the f32/highest route's
    shared bytes a block (3 slots of 128 x 32 f32 and their lo parts, the
    resident f32 query tile at pitch qp, the distance tile, masks, norms,
    kth, |x|^2, 11 mbarriers, the best sets)."""
    qt, dm = TF32_QUERY_TILE, -(-d // 8) * 8
    qp = (dm if dm % 16 else dm + 8) if resident else 0
    return (2 * TF32_SLOTS * TILE_ROWS * 32 * 4 + qt * qp * 4
            + qt * (TILE_ROWS + 4) * 4 + qt * 16 + qt * 8
            + TF32_SLOTS * TILE_ROWS * 4 + (3 * TF32_SLOTS + 2) * 8
            + k * qt * 8 + 1024)


def bf16_smem_bytes(route: str, d: int, k: int, query_tile: int, slots: int,
                    resident: bool) -> int:
    """``make_layout_b`` of csrc/distance_tile.cuh: a bf16 route's shared
    bytes a block. Per slot a 16 KB bf16 part of a 128 x 64 slice (32 KB
    for an f32 corpus, staged as f32 and converted in place; for a bf16
    corpus with d % 8 == 4, 1 KB more: its odd rows land 144 bytes a row
    over the slot's second half and are moved into place) and three
    mbarriers; the resident query parts (parts x 64-feature slices x rows
    of 128 bytes); the distance tile (query_tile x 128 f32), two copies of
    the candidate masks, norms, kth, two tiles' |x|^2, four mbarriers and
    the best sets (query_tile rows of k f32 and int32 at an odd pitch, k |
    1); 1 KB to align the base."""
    ap, f32 = _BF16_ROUTES[route]
    qt = query_tile
    a = ap * -(-d // 64) * qt * 128 if resident else 0
    slot = 2 * _PART_BYTES if f32 else _PART_BYTES + (1024 if d % 8 == 4 else 0)
    return (slots * (slot + 24) + a
            + qt * TILE_ROWS * 4 + qt * 32 + qt * 8 + 2 * TILE_ROWS * 4 + 32
            + (k | 1) * qt * 8 + 1024)


def tile_plan(route: str, d: int, k: int, q_n: int,
              smem_limit: int = SMEM_BLOCK):
    """(query_tile, slots, resident, smem bytes) for one route, from the
    shared-memory arithmetic alone. The f32/highest route keeps its one
    plan (64 queries, 3 slots, its f32 query tile resident where it
    fits). A bf16 route takes the first of: 128 queries with resident
    parts (only where Q > 64), 64 queries with resident parts, 64 queries
    split in registers, that leaves room for two slots; then as many
    slots as fit, up to SLOTS_MAX. The order is measured
    (``tools/time_kernel_a.py --plans`` at 16384 x 1M x 300, PERF.md
    §6): 128 queries with two slots beat 64 with three to eight
    (bf16/default 69.4 against 87.9-89.1 ms, f32/default 84.8 against
    94.9-95.3; the corpus is read from L2 half as often), more slots
    never lost (two to three: 69.4 to 53.2 ms), and the RS path lost to
    resident parts at any slot count (bf16/highest 187-219 ms against
    135.4 with two slots). Raises, naming the shape, where none fits."""
    _check_k(k)
    if route == "f32/highest":
        for resident in (True, False):
            smem = tf32_smem_bytes(d, k, resident)
            if smem <= smem_limit:
                return TF32_QUERY_TILE, TF32_SLOTS, resident, smem
        raise ValueError(f"kernel A f32/highest: no plan fits {smem_limit} "
                         f"bytes of shared memory at d={d}, k={k}")
    if route not in _BF16_ROUTES:
        raise ValueError(f"unknown route {route!r}")
    options = [(128, True)] if q_n > 64 else []
    for qt, resident in options + [(64, True), (64, False)]:
        fixed = bf16_smem_bytes(route, d, k, qt, 0, resident)
        per_slot = bf16_smem_bytes(route, d, k, qt, 1, resident) - fixed
        slots = min(SLOTS_MAX, (smem_limit - fixed) // per_slot)
        if slots >= 2:
            return (qt, slots, resident,
                    bf16_smem_bytes(route, d, k, qt, slots, resident))
    raise ValueError(f"kernel A {route}: no plan fits {smem_limit} bytes of "
                     f"shared memory at d={d}, k={k}")


def kernel_plan(route: str, q_n: int, n_valid: int, d: int, k: int,
                sm_count: int, smem_limit: int = SMEM_BLOCK) -> Plan:
    """Kernel A's plan: ``tile_plan``, then the corpus split
    (``split_geometry``; the f32/highest route keeps
    ``split_geometry_tf32``). A pure function of the shapes and the card
    (its SM count and the shared memory a block may take)."""
    qt, slots, resident, smem = tile_plan(route, d, k, q_n, smem_limit)
    blocks = max(1, SMEM_SM // (smem + 1024))
    if route == "f32/highest":
        n_split, split_rows = split_geometry_tf32(q_n, n_valid, sm_count)
        parts = 0
    else:
        n_split, split_rows = split_geometry(q_n, n_valid, sm_count * blocks,
                                             qt)
        parts = _BF16_ROUTES[route][0]
    return Plan(route, qt, slots, resident, parts, smem, blocks, n_split,
                split_rows)


@functools.lru_cache(maxsize=None)
def split_geometry_tf32(q_n: int, n_valid: int, sm_count: int):
    """The f32/highest route's corpus split: (n_split, split_rows), with
    split_rows a multiple of TILE_ROWS and the splits covering rows [0,
    n_valid).

    At least two blocks per SM are launched (query tiles x splits >=
    2 x sm_count) wherever the corpus has tiles enough. Among such
    splits, up to four times as many, the pick minimizes the block waves
    times the tiles per block (plus one for each block's set-up and
    flush), fewer splits on a tie."""
    tiles = max(1, -(-n_valid // TILE_ROWS))
    q_tiles = max(1, -(-q_n // TF32_QUERY_TILE))
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
def split_geometry(q_n: int, n_valid: int, slots_on_card: int,
                   query_tile: int):
    """A bf16 route's corpus split: (n_split, split_rows), split_rows a
    multiple of TILE_ROWS, the splits covering rows [0, n_valid) in row
    order, none empty. ``slots_on_card``: the blocks the card runs at
    once (SMs x blocks an SM).

    The most splits whose blocks (query tiles x splits) fit one wave, at
    least one, at most one a tile. Every block pays its set-up and the
    fill of its k best sets (the first tiles' merges, which grow with k),
    so a second wave pays them again where one block a slot would have
    walked more tiles; within one wave more splits only shorten each
    block's walk, against a second pass (kernel C) of 0.04-0.13 ms. The
    sweeps of ``tools/time_kernel_a.py --splits`` on the H100 (PERF.md
    §6) peak there at k = 1, 8, 10 and 100: e.g. the scan-routed build's
    k = 100 scan (Q = 256 over 41,368 rows) at 33 splits (4 x 33 = 132
    blocks) against 47 (two waves) and 25."""
    tiles = max(1, -(-n_valid // TILE_ROWS))
    q_tiles = max(1, -(-q_n // query_tile))
    n_split = min(tiles, 65535, max(1, slots_on_card // q_tiles))
    per = -(-tiles // n_split)
    return -(-tiles // per), per * TILE_ROWS


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _smem_limit(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def plan_for(queries: torch.Tensor, corpus: torch.Tensor, n_valid: int,
             k: int, precision: str = "highest") -> Plan:
    """``kernel_plan`` for these inputs on their card."""
    q_n, d = queries.shape
    n_valid = max(0, min(int(n_valid), corpus.shape[0]))
    return kernel_plan(route_name(corpus.dtype, precision), q_n, n_valid, d,
                       k, _sm_count(queries.device),
                       _smem_limit(queries.device))


def split_pass(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    n_split: int | None = None,
    split_rows: int | None = None,
    precision: str = "highest",
    plan: Plan | None = None,
):
    """Launch kernel A once: (vals, ids, n_split), each table (Q,
    n_split * k), columns [s * k, s * k + k) the ascending best set of
    split s. The launch follows ``plan_for`` (``kernel_plan`` on these
    inputs' card); ``n_split`` / ``split_rows`` or a whole ``plan`` (a
    sweep's) replace its split or all of it (given splits may leave some
    wholly past n_valid: those hold (+inf, -1)); the card refuses a plan
    it cannot hold. With one split the table is the result. The corpus
    is f32 or bf16; ``precision`` picks the kernel's route (the source
    note of ``csrc/distance_topk.cu``), counted in
    ``LAUNCHES_BY_ROUTE``."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    _check_precision(precision)
    _check_inputs(queries, corpus, k)
    q_n, d = queries.shape
    n_rows = corpus.shape[0]
    n_valid = max(0, min(int(n_valid), n_rows))
    if plan is None:
        plan = plan_for(queries, corpus, n_valid, k, precision)
    if n_split is not None:
        plan = dataclasses.replace(plan, n_split=n_split, split_rows=split_rows)
    n_split = plan.n_split
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
            int(metric == "cosine"), n_split, plan.split_rows,
            int(corpus.dtype == torch.bfloat16), _PRECISION_CODE[precision],
            plan.query_tile, plan.slots, int(plan.resident),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_distance_topk")
    count(LAUNCHES_BY_ROUTE, route_name(corpus.dtype, precision))
    return vals, ids, n_split


def card_plan(plan: Plan, d: int, k: int) -> tuple:
    """(shared bytes, blocks an SM) of ``plan`` as the built kernel and
    the current card have them (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    dt, precision = plan.route.split("/")
    out = (ctypes.c_int * 2)()
    lib = _build.load_library()
    rc = lib.vers_distance_topk_plan(d, k, int(dt == "bf16"),
                                     _PRECISION_CODE[precision],
                                     plan.query_tile, plan.slots,
                                     int(plan.resident), out)
    _build.check(lib, rc, "vers_distance_topk_plan")
    return out[0], out[1]


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
