"""The least time one NVIDIA H100 could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does on these inputs over the card's
peak rate for their type. Peaks are NVIDIA's published dense rates for
the H100 SXM at its 700 W limit. Exact f32 products are counted on their
fastest route, the tensor cores' 3xTF32 split (three TF32 products for
each f32 one).

Used by ``chip_smoke.py``, ``tools/time_kernel_d.py`` and
``tools/profile_torch_search.py``; the counts
come from the shapes of the run's own inputs.
"""

from __future__ import annotations

BF16 = 989e12           # flop/s, tensor cores, dense
TF32 = 495e12           # flop/s, tensor cores, dense
HBM = 3.35e12           # bytes/s


def bound(ops: float, rate: float, nbytes: float) -> dict:
    """``bound_ms`` = max(ops / rate, nbytes / HBM) in ms, and
    ``bound_by``: "operations" or "bytes", whichever sets it."""
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / HBM * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)


def distance_topk_bound(q_n: int, n_valid: int, d: int, k: int) -> dict:
    """Kernel A: exact f32 q.x for every (query, valid row), by 3xTF32;
    queries and valid rows read once, the (Q, k) result written."""
    return bound(3 * 2.0 * q_n * n_valid * d, TF32,
                 4.0 * (q_n * d + n_valid * d) + 8.0 * q_n * k)


def route_scan_bound(q_n: int, n1: int, d: int, k: int) -> dict:
    """Kernel A on HNSW's layer-1 routing scan: q.x for every (query,
    layer-1 row) of bf16-valued operands held in f32. A bf16 product is
    exact there, so the least work is one bf16 tensor-core product each
    (kernel A spends three TF32 ones); the f32 queries and rows read
    once, the (Q, k) result written."""
    return bound(2.0 * q_n * n1 * d, BF16,
                 4.0 * (q_n * d + n1 * d) + 8.0 * q_n * k)


def packed_scan_bound(live_rows: int, out_rows: int, scanned: int,
                      probed_rows: int, d: int, k: int) -> dict:
    """Kernel B: exact f32 products of each live stacked query row with
    the rows of its bin (``scanned`` (row, corpus row) pairs in all), by
    3xTF32; the live rows and the probed bins' rows (with |x|^2 and bin)
    read once, (out_rows, k) results written."""
    return bound(3 * 2.0 * scanned * d, TF32,
                 4.0 * live_rows * d + (4.0 * d + 8.0) * probed_rows
                 + 8.0 * out_rows * k)


def topk_values_bound(q_n: int, width: int, s: int) -> dict:
    """Kernel C: selection only; the (Q, W) values read once, the
    chosen ids gathered and the (Q, s) result written."""
    return bound(0.0, BF16, 4.0 * q_n * width + 12.0 * q_n * s)


def bucket_scan_bound(q_n: int, n_valid: int, d: int, width: int) -> dict:
    """Kernel D: bf16 q.x for every (query, valid row); the bf16 rows
    and their |x|^2, the f32 queries read once, the (Q, W) table of
    distances and rows written."""
    return bound(2.0 * q_n * n_valid * d, BF16,
                 (2.0 * d + 4.0) * n_valid + 4.0 * q_n * d
                 + 8.0 * q_n * width)
