"""The least time one NVIDIA H100 could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does on these inputs over the card's
peak rate for their type. Peaks are NVIDIA's published dense rates for
the H100 SXM at its 700 W limit. Exact f32 products are counted on their
fastest route, the tensor cores' 3xTF32 split (three TF32 products for
each f32 one); products of bf16 parts as bf16 tensor-core products.

Used by ``chip_smoke.py``, ``tools/time_kernel_d.py`` and
``tools/profile_torch_search.py``; the counts
come from the shapes of the run's own inputs.
"""

from __future__ import annotations

BF16 = 989e12           # flop/s, tensor cores, dense
TF32 = 495e12           # flop/s, tensor cores, dense
F32 = 67e12             # flop/s, CUDA cores (no tensor cores)
HBM = 3.35e12           # bytes/s


def bound(ops: float, rate: float, nbytes: float) -> dict:
    """``bound_ms`` = max(ops / rate, nbytes / HBM) in ms, and
    ``bound_by``: "operations" or "bytes", whichever sets it."""
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / HBM * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)


# bf16 tensor-core products for each exact product of kernel A's
# operands, by (corpus dtype, precision): an f32 query needs three bf16
# parts to hold its 24 mantissa bits, a bf16 row one. "high" is the TPU's
# bf16_3x (three products; two when the corpus is bf16, its lo part 0).
_BF16_PRODUCTS = {
    ("bf16", "highest"): 3, ("bf16", "high"): 2, ("bf16", "default"): 1,
    ("f32", "high"): 3, ("f32", "default"): 1,
}


def distance_topk_bound(q_n: int, n_valid: int, d: int, k: int,
                        corpus: str = "f32",
                        precision: str = "highest") -> dict:
    """Kernel A on one route: q.x for every (query, valid row) at the
    least product cost of the route (f32 x f32 at "highest": 3xTF32,
    three TF32 products; the others ``_BF16_PRODUCTS`` bf16 ones); the
    f32 queries and the valid rows (4 or 2 bytes a value) read once,
    the (Q, k) result written."""
    pairs = 2.0 * q_n * n_valid * d
    nbytes = (4.0 * q_n * d + (2.0 if corpus == "bf16" else 4.0) * n_valid * d
              + 8.0 * q_n * k)
    if (corpus, precision) == ("f32", "highest"):
        return bound(3 * pairs, TF32, nbytes)
    return bound(_BF16_PRODUCTS[corpus, precision] * pairs, BF16, nbytes)


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


def beam_step_bound(q_n: int, ef: int, e: int, deg: int, dp: int, r: int,
                    d: int, picked=None, live=None, refined=None) -> dict:
    """One step of the HNSW inline beam over ``q_n`` queries: the bf16
    queries read, the (ef) state (f32, int64, bool) read and written,
    and, over all queries, ``picked`` adjacency rows (deg int32),
    ``live`` candidates' inline blocks (dp bf16) and ``refined``
    full-dim rows (d bf16); every projected and full-dim product an f32
    FMA on the CUDA cores. The three counts default to the full width
    (q_n * e, q_n * e * deg and q_n * r); the step kernel loads rows for
    picked entries, live candidates and refined ids alone, so a step's
    own counts give the bound of what it read."""
    picked = q_n * e if picked is None else picked
    live = q_n * e * deg if live is None else live
    refined = q_n * r if refined is None else refined
    nbytes = (4.0 * deg * picked + 2.0 * dp * live + 2.0 * d * refined
              + q_n * (2.0 * (dp + (d if r else 0)) + 2.0 * 13.0 * ef))
    return bound(2.0 * (live * dp + refined * d), F32, nbytes)
