"""The yardstick's peaks and bounds, frozen here so that no change to the
program moves them.

A copy of ``vers_tpu_torch/utils/roofline.py:17-29`` (the peaks and
``bound``) and ``:61-70`` (``packed_scan_bound``): NVIDIA's published
dense rates of one H100 SXM at its 700 W limit. A bound is the larger of
two times: the bytes the function must move (each input read once, each
output written once) over the memory rate, and its operations over the
peak rate for their type. Exact f32 products are counted on their
fastest route, the tensor cores' 3xTF32 split (three TF32 products for
each f32 one).
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


def packed_scan_bound(live_rows: int, out_rows: int, scanned: int,
                      probed_rows: int, d: int, k: int) -> dict:
    """Kernel B: exact f32 products of each live stacked query row with
    the rows of its bin (``scanned`` (row, corpus row) pairs in all), by
    3xTF32; the live rows and the probed bins' rows (with |x|^2 and bin)
    read once, (out_rows, k) results written."""
    return bound(3 * 2.0 * scanned * d, TF32,
                 4.0 * live_rows * d + (4.0 * d + 8.0) * probed_rows
                 + 8.0 * out_rows * k)
