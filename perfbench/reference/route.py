"""Kernel A's bound on the HNSW search's routing scan, frozen here so
that no change to the program moves it.

A copy of ``vers_tpu_torch/utils/roofline.py:44-60``
(``distance_topk_bound``) on the route the scan takes, the bf16 corpus
at precision "default", on the peaks of ``peaks.py``: kernel A scans
every layer-1 row for each query, one bf16 tensor-core product a (query,
row) pair (the rows stored in bf16, the query rounded to bf16); the bound
is the larger of those operations over the bf16 peak and of the bytes
(the f32 queries and the bf16 rows read once, the (Q, k) result written)
over the memory rate.
"""

from __future__ import annotations

from .peaks import BF16, bound


def route_scan_bound(q_n: int, n1: int, d: int, k: int) -> dict:
    """The routing scan of ``q_n`` queries over ``n1`` layer-1 rows of
    width ``d``, ``k`` seeds a query."""
    return bound(2.0 * q_n * n1 * d, BF16,
                 4.0 * q_n * d + 2.0 * n1 * d + 8.0 * q_n * k)
