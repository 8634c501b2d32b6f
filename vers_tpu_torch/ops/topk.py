"""Top-k selection and the fused distance+top-k corpus scan as plain
torch ops (counterpart of ``vers_tpu.ops.topk``).

``fused_scan_topk`` is the plain version of kernel A
(``ops/cuda_topk.py``): it streams the corpus through the distance
matmul in chunks and carries a running (Q, k) best set, so the full
(Q, N) distance matrix is never materialized.
"""

from __future__ import annotations

import torch

from vers_tpu_torch.ops.distance import pairwise_distance


def topk_smallest(dist: torch.Tensor, k: int):
    """Smallest-k along the last axis. Returns (values, indices int64),
    ascending by distance; ties go to the lowest index, matching the
    reference's stable sorts. ``torch.topk`` promises no tie order, so
    k == 1 is an argmin (first minimum) and larger k a stable sort."""
    if k == 1:
        idx = torch.argmin(dist, dim=-1, keepdim=True)
        return torch.gather(dist, -1, idx), idx
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def fused_scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
):
    """Exact top-k nearest corpus rows for each query, O(Q*k + chunk)
    memory.

    Args:
      queries: (Q, d)
      corpus: (N_pad, d) — rows >= n_valid are padding and are ignored.
      n_valid: number of live corpus rows.
      k: neighbours per query.
      metric: "sq_euclidean" | "cosine".
      chunk_size: corpus rows per scan step.

    Returns:
      (dists (Q, k) f32, indices (Q, k) int32), ascending by distance.
      If k > n_valid the tail is (+inf, -1).
    """
    n_pad = corpus.shape[0]
    q_n = queries.shape[0]
    dev = queries.device
    chunk = max(1, min(chunk_size, n_pad))
    best_d = torch.full((q_n, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((q_n, k), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, n_pad, chunk):
        x = corpus[c0 : c0 + chunk]
        rows = torch.arange(c0, c0 + x.shape[0], dtype=torch.int32, device=dev)
        dist = pairwise_distance(queries, x, metric)
        dist = torch.where(rows[None, :] < n_valid, dist, float("inf"))
        cand_d = torch.cat([best_d, dist], dim=1)
        cand_i = torch.cat([best_i, rows[None, :].expand(q_n, -1)], dim=1)
        best_d, sel = topk_smallest(cand_d, k)
        best_i = torch.gather(cand_i, 1, sel)
        best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i
