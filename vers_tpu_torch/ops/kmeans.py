"""Lloyd k-means, the build behind IVFFlat (counterpart of
``vers_tpu.ops.kmeans``; the reference is `vers/src/indexes/ivfflat.rs:18-149`).

- assignment is a chunked (n, k) distance matmul + argmin (first
  minimum on ties),
- the centroid update is a segment-sum; an empty cluster becomes a zero
  vector (parity with `ivfflat.rs:63-67`),
- the loop stops when the centroids are bitwise equal (the HashKey
  comparison, `ivfflat.rs:84-93`) or after ``max_iterations``,
- restarts (``num_attempts``, `ivfflat.rs:111-121`) run as a loop and the
  lowest-cost attempt wins (first on ties).

Precision. ``vers_tpu``'s ``partial_sums`` computes the assignment
distances at ``Precision.DEFAULT`` (bf16 on a TPU, f32 under XLA on the
CPU) and segment-sums bf16-rounded rows into f32 with a one-hot matmul.
Here the assignment distances are f32 (TF32 off), and the segment-sum is
an ``index_add_`` of the bf16-rounded rows into f32 sums, which equals
the one-hot matmul up to summation order.

Random draws. ``init_centroids`` draws rows with a ``torch.Generator``,
which cannot reproduce ``jax.random``; the build functions take an
optional explicit ``init`` so that a caller (the tests) can hand both
packages the same initial centroids.

The k-means matmuls are plain large matrix products and stay torch ops,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from vers_tpu_torch import trace
from vers_tpu_torch.core import bitwise_equal, host_wait
from vers_tpu_torch.ops.distance import pairwise_sq_euclidean


def init_centroids(generator: torch.Generator, data: torch.Tensor,
                   n_valid: int, k: int) -> torch.Tensor:
    """k centroids drawn as random data rows, with replacement (parity
    with `ivfflat.rs:18-27`, which draws gen_range per centroid and can
    repeat)."""
    idx = torch.randint(0, int(n_valid), (k,), generator=generator,
                        device=data.device)
    return data[idx]


def partial_sums(data: torch.Tensor, n_valid: int, centroids: torch.Tensor,
                 chunk_size: int = 65536):
    """One assignment + accumulation pass over the live rows.

    Returns (sums (k, d) f32, counts (k,) f32, cost f32 scalar tensor):
    per-cluster vector sums, member counts and the total squared
    euclidean cost. Rows >= n_valid contribute nothing."""
    k, d = centroids.shape
    dev = centroids.device
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    n_valid = min(int(n_valid), data.shape[0])
    for c0 in range(0, n_valid, chunk_size):
        chunk = data[c0 : min(c0 + chunk_size, n_valid)]
        dist = pairwise_sq_euclidean(chunk, centroids)
        best, assign = torch.min(dist, dim=1)
        sums.index_add_(0, assign, chunk.to(torch.bfloat16).float())
        host_wait(assign)  # bincount reads its maximum on the host
        counts += torch.bincount(assign, minlength=k).float()
        cost += best.sum()
    return sums, counts, cost


def centroids_from_sums(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Mean per cluster; empty cluster -> zero vector (parity with
    `ivfflat.rs:63-67`)."""
    means = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0.0, means, 0.0)


def lloyd_step(data, n_valid, centroids, chunk_size: int = 65536):
    """One Lloyd iteration: returns (new_centroids, cost_of_old)."""
    sums, counts, cost = partial_sums(data, n_valid, centroids, chunk_size)
    return centroids_from_sums(sums, counts), cost


def build_kmeans(
    generator: torch.Generator | None,
    data: torch.Tensor,
    n_valid: int,
    k: int,
    max_iterations: int,
    chunk_size: int = 65536,
    init: torch.Tensor | None = None,
):
    """Full Lloyd run (parity with `build_kmeans`, `ivfflat.rs:73-100`):
    random-row init (or ``init``, (k, d)), iterate until bitwise-stable
    centroids or max_iterations (each step the span ``kmeans.step``).
    Returns (centroids (k, d), cost)."""
    if init is not None:
        centroids = init.to(device=data.device, dtype=torch.float32)
    else:
        centroids = init_centroids(generator, data, n_valid, k)
    for _ in range(max_iterations):
        # the step ends in bitwise_equal's read to the host
        with trace.span("kmeans.step"):
            new_centroids, _ = lloyd_step(data, n_valid, centroids, chunk_size)
            converged = bitwise_equal(centroids, new_centroids)
        # Parity with `ivfflat.rs:91-95`: on convergence the reference
        # breaks before adopting new_centroids; they are bitwise
        # identical then, so adopting is equivalent.
        centroids = new_centroids
        if converged:
            break
    # cost of the final centroids, for restart selection
    _, _, cost = partial_sums(data, n_valid, centroids, chunk_size)
    return centroids, cost


def build_kmeans_restarts(
    generator: torch.Generator | None,
    data: torch.Tensor,
    n_valid: int,
    k: int,
    num_attempts: int,
    max_iterations: int,
    chunk_size: int = 65536,
    init: torch.Tensor | None = None,
):
    """Best-of-N restarts by cost (parity with `build_index`'s attempt
    loop, `ivfflat.rs:111-121`). ``init``: optional (num_attempts, k, d)
    initial centroids. Returns (best_centroids, best_cost)."""
    runs = [
        build_kmeans(generator, data, n_valid, k, max_iterations, chunk_size,
                     init=None if init is None else init[a])
        for a in range(num_attempts)
    ]
    costs = torch.stack([c for _, c in runs])
    best = int(torch.argmin(costs))
    return runs[best][0], runs[best][1]


def assign_clusters(data: torch.Tensor, n_valid: int, centroids: torch.Tensor,
                    chunk_size: int = 65536) -> torch.Tensor:
    """Final assignment pass (parity with `ivfflat.rs:98`): (n_pad,)
    int32 nearest-centroid ids for every row; callers mask rows >=
    n_valid."""
    parts = [
        torch.argmin(pairwise_sq_euclidean(data[c0 : c0 + chunk_size], centroids),
                     dim=1)
        for c0 in range(0, data.shape[0], chunk_size)
    ]
    if not parts:
        return torch.zeros((0,), dtype=torch.int32, device=data.device)
    return torch.cat(parts).to(torch.int32)
