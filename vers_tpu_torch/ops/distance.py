"""Batched distances as plain torch ops (counterpart of
``vers_tpu.ops.distance``).

Metric semantics match the reference exactly:

- ``sq_euclidean``: sum((a-b)^2)  (`base.rs:119-126`), computed as
  ``max(|q|^2 + |x|^2 - 2 q.x, 0)``;
- ``cosine``: **cosine distance** ``1 - a.b`` assuming normalized inputs
  (`base.rs:153-156`). Range [0, 2], smaller is closer.

Everything is float32. The JAX package pins ``Precision.HIGHEST`` on
these matmuls; the counterpart here is a float32 matmul with TF32 off,
which is PyTorch's default on CUDA. A CUDA call made while TF32 matmuls
are allowed raises rather than return distances good to ~3 digits.
"""

from __future__ import annotations

import torch


def _check_f32_matmul(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "exact distances need float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def pairwise_dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) float32 dot products."""
    _check_f32_matmul(q)
    return q.float() @ x.float().T


def pairwise_sq_euclidean(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) squared euclidean distances via the
    |q|^2 + |x|^2 - 2 q.x expansion, clamped at 0 against cancellation."""
    qf, xf = q.float(), x.float()
    qq = torch.sum(qf * qf, dim=-1, keepdim=True)
    xx = torch.sum(xf * xf, dim=-1)
    d2 = qq + xx[None, :] - 2.0 * pairwise_dot(qf, xf)
    return torch.clamp_min(d2, 0.0)


def pairwise_cosine_distance(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) cosine distances ``1 - q.x`` for
    normalized inputs (parity with `base.rs:153-156`)."""
    return 1.0 - pairwise_dot(q, x)


_METRICS = {
    "sq_euclidean": pairwise_sq_euclidean,
    "cosine": pairwise_cosine_distance,
}


def pairwise_distance(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    try:
        fn = _METRICS[metric]
    except KeyError:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {sorted(_METRICS)}"
        ) from None
    return fn(q, x)
