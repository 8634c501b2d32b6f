from vers_tpu_torch.ops.distance import (
    pairwise_cosine_distance,
    pairwise_distance,
    pairwise_sq_euclidean,
)
from vers_tpu_torch.ops.topk import fused_scan_topk, topk_smallest

__all__ = [
    "pairwise_cosine_distance",
    "pairwise_distance",
    "pairwise_sq_euclidean",
    "fused_scan_topk",
    "topk_smallest",
]
