from vers_tpu_torch.models.candidates import (
    DistanceCandidatePair,
    AdjacencyItem,
    SearchResult,
)

__all__ = ["DistanceCandidatePair", "AdjacencyItem", "SearchResult"]
