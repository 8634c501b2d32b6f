from vers_tpu_torch.index.base import Index
from vers_tpu_torch.index.flat import FlatIndex
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.index.ivfflat import IVFFlatIndex

__all__ = ["Index", "FlatIndex", "HNSWIndex", "IVFFlatIndex"]
