"""The multi-device layer (counterpart of ``vers_tpu.parallel``): one
Python process drives a 1-D mesh of devices, one sub-index or corpus
block per shard (``mesh.py``)."""

from vers_tpu_torch.parallel.mesh import make_mesh, shard_rows
from vers_tpu_torch.parallel.search import sharded_topk
from vers_tpu_torch.parallel.kmeans import sharded_lloyd_step, sharded_build_kmeans
from vers_tpu_torch.parallel.sharded_index import ShardedFlatIndex
from vers_tpu_torch.parallel.ivf import ShardedIVFFlatIndex
from vers_tpu_torch.parallel.hnsw import ShardedHNSWIndex
from vers_tpu_torch.parallel.hnsw_partitioned import PartitionedHNSWIndex
from vers_tpu_torch.parallel.lsh import ShardedANNIndex
from vers_tpu_torch.parallel.lsh_partitioned import PartitionedANNIndex

__all__ = [
    "make_mesh",
    "shard_rows",
    "sharded_topk",
    "sharded_lloyd_step",
    "sharded_build_kmeans",
    "ShardedFlatIndex",
    "ShardedIVFFlatIndex",
    "ShardedHNSWIndex",
    "PartitionedHNSWIndex",
    "ShardedANNIndex",
    "PartitionedANNIndex",
]
