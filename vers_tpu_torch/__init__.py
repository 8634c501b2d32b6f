"""vers_tpu_torch — the vers-tpu vector index engine on PyTorch and CUDA.

The port of ``vers_tpu`` (JAX, with Pallas kernels for the TPU) to
PyTorch, with hand-written CUDA kernels for the NVIDIA H100. It keeps
``vers_tpu``'s module layout, public names and bincode files; the JAX
package stays the reference it is tested against.

Ported: the flat index (exact, approx and bucket engines, over an f32
or a bf16 store), IVFFlat, the RP-forest ``ANNIndex`` ("LSH") and HNSW
(the host sequential build, the wave-parallel device build, the
scan-routed search with the classic and the inline beam, the
beam-routed search), each with build, batched and single-query search,
incremental add and save/load; the README's API (``compat``: ``HNSW``,
``LSH``, ``IVFFlat``, ``Embeddings``, ``load_wiki``), the demo
(``python -m vers_tpu_torch``) and the native `.vec` and HNSW-file
readers (``native``). Four CUDA kernels, one for each Pallas kernel of
``vers_tpu``, each with a plain torch version: ``ops/cuda_topk.py`` (A,
the distance + top-k scan over an f32 or bf16 corpus at each precision
setting, also HNSW's layer-1 routing scan, and C, the values top-k),
``ops/cuda_binned.py`` (B, the packed binned scan behind IVFFlat and
the forest) and ``ops/cuda_bucket.py`` (D, the bucket-min scan). The
multi-device layer (``parallel/``: the sharded Flat, IVFFlat, forest and
HNSW indexes and the partitioned forest and HNSW) drives a mesh of
devices from one process; its classes load lazily, as in ``vers_tpu``.
Not ported yet: HNSW's int8 navigation table
(``HNSWConfig(nav_dtype="int8")``) and the scan-routed wave build
(``build_graph(route_scan=True)``).

Dispatch follows the input tensor's device: a CUDA tensor runs the
kernel, a CPU tensor the plain version. Nothing here imports JAX.
"""

from vers_tpu_torch.version import __version__
from vers_tpu_torch.config import FlatConfig, HNSWConfig, IVFFlatConfig, LSHConfig
from vers_tpu_torch.index.base import Index
from vers_tpu_torch.index.flat import FlatIndex
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.index.ivfflat import IVFFlatIndex
from vers_tpu_torch.index.lsh import ANNIndex
from vers_tpu_torch.utils.data import load_vec_file, load_wiki_vector
from vers_tpu_torch.utils.harness import recall_at_k, search_exhaustive

# The reference README's intended Python API (README.md:83-97)
from vers_tpu_torch.compat import HNSW, IVFFlat, LSH, Embeddings, load_wiki

__all__ = [
    "__version__",
    "Index",
    "FlatIndex",
    "IVFFlatIndex",
    "ANNIndex",
    "HNSWIndex",
    "HNSW",
    "LSH",
    "IVFFlat",
    "FlatConfig",
    "IVFFlatConfig",
    "LSHConfig",
    "HNSWConfig",
    "Embeddings",
    "load_wiki",
    "load_wiki_vector",
    "load_vec_file",
    "search_exhaustive",
    "recall_at_k",
]

_PARALLEL = {
    "ShardedFlatIndex": "sharded_index",
    "ShardedIVFFlatIndex": "ivf",
    "ShardedHNSWIndex": "hnsw",
    "PartitionedHNSWIndex": "hnsw_partitioned",
    "ShardedANNIndex": "lsh",
    "PartitionedANNIndex": "lsh_partitioned",
}


def __getattr__(name):
    # the multi-device classes load on first use, as in vers_tpu
    if name in _PARALLEL:
        import importlib

        module = importlib.import_module(
            f"vers_tpu_torch.parallel.{_PARALLEL[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
