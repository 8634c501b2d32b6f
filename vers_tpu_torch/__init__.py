"""vers_tpu_torch — the vers-tpu vector index engine on PyTorch and CUDA.

The port of ``vers_tpu`` (JAX, with Pallas kernels for the TPU) to
PyTorch, with hand-written CUDA kernels for the NVIDIA H100. It keeps
``vers_tpu``'s module layout, public names and bincode files; the JAX
package stays the reference it is tested against.

Ported so far: the exact flat index and IVFFlat (build, batched and
single-query search, incremental add, save/load). Kernels:
``ops/cuda_topk.py`` (distance + top-k scan) and ``ops/cuda_binned.py``
(packed binned scan), each with a plain torch version.

Dispatch follows the input tensor's device: a CUDA tensor runs the
kernel, a CPU tensor the plain version. Nothing here imports JAX.
"""

from vers_tpu_torch.config import FlatConfig, IVFFlatConfig
from vers_tpu_torch.index.flat import FlatIndex
from vers_tpu_torch.index.ivfflat import IVFFlatIndex
from vers_tpu_torch.utils.harness import recall_at_k, search_exhaustive

__all__ = [
    "FlatIndex",
    "IVFFlatIndex",
    "FlatConfig",
    "IVFFlatConfig",
    "recall_at_k",
    "search_exhaustive",
]
