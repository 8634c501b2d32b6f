"""Device mesh helpers — the multi-device layer's "distributed backend"
(counterpart of ``vers_tpu.parallel.mesh``).

The JAX package drives every chip of a 1-D ``jax.sharding.Mesh`` from one
process through ``shard_map``. This port keeps that design: a ``Mesh`` is
a tuple of ``torch.device``, one per shard, driven by one Python process.
Each shard's work is enqueued on its own device in shard order, and the
two collectives the layer needs are plain tensor ops on the lead device
(shard 0's):

- ``all_gather(parts, dim)``: concatenate in shard order (the top-k
  candidate merges, ``merge_topk``),
- ``psum(parts)``: sum in shard order (the k-means reductions).

No other module moves data between shards. Several shards may share one
device: ``make_mesh(4, device="cuda:0")`` puts four shards on one card,
as the JAX package's tests put eight on the virtual CPU devices of
``--xla_force_host_platform_device_count=8``. There is no
``torch.distributed`` process group here: a step to many cards would
replace the two collectives, and the per-shard loops that enqueue each
shard's work in turn (ROADMAP 1.10b).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vers_tpu_torch.ops.topk import topk_smallest

SHARD_AXIS = "shards"


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device with its index."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D mesh: one ``torch.device`` per shard (repeats allowed).
    ``shape[axis]`` is the shard count, as on a ``jax.sharding.Mesh``."""

    def __init__(self, devices: Sequence, axis: str = SHARD_AXIS):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            normalize_device(d) for d in devices)
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """Shard 0's device, where collectives leave their results."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis: str = SHARD_AXIS) -> Mesh:
    """A 1-D mesh. Without ``device``: one shard per visible CUDA card,
    the first ``n_devices`` of them; raises without a card (nothing
    falls back to the CPU unasked). With ``device``: ``n_devices``
    shards (1 when None) all on that device."""
    if device is not None:
        return Mesh([device] * (1 if n_devices is None else int(n_devices)),
                    axis)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device=\"cpu\" to make a "
            "mesh of CPU shards")
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def shard_rows(
    x,
    mesh: Mesh,
    axis: str = SHARD_AXIS,
    capacity_per_shard: Optional[int] = None,
) -> Tuple[List[torch.Tensor], np.ndarray]:
    """Split axis 0 into balanced contiguous blocks, one per shard, each
    padded to the same row count and placed on its shard's device.
    Returns (per-shard tensors (per, ...), valid counts (S,) int32).

    Global padded row ``s * per + r`` is shard s's row r, as in the JAX
    package's row-sharded array. ``capacity_per_shard`` reserves headroom
    rows per shard (zero padding past each shard's count) so callers can
    append in place without re-sharding."""
    n_shards = mesh.shape[axis]
    x = np.asarray(x)
    n = x.shape[0]
    base = -(-max(n, 1) // n_shards)  # balanced rows per shard
    per = base
    if capacity_per_shard is not None:
        per = max(per, capacity_per_shard)
    # per-shard rows rounded up to 8, as the JAX package rounds them to
    # the f32 sublane
    per = ((per + 7) // 8) * 8
    counts = np.asarray(
        [max(0, min(base, n - s * base)) for s in range(n_shards)],
        dtype=np.int32,
    )
    parts = []
    for s, dev in enumerate(mesh.devices):
        c = int(counts[s])
        part = torch.zeros((per,) + x.shape[1:],
                           dtype=torch.from_numpy(x[:0]).dtype, device=dev)
        if c:
            part[:c] = torch.from_numpy(
                np.ascontiguousarray(x[s * base : s * base + c])).to(dev)
        parts.append(part)
    return parts, counts


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate per-shard tensors along ``dim`` in shard order, on
    the first part's device."""
    lead = parts[0].device
    return torch.cat([p.to(lead) for p in parts], dim=dim)


def merge_topk(parts_d: Sequence[torch.Tensor],
               parts_i: Sequence[torch.Tensor], k: int):
    """The k smallest of the shards' (Q, k_s) candidates, on the lead
    device: gather the distances and rows in shard order, one stable
    top-k (equal distances keep the lower shard), -1 where the distance
    is inf."""
    dg = all_gather(parts_d, 1)   # (Q, S*k)
    ig = all_gather(parts_i, 1)
    dd, sel = topk_smallest(dg, k)
    ii = torch.gather(ig, 1, sel)
    return dd, torch.where(torch.isfinite(dd), ii, -1)


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum per-shard tensors in shard order, on the first part's
    device."""
    lead = parts[0].device
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p.to(lead)
    return out
