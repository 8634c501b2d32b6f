"""Core vector utilities on torch: the counterpart of ``vers_tpu.core``
(the reference's ``Vector<N>`` math core, `vers/src/indexes/base.rs`).

Hot paths work on whole ``(n, d)`` tensors. Every function takes the
device from its input tensor or from an explicit ``device`` argument;
nothing here reads a global default device. The indexes' entry points
resolve an unnamed device with ``resolve_device``: the card.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

# Corpus row counts are padded to a multiple of this, as in the JAX
# package, so layouts and capacities match it row for row.
LANE = 128

NORMALIZE_EPS = 1e-6  # parity with `base.rs:99-105`

# Per thread: the shard whose body the thread runs under
# ``parallel.mesh.map_shards`` (``shard``) and that mesh's host lock
# (``host``), which the body holds while it runs on the host.
SHARD_STATE = threading.local()


@contextlib.contextmanager
def host_released():
    """Inside a shard's body (``parallel.mesh.map_shards``): let go of the
    mesh's host lock for the block, a wait, so that the other shards'
    bodies run meanwhile. Elsewhere: nothing."""
    lock = getattr(SHARD_STATE, "host", None)
    if lock is None:
        yield
        return
    lock.release()
    try:
        yield
    finally:
        lock.acquire()


def host_wait(t: torch.Tensor) -> None:
    """Call before reading ``t``'s value on the host. Inside a shard's
    body on a card: wait for the work on ``t``'s current stream with the
    mesh's host lock released (``host_released``), so that the other
    shards enqueue theirs meanwhile. Elsewhere: nothing."""
    if getattr(SHARD_STATE, "host", None) is None or not t.is_cuda:
        return
    with host_released():
        torch.cuda.current_stream(t.device).synchronize()


# Kernel launch counters move under this lock (``count``): the shards of
# a mesh launch from several threads at once.
COUNT_LOCK = threading.Lock()

# Per thread: while ``graphs`` captures a CUDA graph, ``tally`` holds the
# launches the capture records, which have not run: (id(counters), key)
# -> [counters, key, n]. Each replay of the graph counts them.
CAPTURE = threading.local()


def count(counters: dict, key: str, n: int = 1) -> None:
    """Add ``n`` to ``counters[key]`` (0 when missing) under COUNT_LOCK:
    ``counters`` is a counting module's ``globals()`` or a dict of
    counts. Inside a graph capture on this thread the launch is only
    recorded, into ``CAPTURE.tally``: its replays count it."""
    tally = getattr(CAPTURE, "tally", None)
    with COUNT_LOCK:
        if tally is None:
            counters[key] = counters.get(key, 0) + n
        else:
            tally.setdefault((id(counters), key), [counters, key, 0])[2] += n


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """The device an index lives on: ``device`` as given ("cpu"
    included), else the first CUDA card. Without a card an unnamed
    device raises; nothing falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available: pass device="cpu" to run on the CPU')
    return torch.device("cuda", 0)


def as_query_matrix(queries, device=None) -> torch.Tensor:
    """(Q, d) float32 tensor. A tensor stays on its own device unless
    ``device`` names another; anything else is converted on ``device``
    (the CPU when None)."""
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=device if device is not None else queries.device,
                       dtype=torch.float32)
    else:
        q = torch.as_tensor(
            np.asarray(queries, dtype=np.float32),
            device=device if device is not None else "cpu",
        )
    if q.ndim == 1:
        q = q[None, :]
    return q.contiguous()


def normalize(x: torch.Tensor, eps: float = NORMALIZE_EPS) -> torch.Tensor:
    """L2-normalize rows; rows with magnitude < eps pass through
    unchanged (parity with `base.rs:99-105`)."""
    mag = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    small = mag < eps
    return torch.where(small, x, x / torch.where(small, torch.ones_like(mag), mag))


def normalize_np(x: np.ndarray, eps: float = NORMALIZE_EPS) -> np.ndarray:
    """Host-side normalize with the same epsilon guard."""
    x = np.asarray(x, dtype=np.float32)
    mag = np.sqrt(np.sum(x * x, axis=-1, keepdims=True))
    safe = np.where(mag < eps, 1.0, mag)
    return np.where(mag < eps, x, x / safe).astype(np.float32)


def to_hashkey(x: np.ndarray) -> np.ndarray:
    """Bitwise f32→u32 view used for exact-duplicate detection and
    k-means convergence (parity with ``to_hashkey``, `base.rs:113-117`)."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def deduplicate(vectors: np.ndarray, ids: np.ndarray):
    """Drop bitwise-duplicate rows, keeping first occurrence (parity
    with `lsh.rs:113-130`). Returns (unique_vectors, their_ids)."""
    keys = to_hashkey(vectors)
    _, first = np.unique(keys, axis=0, return_index=True)
    keep = np.sort(first)
    return vectors[keep], np.asarray(ids)[keep]


def device_id_map(ids, device) -> torch.Tensor | None:
    """int32 copy on ``device`` of an internal-row -> external-id map,
    or ``None`` when any id falls outside int32 range.

    The bincode formats store external ids as u64, so ids >= 2**31 are
    valid inputs; casting them to int32 would wrap and return wrong ids.
    Callers map such ids on the host in int64 (or raise on the
    device-resident path) when this returns None."""
    ids = np.asarray(ids)
    if ids.size and (
        int(ids.min()) < -(2**31) or int(ids.max()) > 2**31 - 1
    ):
        return None
    return torch.as_tensor(ids.astype(np.int32), device=device)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact bitwise equality of two f32 tensors (the reference's
    k-means convergence test, `ivfflat.rs:84-93`)."""
    return bool(torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


STORE_DTYPES = (torch.float32, torch.bfloat16)


class VectorStore:
    """A growable ``(capacity, d)`` corpus with a live-row count — the
    counterpart of the reference's push-based ``Vec<Vector<N>>``
    (`ivfflat.rs:200-213`).

    Capacity is a multiple of ``LANE`` rows and doubles when full; rows
    past ``count`` are zero and consumers mask them out. ``device``: as
    ``resolve_device`` reads it, except that a tensor's own device is
    kept when none is named. ``dtype``: ``torch.float32`` or
    ``torch.bfloat16``; a bf16 store rounds each row once on the way in
    (to nearest, ties to even, as ``jnp.asarray(..., bfloat16)``), at
    construction and in ``append``, and keeps the rows at pitch ``d``.
    """

    def __init__(self, data, capacity: int | None = None,
                 dtype=torch.float32, device=None):
        if dtype not in STORE_DTYPES:
            raise ValueError(f"a store holds float32 or bfloat16, got {dtype}")
        if isinstance(data, torch.Tensor):
            device = device if device is not None else data.device
            data = data.detach().to("cpu", torch.float32).numpy()
        device = resolve_device(device)
        data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2:
            raise ValueError(f"expected (n, d) array, got shape {data.shape}")
        n, d = data.shape
        cap = round_up(max(capacity or n, 1), LANE)
        buf = torch.zeros((cap, d), dtype=dtype, device=device)
        buf[:n] = torch.as_tensor(data, dtype=dtype).to(buf.device)
        self._buf = buf
        self._count = n

    @property
    def count(self) -> int:
        return self._count

    @property
    def dim(self) -> int:
        return self._buf.shape[1]

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    @property
    def device(self) -> torch.device:
        return self._buf.device

    @property
    def data(self) -> torch.Tensor:
        """Full padded buffer (capacity, d). Rows >= count are zeros."""
        return self._buf

    def valid(self) -> torch.Tensor:
        """(capacity,) bool mask of live rows."""
        return torch.arange(self.capacity, device=self._buf.device) < self._count

    def rows(self) -> np.ndarray:
        """Host copy of the live rows (count, d) in float32."""
        return self._buf[: self._count].to("cpu", torch.float32).numpy()

    def append(self, row) -> int:
        """Append one row; returns its position."""
        row = torch.as_tensor(
            np.asarray(row, dtype=np.float32).reshape(-1), dtype=self._buf.dtype
        )
        if self._count >= self.capacity:
            grown = torch.zeros(
                (round_up(self.capacity * 2, LANE), self.dim),
                dtype=self._buf.dtype, device=self._buf.device,
            )
            grown[: self.capacity] = self._buf
            self._buf = grown
        self._buf[self._count] = row.to(self._buf.device)
        pos = self._count
        self._count += 1
        return pos
