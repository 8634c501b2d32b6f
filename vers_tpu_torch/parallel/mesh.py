"""Device mesh helpers — the multi-device layer's "distributed backend"
(counterpart of ``vers_tpu.parallel.mesh``).

The JAX package drives every chip of a 1-D ``jax.sharding.Mesh`` from one
process through ``shard_map``. This port keeps that design: a ``Mesh`` is
a tuple of ``torch.device``, one per shard, driven by one Python process.
``map_shards`` is the counterpart of ``shard_map``: it runs one body a
shard, all at once, shard 0's on the caller's thread and each other one
on a host thread of its own (one worker a shard, made on first use)
and, on a card, each on a CUDA stream of its own (``Mesh.stream``).
Shards that share a card overlap there as far as the card allows;
shards on different cards overlap fully.

The host is shared by a lock (``Mesh.host``): a body holds it while it
enqueues, and lets go of it only while it waits for its own stream
before a host read (``core.host_wait``: the beam's stop flag between
its graphs' replays, the k-means counts). So the shards' waits
overlap each other's enqueues, and their eager ops are not interleaved
one by one: threads that take turns at the interpreter at every op
(each torch op lets go of the GIL) enqueue several times slower than
one thread does (``tools/time_executor.py`` times both). A CPU body
reads no stream and runs whole. A search body replays its shard's CUDA
graphs (``graphs``) on the shard's stream; a configuration's second
call captures them there, under the host lock, in the "thread_local"
capture mode, so the other shards' waits on their own streams do not
void the capture.

The two collectives the layer needs are plain tensor ops on the lead
device (shard 0's), run by the caller after every body has joined:

- ``all_gather(parts, dim)``: concatenate in shard order (the top-k
  candidate merges, ``merge_topk``),
- ``psum(parts)``: sum in shard order (the k-means reductions).

No other module moves data between shards. Several shards may share one
device: ``make_mesh(4, device="cuda:0")`` puts four shards on one card,
as the JAX package's tests put eight on the virtual CPU devices of
``--xla_force_host_platform_device_count=8``. There is no
``torch.distributed`` process group here: the shards of every card are
driven by the one process.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from concurrent.futures import Future, wait
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vers_tpu_torch.core import SHARD_STATE
from vers_tpu_torch.ops.topk import topk_smallest

SHARD_AXIS = "shards"


def current_shard() -> Optional[int]:
    """The shard whose body the calling thread runs under ``map_shards``;
    None outside a body."""
    return getattr(SHARD_STATE, "shard", None)


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device with its index."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _serve(jobs: queue.SimpleQueue) -> None:
    """A shard's worker: run (future, fn, args) jobs until None."""
    while True:
        job = jobs.get()
        if job is None:
            return
        future, fn, args = job
        del job
        if future.set_running_or_notify_cancel():
            try:
                future.set_result(fn(*args))
            except BaseException as e:  # re-raised by the caller
                future.set_exception(e)
        del future, fn, args


def _stop(queues) -> None:
    for jobs in queues:
        jobs.put(None)


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
        self.host = threading.Lock()  # held by the body on the host
        self._lock = threading.Lock()
        self._workers: Optional[List[queue.SimpleQueue]] = None
        self._streams: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """Shard 0's device, where collectives leave their results."""
        return self.devices[0]

    def stream(self, s: int, device=None) -> Optional[torch.cuda.Stream]:
        """Shard s's CUDA stream on ``device`` (its own device when None),
        made on first use; None on a CPU device. A shard on another card
        than the lead reads the lead's tensors through its stream on the
        lead."""
        dev = self.devices[s] if device is None else normalize_device(device)
        if dev.type != "cuda":
            return None
        with self._lock:
            st = self._streams.get((s, dev))
            if st is None:
                st = self._streams[(s, dev)] = torch.cuda.Stream(device=dev)
        return st

    def submit(self, s: int, fn: Callable, *args) -> Future:
        """Run ``fn(*args)`` on the worker thread of shard s >= 1 (the
        workers are made on first use and stop when the mesh is
        collected). Shard 0 has none: ``map_shards`` runs its body on the
        caller's thread."""
        if not 0 < s < self.size:
            raise ValueError(f"shard {s} has no worker thread")
        with self._lock:
            if self._workers is None:
                self._workers = [queue.SimpleQueue() for _ in self.devices[1:]]
                for i, jobs in enumerate(self._workers, 1):
                    threading.Thread(target=_serve, args=(jobs,), daemon=True,
                                     name=f"mesh-shard-{i}").start()
                weakref.finalize(self, _stop, self._workers)
        future = Future()
        self._workers[s - 1].put((future, fn, args))
        return future

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"


def _cuda_devices(mesh: Mesh) -> List[torch.device]:
    return [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]


def _tensors(out):
    """The tensors in a body's result (a tensor, or tuples and lists)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def _shard_body(mesh: Mesh, s: int, body: Callable, args, entry: dict):
    """Shard s's body, on a thread that holds the mesh's host lock: on a
    card under its device and its stream, which first waits for the
    caller's work (``entry``: an event on the caller's current stream of
    each card). Returns (the body's result, events recorded on the
    shard's streams after it)."""
    dev = mesh.devices[s]
    SHARD_STATE.shard, SHARD_STATE.host = s, mesh.host
    try:
        if dev.type != "cuda":
            return body(s, dev, *args), ()
        streams = [mesh.stream(s)]
        lead = mesh.lead
        if lead.type == "cuda" and lead != dev:
            # cross-card copies run on the source card's current stream
            streams.append(mesh.stream(s, lead))
        with contextlib.ExitStack() as stack:
            # setting a stream also sets its device: the shard's own last
            for st in reversed(streams):
                st.wait_event(entry[st.device])
                stack.enter_context(torch.cuda.stream(st))
            out = body(s, dev, *args)
        return out, tuple(st.record_event() for st in streams)
    finally:
        SHARD_STATE.shard = SHARD_STATE.host = None


def _on_worker(mesh: Mesh, s: int, body: Callable, args, entry: dict):
    """Shard s's body on its worker thread, once the host lock is free."""
    with mesh.host:
        return _shard_body(mesh, s, body, args, entry)


def map_shards(mesh: Mesh, body: Callable, *per_shard_args) -> list:
    """``body(s, device, *(a[s] for a in per_shard_args))`` for every
    shard at once: shard 0's on the caller's thread, which holds the host
    lock first, so that the workers wake while it enqueues; every other
    shard's on its worker thread. The results in shard order, whatever
    order the bodies finish in.

    On a card each body runs under its device and its own stream
    (``Mesh.stream``), which first waits for what the caller enqueued on
    its current streams; the caller's current streams then wait for
    every body's work, and every CUDA tensor a body returns is marked
    used on them (``record_stream``), so collectives on the lead read
    finished parts and the allocator does not reuse them early. A body
    that raises makes the call raise after every body has joined (the
    lowest shard's exception when several raise)."""
    if current_shard() is not None:
        raise RuntimeError("map_shards cannot run inside a shard's body")
    n = mesh.size
    for a in per_shard_args:
        if len(a) != n:
            raise ValueError(f"{len(a)} per-shard arguments for a {n}-shard mesh")
    cards = _cuda_devices(mesh)
    entry = {d: torch.cuda.current_stream(d).record_event() for d in cards}
    first = Future()
    with mesh.host:
        futures = [first] + [
            mesh.submit(s, _on_worker, mesh, s, body,
                        tuple(a[s] for a in per_shard_args), entry)
            for s in range(1, n)
        ]
        try:
            first.set_result(_shard_body(
                mesh, 0, body, tuple(a[0] for a in per_shard_args), entry))
        except BaseException as e:  # re-raised once every body has joined
            first.set_exception(e)
    wait(futures)
    failed = [f.exception() for f in futures if f.exception() is not None]
    if failed:
        # what the bodies enqueued may still read the caller's tensors
        for s, dev in enumerate(mesh.devices):
            for d in dict.fromkeys((dev, mesh.lead)):
                stream = mesh.stream(s, d)
                if stream is not None:
                    stream.synchronize()
        raise failed[0]
    results = [f.result() for f in futures]
    for d in cards:
        caller = torch.cuda.current_stream(d)
        for _, done in results:
            for ev in done:
                caller.wait_event(ev)
    for out, _ in results:
        for t in _tensors(out):
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
    return [out for out, _ in results]


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
