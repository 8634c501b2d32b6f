"""CUDA graphs of the search paths: the port's counterpart of ``jax.jit``.

The JAX package runs each search as compiled dispatches that never wait
on the host: IVF's ``_pallas_fused_core`` is one jitted program
(``vers_tpu/ops/binned.py:895-903``), the forest's shared search is
jitted (``vers_tpu/ops/forest_shared.py:248``) and the HNSW beams loop in
``lax.while_loop`` (``vers_tpu/ops/beam.py:159``). Eager PyTorch enqueues
every small op from Python instead, and the host paces the card. Here a
search's device work is captured once into a ``torch.cuda.CUDAGraph``
and replayed:

- ``GraphCache``: an index's graphs. ``site(key, queries)`` names one
  search configuration by the caller's ``key`` (the path, ``top_k``,
  nprobe, probes or ef and the other static arguments), the device, the
  queries' shape and dtype, the TF32 settings (the exact paths read them
  only while they capture), whether ``trace`` is on (a graph captured
  with its stage markers replays them) and the cache's ``version``, which
  ``invalidate`` bumps: every ``add``, layout rebuild or cache rebuild
  of the index calls it, and a site asked for over other state than the
  last one (a rebuilt layout or serving cache) bumps it too.
- Which configurations get graphs. A graph pays off only where a
  configuration repeats: a serving loop's batch shapes, as
  ``docs/SERVING.md`` warms them. A configuration's first call runs
  eagerly and is remembered (the last ``SEEN_KEYS``); its second call
  captures. An index keeps at most ``MAX_SITES`` configurations; a new
  one takes the place of the least recently used only when that one has
  not run in the index's last ``IDLE_CALLS`` calls, and otherwise runs
  eagerly. So traffic whose shapes never repeat never captures, a mix of
  more configurations than ``MAX_SITES`` replays ``MAX_SITES`` of them
  and runs the others eagerly, and no traffic captures more than
  ``MAX_SITES`` times in ``IDLE_CALLS`` calls. Captures run one at a
  time in the process, each after ``torch.cuda.empty_cache()``.
- ``Site``: one search's graphs by name (HNSW's search is several: its
  prelude, its beam's step chunks and its tail). ``run`` replays one and
  returns clones of its outputs; ``graph`` hands one out for a loop of
  replays (``ops/beam.replay_beam``); ``held()`` keeps other threads'
  calls of the cache out while one thread loads, replays and takes.
- A graph's first use runs the function eagerly on a side stream: that
  warm-up makes the stream's cuBLAS handle and workspace, and its
  results are that call's answer. The same call then captures the
  function on that stream; every later call replays it. Inputs are
  copied into the graph's static buffers; outputs are cloned on the
  caller's stream, so chained calls never alias one another's results.
- Memory: a graph keeps the peak working set of its capture. An index's
  graphs share one pool (``GraphCache.pool_bytes``), so it holds about
  its largest search's working set, not their sum: a replay's
  temporaries may lie where another graph's did, which is safe because
  every replay's outputs are taken (cloned, or read by the host) before
  any graph of the cache replays again, and each load waits for the
  cache's last take (an event), on whichever stream it was made. The
  pool lives until the index's next ``invalidate`` or the index itself
  goes, and nothing else in the process can use it meanwhile.
- Launch counts: the warm-up's launches count as any eager launch; a
  capture records the launches the kernels' wrappers count
  (``core.CAPTURE``) without counting them, since nothing ran, and every
  replay counts them. So each call counts its kernels once.
- ``disabled()``: the block runs eagerly, as under ``jax.disable_jit``.
  Code that records a search's arguments runs under it
  (``ops/binned.captured_scans``): a replay makes no Python calls, and a
  capture's tensors live in its pool and change at every replay. So do
  the eager twins of the tests and of ``chip_smoke.py``.

A capture that fails raises; nothing falls back to eager. A CPU tensor
never captures: ``site`` gives None and the caller runs eagerly, as the
port dispatches every op by device. A site holds the state its graphs
read (``state``: the dict of an index's corpus, layout or tables):
kernels A and B take TMA descriptors encoded on the host at each launch,
which the graph freezes, so those tensors must stay alive and unmoved
while it lives.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch

from vers_tpu_torch import trace
from vers_tpu_torch.core import CAPTURE, count, host_released

# Which configurations get graphs (see the module docstring): an index's
# sites at most, the calls a site must stay unused before a new one may
# take its place, and the configurations remembered as called once.
# Traces of 48 calls at 1M x 300 on an H100 (tools/profile_torch_search.py
# --traffic): with 8 batch shapes, 8 sites replayed 67% of the calls
# against 48% for 4, and their shared pool grew under 1% (IVF 0.98 GB,
# forest 1.36, HNSW 2.82); a capturing call took 1.3-2.6 replays' time
# more than a replay (an index's first, which makes the side stream's
# cuBLAS handle, up to 9), so 8 captures in 256 calls cost under a
# tenth of them.
MAX_SITES = 8
IDLE_CALLS = 256
SEEN_KEYS = 64

# graphs' captures, one at a time in the process, each after the
# allocator's free blocks were given back (``Graph``)
_CAPTURES = threading.Lock()

# The graph class and its pool handles (the CPU tests inject stand-ins).
CUDAGraph = torch.cuda.CUDAGraph
pool_handle = torch.cuda.graph_pool_handle

_DISABLED = [0]  # depth of ``disabled()`` blocks, process-wide
_DISABLED_LOCK = threading.Lock()
_STREAMS = threading.local()  # per thread: device -> its capture stream


@contextlib.contextmanager
def disabled():
    """Run every search inside the block eagerly, on every thread (the
    shards' bodies run on worker threads)."""
    with _DISABLED_LOCK:
        _DISABLED[0] += 1
    try:
        yield
    finally:
        with _DISABLED_LOCK:
            _DISABLED[0] -= 1


def enabled() -> bool:
    return not _DISABLED[0]


def capturable(t: torch.Tensor) -> bool:
    """Whether a search on ``t`` replays graphs: a CUDA tensor outside
    ``disabled()``."""
    return t.is_cuda and enabled()


def tf32_flags() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _signature(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


@contextlib.contextmanager
def _capture_stream(device: torch.device):
    """Run the block on this thread's capture stream of ``device``, after
    the work on the caller's current stream, which then waits for the
    block's; gives the caller's stream. A CPU device (the tests'
    stand-in graphs) has no stream: None."""
    if device.type != "cuda":
        yield None
        return
    streams = getattr(_STREAMS, "by_device", None)
    if streams is None:
        streams = _STREAMS.by_device = {}
    side = streams.get(device)
    if side is None:
        side = streams[device] = torch.cuda.Stream(device)
    caller = torch.cuda.current_stream(device)
    side.wait_stream(caller)
    try:
        with torch.cuda.stream(side):
            yield caller
    finally:
        caller.wait_stream(side)


def _handed_over(tensors, inputs, stream) -> tuple:
    """``tensors``, made on the capture stream, fit for a caller on
    ``stream``: a copy of one that shares memory with a static input
    (which the next call overwrites); the others marked as used on
    ``stream``, so that the allocator does not hand their memory to the
    capture stream again before the caller's work on them is done."""
    held = {s.untyped_storage().data_ptr() for s in inputs}
    out = []
    for t in tensors:
        if t.untyped_storage().data_ptr() in held:
            t = t.clone()
        elif stream is not None:
            t.record_stream(stream)
        out.append(t)
    return tuple(out)


class Graph:
    """``fn`` captured into ``owner``'s pool: ``inputs`` are its static
    input buffers, ``outputs`` its results in the pool, ``launches`` the
    kernel launches (counters, key, n) a replay counts, ``first`` the
    warm-up's results."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 owner: "GraphCache"):
        self.device = inputs[0].device
        self.owner = owner
        self.inputs = tuple(t.clone() for t in inputs)
        self.graph = CUDAGraph()
        tally = {}
        with _capture_stream(self.device) as caller:
            # the warm-up: builds, handles, lazy state
            warm = tuple(fn(*self.inputs))
            outer = getattr(CAPTURE, "tally", None)
            _CAPTURES.acquire()
            CAPTURE.tally = tally
            try:
                if self.device.type == "cuda":
                    # as ``torch.cuda.graph`` does: a capture cannot give
                    # the allocator's free blocks back if its pool runs
                    # short, so they go back before it
                    torch.cuda.empty_cache()
                self.graph.capture_begin(pool=owner.pool(self.device),
                                         capture_error_mode="thread_local")
                try:
                    out = fn(*self.inputs)
                except BaseException:
                    # the capture is void; the function's error is the
                    # one to raise
                    with contextlib.suppress(RuntimeError):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
            finally:
                CAPTURE.tally = outer
                _CAPTURES.release()
        self.outputs = tuple(out)
        self.launches = [tuple(v) for v in tally.values()]
        # after the capture: its stream's work is ordered before the
        # caller's, and a copy made here runs on the caller's stream
        self.first = _handed_over(warm, self.inputs, caller)

    def load(self, inputs: Sequence[torch.Tensor]) -> None:
        """Copy ``inputs`` into the static inputs on the current stream,
        once the results of the owner's last replay have been taken."""
        done = self.owner.done
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        for static, t in zip(self.inputs, inputs):
            if static is not t:
                static.copy_(t)

    def replay(self) -> None:
        """One replay on the current stream; counts its launches."""
        self.graph.replay()
        for counters, key, n in self.launches:
            count(counters, key, n)

    def take(self, tensors: Sequence[torch.Tensor]) -> tuple:
        """Clones of ``tensors`` (this graph's buffers) on the current
        stream; the owner's next ``load`` waits for them."""
        out = tuple(t.clone() for t in tensors)
        if self.device.type == "cuda":
            self.owner.done = torch.cuda.current_stream(
                self.device).record_event()
        return out


class Site:
    """One search configuration's graphs, by name and input signature,
    in ``owner``'s pool; ``state`` is what they read; ``last``: the
    owner's call count at this site's last call."""

    def __init__(self, key: tuple, state, owner: "GraphCache"):
        self.key = key
        self.state = state
        self.owner = owner
        self.graphs = {}
        self.last = 0

    def held(self):
        """The owner's lock for a load, replay and take (a block of
        them): its graphs share static buffers and a pool, so one thread
        at a time. Inside a shard's body, waiting for it lets go of the
        mesh's host lock (``core.host_released``)."""
        return self.owner.held()

    def graph(self, name, fn: Callable, inputs: Sequence[torch.Tensor]) -> Graph:
        """The graph ``name`` of ``fn`` on inputs like ``inputs``,
        captured on first use (its warm-up's results dropped)."""
        g, _ = self._graph(name, fn, inputs)
        g.first = None
        return g

    def _graph(self, name, fn, inputs):
        sub = (name, _signature(inputs))
        with self.held():
            g = self.graphs.get(sub)
            if g is not None:
                return g, False
            with trace.span("graph.capture"):
                g = self.graphs[sub] = Graph(fn, inputs, self.owner)
            return g, True

    def run(self, name, fn: Callable, inputs: Sequence[torch.Tensor]) -> tuple:
        """``fn(*inputs)``: on the graph's first use the warm-up's
        results (the span ``graph.capture``), then by a replay of the
        graph ``name``, clones of its outputs (``graph.replay``, around
        ``graph.load`` and ``graph.take``)."""
        with self.held():
            g, new = self._graph(name, fn, inputs)
            if new:
                first, g.first = g.first, None
                return first
            with trace.span("graph.replay"):
                with trace.span("graph.load"):
                    g.load(inputs)
                g.replay()
                with trace.span("graph.take"):
                    return g.take(g.outputs)


class GraphCache:
    """An index's graphs: at most ``MAX_SITES`` search configurations
    (see the module docstring), in one pool a device; ``invalidate``
    drops them all. ``done``: the event after the last replay's results
    were taken."""

    def __init__(self):
        self.version = 0
        self.done = None
        self._sites = OrderedDict()
        self._seen = OrderedDict()  # configurations called once
        self._calls = 0
        self._state = None
        self._pools = {}
        self._lock = threading.Lock()  # the bookkeeping
        self._running = threading.RLock()  # loads, replays, takes

    @contextlib.contextmanager
    def held(self):
        """Hold the lock of this cache's loads, replays and takes (see
        ``Site.held``)."""
        if not self._running.acquire(blocking=False):
            with host_released():
                self._running.acquire()
        try:
            yield
        finally:
            self._running.release()

    def pool(self, device: torch.device):
        """The pool this cache's graphs on ``device`` capture into."""
        with self._lock:
            handle = self._pools.get(device)
            if handle is None:
                handle = self._pools[device] = pool_handle()
            return handle

    def pool_bytes(self) -> int:
        """Device bytes of this cache's pools (the allocator's segments)."""
        pools = {tuple(h) for h in self._pools.values()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools)

    def invalidate(self) -> None:
        """The index's state changed: drop every graph."""
        with self._lock:
            self._drop()

    def _drop(self) -> None:
        # a new pool: the old one's memory goes once its graphs are gone
        self.version += 1
        self._sites.clear()
        self._seen.clear()
        self._state = None
        self._pools = {}

    def sites(self) -> list:
        with self._lock:
            return list(self._sites.values())

    def site(self, key: tuple, queries: torch.Tensor,
             state) -> Optional[Site]:
        """The site of a search keyed ``key`` on ``queries`` whose graphs
        read ``state`` (an object holding the index's tensors, kept
        alive by the site); another object than the last call's drops
        every graph first. None where the search runs eagerly: off the
        card or under ``disabled()`` (``capturable``), on a
        configuration's first call, and where every site is in use (see
        the module docstring)."""
        if not capturable(queries):
            return None
        with self._lock:
            if state is not self._state:
                self._drop()
                self._state = state
            full = (tuple(key), queries.device, tuple(queries.shape),
                    queries.dtype, tf32_flags(), trace.enabled(), self.version)
            self._calls += 1
            s = self._sites.get(full)
            if s is None:
                if self._seen.pop(full, None) is None:
                    return self._remember(full)  # its first call
                if len(self._sites) >= MAX_SITES:
                    lru = next(iter(self._sites.values()))
                    if self._calls - lru.last <= IDLE_CALLS:
                        return self._remember(full)  # every site in use
                    self._sites.popitem(last=False)
                s = self._sites[full] = Site(full, state, self)
            self._sites.move_to_end(full)
            s.last = self._calls
        return s

    def _remember(self, full: tuple) -> None:
        """Note ``full`` as called; its call runs eagerly."""
        self._seen[full] = True
        while len(self._seen) > SEEN_KEYS:
            self._seen.popitem(last=False)
        return None


def run(site: Optional[Site], name, fn: Callable, *inputs: torch.Tensor) -> tuple:
    """``fn(*inputs)``: eagerly when ``site`` is None (the span
    ``graph.eager``), else replayed from the site's graph ``name``
    (``Site.run``)."""
    if site is None:
        with trace.span("graph.eager"):
            return tuple(fn(*inputs))
    return site.run(name, fn, inputs)
