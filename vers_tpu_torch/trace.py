"""The port's trace: host spans, device stage markers and one snapshot.

Off by default, and off it costs a flag check at each site and records
nothing. ``enable()`` / ``disable()`` / ``enabled()`` are its one switch.

- ``span(name)``: a block of host time. Off, it is one shared null
  context. On, it records the span's name, its parent (the span open
  around it on the same thread), its call (the outermost span open on
  the thread, so the spans of one search share it), the thread, and
  its start and end from ``time.perf_counter_ns()``. While a profiler
  records (``torch.profiler``), it is also a ``record_function`` range
  named ``"vers/" + name``, so the profile has the program's spans on
  the clock of its device records.
- ``mark(stage, device)``: on, and on a card, one marker kernel on the
  current stream, ``vers::trace::mark<i>`` with ``i`` the stage's index
  in ``STAGES`` (``csrc/trace_mark.cu``): 0-4 the binned search's,
  5-8 the HNSW search's, 9-12 the forest search's. A marker launched
  while a CUDA
  graph captures is a node of the graph, so replays, which run no
  Python and so record no span, still divide their device work into
  stages: a profiler's device records between a marker and the next
  are the marker's stage. ``stage(name, device)`` is a marker and a
  span of the same name.
- ``count(key, n)``: on, adds ``n`` to the trace's counter ``key``
  (``COUNTERS``, through ``core.count``): the HNSW beam's steps, its
  stop-flag reads and the beam loops that stopped before their step cap;
  the forest build's leaves and levels.
- ``snapshot()``: per span name its count, total and longest time
  (never evicted), the last ``RING`` spans, the trace's counters, and
  the kernels' launch counters (which ``core.count`` moves with tracing
  on or off). ``reset()`` clears the spans and the trace's counters.

A CUDA graph captured with tracing on holds markers and one captured
with it off holds none, so tracing is part of a graph's key
(``graphs.GraphCache.site``).

Spans: ``ivf.search``, ``ivf.upload``, ``ivf.plan``, ``ivf.layout``,
``ivf.download``, ``ivf.build`` (``index/ivfflat.py``, ``ops/binned.py``),
``layout.padded`` (``ops/cuda_binned.py``), ``kmeans.step``
(``ops/kmeans.py``), ``graph.replay``, ``graph.capture``,
``graph.eager``, ``graph.load``, ``graph.take`` (``graphs.py``) and the
binned search's stages ``probe``, ``sort``, ``scan``, ``merge``
(``ops/binned.py``, each also a marker; ``end`` closes the last);
``hnsw.search``, ``hnsw.cache``, ``hnsw.build`` (``index/hnsw.py``),
``hnsw.wave`` (``ops/hnsw_build.py``), ``hnsw.flag`` (``ops/beam.py``)
and the HNSW search's stages ``route``, ``beam``, ``rescore``
(``ops/beam.py``, ``ops/beam_inline.py``, each also a marker;
``beam.end`` closes the last); ``lsh.search``, ``lsh.layout``,
``lsh.build`` with ``lsh.dedup``, ``lsh.trees`` and ``lsh.tables``
(``index/lsh.py``) and the forest search's stages ``descend``,
``gather``, ``fold`` (``ops/forest_shared.py``, each also a marker;
``forest.end`` closes the last). ``TRACING.md`` beside this file says
what each covers.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch

from vers_tpu_torch.core import COUNT_LOCK
from vers_tpu_torch.core import count as _add

# spans kept in the ring of recent ones
RING = 65_536
# the device stages of the binned search, in order, a marker of "end"
# closing the last; then the HNSW search's, "beam.end" closing its last;
# then the forest search's, "forest.end" closing its last
STAGES = ("probe", "sort", "scan", "merge", "end",
          "route", "beam", "rescore", "beam.end",
          "descend", "gather", "fold", "forest.end")
# the trace's counters: the HNSW beam loops' steps run, their host reads
# of the stop flag, and the loops that stopped before their step cap;
# the leaves the forest builds made and the levels holding their nodes
COUNTERS = {"beam_steps": 0, "beam_flag_reads": 0, "beam_stopped_early": 0,
            "forest_leaves": 0, "forest_levels": 0}

_on = False
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()  # the aggregates and the ring
_TOTALS: dict = {}  # name -> [count, total ns, longest ns]
_RECENT: deque = deque(maxlen=RING)
_OPEN = threading.local()  # per thread: the stack of open spans
_IDS = itertools.count(1)


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]  # the id of the span open around it, or None
    call: int  # the id of the outermost span open on its thread
    thread: int
    start_ns: int
    end_ns: int


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Open:
    __slots__ = ("name", "id", "parent", "call", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer else None
        self.call = outer.call if outer else self.id
        # a range only where a profiler records: one costs ~10 us
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function("vers/" + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        span = Span(self.id, self.name, self.parent, self.call,
                    threading.get_ident(), self.start, end)
        took = end - self.start
        with _LOCK:
            total = _TOTALS.get(self.name)
            if total is None:
                total = _TOTALS[self.name] = [0, 0, 0]
            total[0] += 1
            total[1] += took
            total[2] = max(total[2], took)
            _RECENT.append(span)
        return False


def span(name: str):
    """A context manager around a block of host time named ``name``."""
    if not _on:
        return _NULL
    return _Open(name)


def mark(stage: str, device: torch.device) -> None:
    """With tracing on and ``device`` a card: the marker of ``stage`` (one
    of ``STAGES``) on the current stream. Otherwise nothing."""
    if not _on or device.type != "cuda":
        return
    from vers_tpu_torch.ops import _build

    lib = _build.load_library()
    rc = lib.vers_trace_mark(STAGES.index(stage),
                             torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, "vers_trace_mark")


def stage(name: str, device: torch.device):
    """``mark(name, device)``, then ``span(name)`` around the block."""
    if not _on:
        return _NULL
    mark(name, device)
    return _Open(name)


def count(key: str, n: int = 1) -> None:
    """With tracing on: ``n`` more on the counter ``key`` of
    ``COUNTERS``. Otherwise nothing."""
    if _on:
        _add(COUNTERS, key, n)


def snapshot() -> dict:
    """``enabled``; ``spans``: name -> {count, total_ns, max_ns};
    ``recent``: the last ``RING`` spans (``Span``), oldest first;
    ``counters``: the trace's counters (``COUNTERS``); ``launches``: the
    kernels' launch counters."""
    from vers_tpu_torch.ops import (beam_inline, cuda_binned, cuda_bucket,
                                    cuda_topk)

    with _LOCK:
        spans = {n: dict(count=c, total_ns=t, max_ns=m)
                 for n, (c, t, m) in _TOTALS.items()}
        recent = list(_RECENT)
    with COUNT_LOCK:
        counters = dict(COUNTERS)
        launches = dict(packed_scan=cuda_binned.LAUNCHES,
                        packed_scan_split=cuda_binned.LAUNCHES_SPLIT,
                        rank_merge=cuda_binned.LAUNCHES_MERGE,
                        distance_topk=dict(cuda_topk.LAUNCHES_BY_ROUTE),
                        topk_values=cuda_topk.LAUNCHES_VALUES,
                        bucket_scan=cuda_bucket.LAUNCHES,
                        beam_step=beam_inline.LAUNCHES,
                        beam_step_plain=beam_inline.LAUNCHES_PLAIN)
    return dict(enabled=_on, spans=spans, recent=recent, counters=counters,
                launches=launches)


def reset() -> None:
    """Clear the span aggregates, the ring and the trace's counters (not
    the launch counters)."""
    with _LOCK:
        _TOTALS.clear()
        _RECENT.clear()
    with COUNT_LOCK:
        for key in COUNTERS:
            COUNTERS[key] = 0
