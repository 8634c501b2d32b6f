"""The one traffic generator: a closed loop over a pool of batches.

A traffic mix (the parameters in ``workloads/<cell>.json``) gives:

- ``batch``: queries a call; ``pool_batches``: distinct batches made in
  set-up and cycled in order, so every run of a seed sends the same work;
- ``queries``: ``"device"`` (tensors already on the card, results
  brought to the host by the caller, the upload-once model of
  ``docs/SERVING.md``) or ``"host"`` (numpy arrays in, numpy arrays out);
- ``depth``: calls in flight: one caller issues until ``depth`` are
  out, then waits for the oldest call's results on the host;
- ``top_k``: each call's k;
- ``warmup_calls``: calls made in set-up, before the window;
- ``trace_calls``: the calls the traced run profiles, from the first
  call after ``trace_start`` (a share of the window) on.

These keys (``COMMON``) are every cell's. A driver reads its index's own
keys beside them (``TRAFFIC`` in ``drivers/<index>.py``: IVF's
``nprobe``, each call's lists to probe).

A call's latency runs from its issue until its results are on the host.
The window runs ``seconds`` from the first issue; calls issued in it are
drained after it closes and count in the latency; the rate counts the
queries whose results reached the host inside it.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

COMMON = ("queries", "batch", "pool_batches", "depth", "top_k", "warmup_calls",
          "trace_start", "trace_calls")


@dataclass
class Window:
    start: float
    end: float
    # one (call index, issued, done) a call, host clock, in issue order
    calls: List[tuple] = field(default_factory=list)
    kept: Dict[int, object] = field(default_factory=dict)


def closed_loop(issue: Callable, collect: Callable, depth: int, seconds: float,
                keep: Callable[[int], bool], tracer=None, min_calls: int = 0,
                max_calls: Optional[int] = None,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run the window. ``issue(i)`` starts call ``i`` and returns a handle;
    ``collect(handle)`` waits for its results on the host and returns
    them; ``keep(i)`` says whether call ``i``'s results are kept for the
    check. Calls go on past the window's end until ``min_calls`` were
    issued and the tracer's slice is whole (those count in no metric),
    and stop at ``max_calls``.
    ``tracer`` (``bench/trace.py``) profiles a slice of calls, the
    pipeline drained on both sides of it."""
    inflight = deque()
    start = clock()
    win = Window(start, start + seconds)
    span = tracer.span if tracer is not None else (lambda name: contextlib.nullcontext())

    def retire():
        i, issued, handle = inflight.popleft()
        with span("drain"):
            answer = collect(handle)
        win.calls.append((i, issued, clock()))
        if keep(i):  # copied: a caller may reuse its buffers
            win.kept[i] = tuple(np.array(a) for a in answer)

    def drain():
        while inflight:
            retire()

    i = 0
    while True:
        if len(inflight) >= depth:
            retire()
        now = clock()
        tracing = tracer is not None and tracer.open
        if (now >= win.end and i >= min_calls and not tracing) or i == max_calls:
            break
        if tracer is not None:
            tracer.step(i, now - start, drain)
        issued = clock()
        with span("enqueue"):
            handle = issue(i)
        inflight.append((i, issued, handle))
        i += 1
    drain()
    if tracer is not None:
        tracer.close(i)
    return win


def latencies(win: Window) -> List[float]:
    """Seconds from issue to results on the host, every call issued in
    the window."""
    return [done - issued for _, issued, done in win.calls if issued < win.end]


def served_in_window(win: Window, batch: int) -> int:
    """Queries whose results reached the host inside the window."""
    return batch * sum(1 for _, _, done in win.calls if done <= win.end)


def percentile(values: List[float], share: float) -> Optional[float]:
    """The ``share`` quantile, linear between the nearest ranks."""
    if not values:
        return None
    v = sorted(values)
    pos = share * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
