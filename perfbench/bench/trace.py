"""The traced run's profile: one steady slice of the window.

``Tracer`` starts ``torch.profiler`` (CPU and CUDA activities) at the
first call issued after ``start_s`` seconds of the window, with the
calls in flight drained first, and stops it after ``calls`` calls, drained
again, so the slice holds whole calls and nothing else; the window runs
on until the slice is whole. ``warm`` starts and stops the profiler once
in set-up, so that the slice does not pay for the profiler's first
start. Inside the slice the benchmark's own host spans ("enqueue": the
call into the system, "drain": the wait for its results on the host) are
``record_function`` ranges, on the profiler's clock. The profile stays in
memory: no trace file is written.

``Trace`` is what the metric readers get, in seconds on one clock:
``device`` (name, start, end) of every kernel and copy, ``host`` (span
name, start, end), ``window`` (start, end) of the slice, from the first
call's issue to the last call's results on the host, and ``calls``, the
indexes of its calls.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Tuple

from perfbench.reference.intervals import busy_us, gaps, label_gaps

SPANS = ("enqueue", "drain")


@dataclass
class Trace:
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)
    calls: List[int] = field(default_factory=list)

    def busy_s(self, names=None) -> float:
        """Device busy seconds inside the window: the union of the
        records (of those whose name holds one of ``names``)."""
        lo, hi = self.window
        return busy_us((max(s, lo), min(e, hi)) for n, s, e in self.device
                       if e > lo and s < hi
                       and (names is None or any(k in n for k in names)))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time (summed by name), and
        the longest idle stretches with the host span that covers each."""
        by_name = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(((s, e) for _, s, e in self.device), *self.window),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in label_gaps(idle, self.host)]}


class Tracer:
    def __init__(self, start_s: float, calls: int):
        self.start_s, self.calls = start_s, calls
        self.first = None
        self.prof = None
        self.trace = None

    @property
    def open(self) -> bool:
        return self.first is not None

    @staticmethod
    def warm():
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def step(self, i: int, elapsed: float, drain) -> None:
        """Before call ``i`` is issued, ``elapsed`` seconds into the
        window: open or close the slice."""
        if self.first is None and self.trace is None and elapsed >= self.start_s:
            drain()
            self._open()
            self.first = i
        elif self.first is not None and i >= self.first + self.calls:
            drain()
            self._close(i)

    def close(self, i: int) -> None:
        """At the window's end, with nothing in flight."""
        if self.first is not None:
            self._close(i)

    def _open(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()

    def _close(self, i: int):
        import torch

        torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.stop()
        self.trace = reduce(prof.events(), list(range(self.first, i)))
        self.first = None


def reduce(events, calls: List[int]) -> Trace:
    """``torch.profiler`` events to a ``Trace`` (seconds). The spans'
    own device-side annotations are not device work."""
    from torch.autograd import DeviceType

    t = Trace(calls=calls)
    for e in events:
        s, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name in SPANS or getattr(e, "is_user_annotation", False):
            if e.device_type != DeviceType.CUDA:
                t.host.append((e.name, s, end))
        elif e.device_type == DeviceType.CUDA:
            if not e.name.startswith("Activity Buffer"):
                t.device.append((e.name, s, end))
    if t.host:
        t.window = (min(s for _, s, _ in t.host), max(e for _, _, e in t.host))
    return t
