"""The program's own trace inside a ``Trace`` (``bench/trace.py``).

With ``vers_tpu_torch.trace`` switched on, the program leaves two things
in the profile of the traced slice:

- device records of its stage markers, one-thread kernels named
  ``vers::trace::mark<i>``, ``i`` the stage's index in a stage table:
  in ``STAGES`` for the binned search, launched before each of its
  stages and once after the last (``end``), and captured into the CUDA
  graphs it replays;
- host spans named ``vers/<span>`` (``record_function`` ranges).

A stage's device time in one call is the union of the device records
(markers left out) that lie between the stage's marker and the next
marker. Without markers or ``vers/`` spans (a program that has no trace,
or one with tracing off) every function here finds nothing.

Another path's markers take indexes of their own, after those of
``STAGES``; its readers pass their own table to ``stage_ms``, whose
positions are the markers' indexes, e.g. ``STAGES + ("route", "beam",
"rescore", "beam.end")``.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from perfbench.bench.trace import Trace
from perfbench.reference.intervals import busy_us, gaps

# the program's stages, in the order of its marker kernels' indexes
STAGES = ("probe", "sort", "scan", "merge", "end")
MARK = re.compile(r"vers::trace::mark<(\d+)>")
PREFIX = "vers/"


def markers(t: Trace) -> List[Tuple[int, float, float]]:
    """(stage index, start, end) of each marker record, by start."""
    out = []
    for name, s, e in t.device:
        m = MARK.search(name)
        if m:
            out.append((int(m.group(1)), s, e))
    return sorted(out, key=lambda r: r[1])


def stage_ms(t: Optional[Trace], stage: str,
             stages: Sequence[str] = STAGES) -> Optional[float]:
    """Device ms a call of ``stage``: for each of its markers inside the
    slice, the union of the other records between that marker's end and
    the next marker's start, summed, over the slice's calls. ``stage``'s
    marker index is its position in ``stages``."""
    if t is None or not t.calls or not t.device:
        return None
    want = stages.index(stage)
    marks = markers(t)
    lo, hi = t.window
    spans = [(marks[j][2], marks[j + 1][1]) for j in range(len(marks) - 1)
             if marks[j][0] == want and lo <= marks[j][1] < hi]
    if not spans:
        return None
    work = [(s, e) for n, s, e in t.device if not MARK.search(n)]
    total = sum(busy_us((max(s, a), min(e, b)) for s, e in work if s < b and e > a)
                for a, b in spans)
    return total / len(t.calls) * 1e3


def spans(t: Optional[Trace], name: str = None) -> List[Tuple[str, float, float]]:
    """The program's host spans in the slice (``name`` without the
    ``vers/`` prefix: only those)."""
    if t is None:
        return []
    return [(n, s, e) for n, s, e in t.host if n.startswith(PREFIX)
            and (name is None or n == PREFIX + name)]


def program_idle_ms(t: Optional[Trace]) -> Optional[float]:
    """Device idle ms a call in the slice whose middle lies under one of
    the program's host spans."""
    mine = spans(t)
    if not mine or not t.calls:
        return None
    idle = gaps(((s, e) for _, s, e in t.device), *t.window)
    held = sum(e - s for s, e in idle
               if any(hs <= (s + e) / 2 < he for _, hs, he in mine))
    return held / len(t.calls) * 1e3
