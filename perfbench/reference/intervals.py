"""Interval arithmetic of the device trace, frozen here.

``busy_us`` is a copy of ``tools/profile_torch_search.py:92-104``: the
length of the union of (start, end) intervals, so overlapping or nested
device records count once. ``gaps`` and ``label_gaps`` add what the
breakdown needs: the idle stretches between the union's pieces inside a
window, and for each the host span that covers its middle.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def busy_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint pieces."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(spans: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_gaps(idle: Sequence[Tuple[float, float]],
               host: Sequence[Tuple[str, float, float]],
               default: str = "other") -> List[Tuple[str, float]]:
    """(label, length) of each idle stretch: the name of the host span
    that covers its middle (the innermost, if nested), else ``default``."""
    out = []
    for s, e in idle:
        mid = (s + e) / 2
        name, width = default, None
        for n, hs, he in host:
            if hs <= mid < he and (width is None or he - hs < width):
                name, width = n, he - hs
        out.append((name, e - s))
    return out
