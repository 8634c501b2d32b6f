"""Tie-aware comparison of two top-k results.

Two exact top-k searches over the same data may order equal distances
differently, and at the k-th place may even keep different ids of equal
distance. A comparison of id sets and of sorted distances side by side
would still pass if an id were paired with another id's distance. This
helper instead maps id -> distance per row, so every id keeps its own
distance, and allows ids to differ only where the distances tie within
the stated tolerance.
"""

from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def max_abs_diff(got_d, want_d) -> float:
    """Largest |got - want| over entries where either is finite (inf
    when only one of a pair is finite); 0.0 when none is."""
    g = _host(got_d).astype(np.float64)
    w = _host(want_d).astype(np.float64)
    both_inf = np.isinf(g) & np.isinf(w) & (np.sign(g) == np.sign(w))
    with np.errstate(invalid="ignore"):
        diff = np.where(both_inf, 0.0, np.abs(g - w))
    diff = np.where(np.isnan(diff), np.inf, diff)
    return float(diff.max()) if diff.size else 0.0


def assert_topk_match(got_d, got_i, want_d, want_i, rtol: float = 1e-4,
                      atol: float = 1e-5) -> None:
    """Raise AssertionError unless (got_d, got_i) equals (want_d, want_i)
    up to ties. Both are (Q, k) ascending results with id -1 / +inf for
    empty slots. Per row:

    - the sorted distances agree position by position within
      ``rtol``/``atol``;
    - the live ids (>= 0) are distinct and equal in number;
    - every id present in both keeps its own distance within tolerance;
    - an id present in only one of them has a distance within tolerance
      of the other's k-th (largest live) distance, i.e. it was swapped at
      a tie on the cut."""
    gd, gi = _host(got_d).astype(np.float64), _host(got_i).astype(np.int64)
    wd, wi = _host(want_d).astype(np.float64), _host(want_i).astype(np.int64)
    if gd.shape != wd.shape or gi.shape != wi.shape or gd.shape != gi.shape:
        raise AssertionError(
            f"shape mismatch: got {gd.shape}/{gi.shape}, want {wd.shape}/{wi.shape}"
        )

    def close(a, b):
        return bool(np.all(np.isclose(a, b, rtol=rtol, atol=atol)))

    for r in range(gd.shape[0]):
        def fail(msg):
            raise AssertionError(
                f"row {r}: {msg}\n got ids {gi[r].tolist()}\n got d {gd[r].tolist()}"
                f"\n want ids {wi[r].tolist()}\n want d {wd[r].tolist()}"
            )

        if not close(gd[r], wd[r]):
            fail("sorted distances differ beyond tolerance")
        g = {int(i): float(d) for i, d in zip(gi[r], gd[r]) if i >= 0}
        w = {int(i): float(d) for i, d in zip(wi[r], wd[r]) if i >= 0}
        if len(g) != int((gi[r] >= 0).sum()) or len(w) != int((wi[r] >= 0).sum()):
            fail("repeated ids in a row")
        if len(g) != len(w):
            fail(f"{len(g)} live ids vs {len(w)}")
        for i in g.keys() & w.keys():
            if not close(g[i], w[i]):
                fail(f"id {i} has distance {g[i]} vs {w[i]}")
        if g.keys() != w.keys():
            g_kth = max(g.values())
            w_kth = max(w.values())
            for i in g.keys() - w.keys():
                if not close(g[i], w_kth):
                    fail(f"id {i} ({g[i]}) not tied with the k-th {w_kth}")
            for i in w.keys() - g.keys():
                if not close(w[i], g_kth):
                    fail(f"id {i} ({w[i]}) not tied with the k-th {g_kth}")
