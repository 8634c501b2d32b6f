"""Plain IVFFlat and the comparison that decides ``correct``.

The plain reference is the published method (`vers/src/indexes/ivfflat.rs`):
Lloyd k-means with restarts (random rows as the start, the mean of each
list as the update, the lowest cost kept), every row in the list of its
nearest centroid, and a search that scans the lists of the ``nprobe``
nearest centroids, or with ``nprobe=0`` the adaptive walk of
`ivfflat.rs:166-195` (nearest lists first, each giving min(size, k)
candidates, until k are found), and keeps the k nearest rows. It runs in
plain torch at one of three precisions: ``"f64"`` (the judge), ``"f32"``
(TF32 off) and ``"tf32"`` (each matmul operand rounded to TF32's 10
mantissa bits, products summed in f32: the control).

``judge`` reads the system's outputs (its centroids, its rows' lists and
the answers it served) only to judge them, in f64:

- ``assign_gap``: the widest share by which a row's distance to the
  centroid of its list exceeds its distance to the nearest centroid;
- ``dist_err``: the widest gap between a served distance and the exact
  distance of the row served beside it;
- ``rank_gap``: the widest gap between the exact distance of the i-th
  served row and the i-th nearest row of the probed lists (the lists the
  reference's own probe or walk picks over the served centroids);
- ``stray_ids``: served rows that are no row, repeat in one answer, or
  lie outside every probed list.

``cost_gap`` judges the build against the plain reference's own: the
share by which the k-means cost of the system's lists (the mean squared
distance of each row to its list's centroid, in f64) exceeds that of
``PlainIVF.build`` at f32 on the same corpus, from a start drawn from
the run's seed. A build whose Lloyd steps never ran keeps its random
starting rows and reads far above any two sound builds' gap.

Shares are of ``|q|^2 + mean |x|^2`` (of ``|x|^2 + |c|^2`` for a row),
the size of the terms whose difference a distance is. A query whose
probe order the f64 distances leave within ``TIE`` of a swap counts
either order. Imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

TIE = 1e-5  # probe-order margins (shares) that count as ties


@contextlib.contextmanager
def exact_matmul():
    """f32 matmuls without TF32 inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
        torch.set_float32_matmul_precision(flags[2])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def sq_dist(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """(m, n) squared euclidean distances by |q|^2 + |x|^2 - 2 q.x."""
    if precision == "f64":
        q, x = q.double(), x.double()
        return (q * q).sum(-1, keepdim=True) + (x * x).sum(-1) - 2.0 * (q @ x.T)
    q, x = q.float(), x.float()
    qq, xx = (q * q).sum(-1, keepdim=True), (x * x).sum(-1)
    if precision == "tf32":
        q, x = tf32_round(q), tf32_round(x)
    elif precision != "f32":
        raise ValueError(precision)
    with exact_matmul():
        return qq + xx - 2.0 * (q @ x.T)


def _rows(n: int, chunk: int):
    return ((s, min(s + chunk, n)) for s in range(0, n, chunk))


def assign(x: torch.Tensor, centroids: torch.Tensor, precision: str = "f32",
           chunk: int = 65536) -> torch.Tensor:
    """(n,) int64: each row's nearest centroid (the first on ties)."""
    return torch.cat([sq_dist(x[a:b], centroids, precision).argmin(1)
                      for a, b in _rows(x.shape[0], chunk)])


def kmeans(x: torch.Tensor, k: int, attempts: int, iterations: int,
           gen: torch.Generator, precision: str = "f32",
           chunk: int = 65536) -> torch.Tensor:
    """Lloyd's k-means, the best of ``attempts`` starts by cost."""
    n, d = x.shape
    best, best_cost = None, None
    for _ in range(attempts):
        c = x[torch.randint(0, n, (k,), generator=gen, device=x.device)]
        for step in range(iterations + 1):
            sums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
            counts = torch.zeros((k,), dtype=torch.float64, device=x.device)
            cost = torch.zeros((), dtype=torch.float64, device=x.device)
            for a, b in _rows(n, chunk):
                dist = sq_dist(x[a:b], c, precision)
                low, near = dist.min(1)
                sums.index_add_(0, near, x[a:b].double())
                counts.index_add_(0, near, torch.ones_like(low, dtype=torch.float64))
                cost += low.double().sum()
            if step == iterations:
                break
            new = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1)[:, None], 0.0).float()
            if torch.equal(new, c):
                break
            c = new
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def cost(x: torch.Tensor, centroids: torch.Tensor, rows_list: torch.Tensor,
         chunk: int = 65536) -> float:
    """The k-means cost of a build in f64: the mean squared distance of
    each row to the centroid of its list."""
    c64 = centroids.double()
    total = 0.0
    for a, b in _rows(x.shape[0], chunk):
        diff = x[a:b].double() - c64[rows_list[a:b]]
        total += float((diff * diff).sum())
    return total / x.shape[0]


def cost_gap(x: torch.Tensor, centroids: torch.Tensor, rows_list: torch.Tensor,
             nlist: int, attempts: int, iterations: int, seed: int) -> float:
    """The share by which the cost of the served build exceeds the cost
    of the plain reference's build at f32 (its start from ``seed``)."""
    ref = PlainIVF.build(x, nlist, attempts, iterations, seed % (1 << 63), "f32")
    plain = cost(x, ref.centroids, ref.lists)
    del ref
    return (cost(x, centroids.to(x.device), rows_list.to(x.device)) - plain) / plain


def walk_depth_bound(sizes: np.ndarray, k: int) -> int:
    """The most lists the adaptive walk can take: the smallest lists'
    contributions min(size, k), summed from the smallest, reach k."""
    cum = np.cumsum(np.sort(np.minimum(np.asarray(sizes, np.int64), k)))
    hit = np.nonzero(cum >= k)[0]
    return len(cum) if len(hit) == 0 else int(hit[0]) + 1


def walk(order: torch.Tensor, sizes: torch.Tensor, k: int,
         nprobe: int) -> torch.Tensor:
    """The probed lists of each query from its lists in probe order:
    the first ``nprobe``, or (``nprobe=0``) the adaptive walk's prefix.
    (Q, P) int64, -1 where a rank is not probed."""
    if nprobe > 0:
        return order[:, :nprobe]
    contrib = sizes[order].clamp_max(k)
    before = torch.cumsum(contrib, 1) - contrib
    return torch.where(before < k, order, -1)


class PlainIVF:
    """IVFFlat in plain torch: the reference, and at ``"tf32"`` the
    control that stands in the system's place."""

    def __init__(self, x: torch.Tensor, centroids: torch.Tensor,
                 rows_list: torch.Tensor, precision: str):
        self.x, self.centroids, self.lists = x, centroids, rows_list
        self.precision = precision
        self.sizes = torch.bincount(rows_list, minlength=centroids.shape[0])

    @classmethod
    def build(cls, x: torch.Tensor, nlist: int, attempts: int, iterations: int,
              seed: int, precision: str = "f32") -> "PlainIVF":
        gen = torch.Generator(device=x.device).manual_seed(seed)
        c = kmeans(x, nlist, attempts, iterations, gen, precision)
        return cls(x, c, assign(x, c, precision), precision)

    def search(self, q: torch.Tensor, k: int, nprobe: int, chunk: int = 256):
        """(distances (Q, k) f32, rows (Q, k) int64), nearest first; -1
        and inf where the probed lists hold fewer than k rows."""
        nlist = self.centroids.shape[0]
        by_list = _Lists(self.lists, nlist)
        depth = nprobe or walk_depth_bound(self.sizes.cpu().numpy(), k)
        cd = sq_dist(q, self.centroids, self.precision)
        order = cd.topk(min(depth, nlist), largest=False).indices
        probes = walk(order, self.sizes, k, nprobe)
        out_d, out_i = [], []
        for a, b in _rows(q.shape[0], chunk):
            dist = sq_dist(q[a:b], self.x, self.precision)
            rows, live = by_list.probed(probes[a:b])
            near = dist.gather(1, rows).masked_fill_(~live, float("inf"))
            best = near.topk(min(k, near.shape[1]), largest=False)
            d = torch.nn.functional.pad(best.values.float(),
                                        (0, k - best.values.shape[1]), value=float("inf"))
            i = torch.where(torch.isfinite(d), torch.nn.functional.pad(
                rows.gather(1, best.indices), (0, k - best.indices.shape[1])), -1)
            out_d.append(d)
            out_i.append(i)
        return torch.cat(out_d), torch.cat(out_i)


class _Lists:
    """The rows of each list, for gathering a query's probed rows."""

    def __init__(self, lists: torch.Tensor, nlist: int):
        self.lists = lists
        self.sizes = torch.bincount(lists, minlength=nlist)
        self.rows = torch.argsort(lists, stable=True)
        self.starts = torch.cumsum(self.sizes, 0) - self.sizes
        self.span = max(int(self.sizes.max()), 1)

    def probed(self, probes: torch.Tensor):
        """(rows (m, P * span), live (m, P * span)): the rows of each
        query's probed lists, padded."""
        m = probes.shape[0]
        p = probes.clamp_min(0)
        off = torch.arange(self.span, device=probes.device)
        live = (off < self.sizes[p][:, :, None]) & (probes >= 0)[:, :, None]
        pos = (self.starts[p][:, :, None] + off).clamp_max(self.rows.shape[0] - 1)
        return self.rows[pos].reshape(m, -1), live.reshape(m, -1)


def _alternatives(order: List[int], cd: np.ndarray, scale: float,
                  active: int, nprobe: int, sizes: np.ndarray) -> List[List[int]]:
    """The probe orders one swap of a near tie away from ``order`` that
    can change the probed rows: the last probed list with the next one
    (``nprobe`` >= 1), or any of the walk's ``active`` lists with the
    next one (``nprobe=0``: a swap can change how far the walk goes). A
    swap of two empty lists (the zero centroids of empty clusters, which
    tie exactly) changes nothing."""
    out = []
    for j in range(active - 1 if nprobe else 0, min(active, len(order) - 1)):
        if sizes[order[j]] == 0 and sizes[order[j + 1]] == 0:
            continue
        if (cd[order[j + 1]] - cd[order[j]]) / scale < TIE:
            alt = list(order)
            alt[j], alt[j + 1] = alt[j + 1], alt[j]
            out.append(alt)
    return out


def _gaps(dist, by_list, probes, exact, valid, served_list, k, scale):
    """Per query: the widest share by which the i-th served row lies
    beyond the i-th nearest probed row, and the served rows that lie
    outside the probed lists or are missing where a probed row exists."""
    rows, live = by_list.probed(probes)
    near = dist.gather(1, rows).masked_fill_(~live, float("inf"))
    ref = near.topk(min(k, near.shape[1]), largest=False).values
    if ref.shape[1] < k:
        ref = torch.nn.functional.pad(ref, (0, k - ref.shape[1]), value=float("inf"))
    gap = torch.where(valid, exact - ref, 0.0) / scale[:, None]
    inside = (served_list[:, :, None] == probes[:, None, :]).any(-1)
    stray = (valid & ~inside).sum(1) + (~valid & torch.isfinite(ref)).sum(1)
    return gap.max(1).values, stray


def judge(x: torch.Tensor, queries: torch.Tensor, centroids: torch.Tensor,
          rows_list: torch.Tensor, served_d: torch.Tensor,
          served_i: torch.Tensor, k: int, nprobe: int,
          truth: bool = True, budget_bytes: int = 1 << 30,
          log=None) -> Dict[str, float]:
    """The numbers that decide ``correct`` (see the module docstring),
    with ``recall_at_10`` (the served rows' mean overlap with the k
    nearest of all rows) when ``truth``. All inputs on one device;
    ``served_*`` (Q, k) for ``queries`` (Q, d)."""
    dev = x.device
    n, nlist = x.shape[0], centroids.shape[0]
    lists = rows_list.to(dev, torch.int64)
    cent = centroids.to(dev)
    by_list = _Lists(lists, nlist)
    sizes = by_list.sizes
    out = dict(assign_gap=0.0, dist_err=0.0, rank_gap=0.0, stray_ids=0.0)

    x64 = x.double()
    x_sq = (x64 * x64).sum(1)
    c64 = cent.double()
    c_sq = (c64 * c64).sum(1)
    step = max(1, budget_bytes // (8 * nlist))
    for a, b in _rows(n, step):
        dist = torch.addmm(c_sq[None, :], x64[a:b], c64.T, alpha=-2.0)
        dist += x_sq[a:b, None]
        low = dist.min(1).values
        own = dist.gather(1, lists[a:b, None])[:, 0]
        scale = x_sq[a:b] + c_sq[lists[a:b]]
        out["assign_gap"] = _widest(out["assign_gap"], (own - low) / scale)
    if log is not None:
        small = np.sort(sizes.cpu().numpy())[:4].tolist()
        log(f"check: the build's lists (smallest {small}, walk bound "
            f"{walk_depth_bound(sizes.cpu().numpy(), k)})")

    x_mean = float(x_sq.mean())
    sizes_host = sizes.cpu().numpy()
    ties = 0
    depth = min((nprobe or walk_depth_bound(sizes.cpu().numpy(), k)) + 1, nlist)
    hits = 0
    step = max(1, budget_bytes // (8 * n))
    for a, b in _rows(queries.shape[0], step):
        q64 = queries[a:b].to(dev).double()
        q_sq = (q64 * q64).sum(1)
        scale = q_sq + x_mean
        cd = torch.addmm(c_sq[None, :], q64, c64.T, alpha=-2.0) + q_sq[:, None]
        order = cd.topk(depth, largest=False).indices
        dist = torch.addmm(x_sq[None, :], q64, x64.T, alpha=-2.0)
        dist += q_sq[:, None]
        si = served_i[a:b].to(dev, torch.int64)
        valid = (si >= 0) & (si < n)
        served = si.clamp(0, n - 1)
        srt = torch.sort(torch.where(valid, si, -1 - torch.arange(
            k, device=dev)), 1).values
        repeats = (srt[:, 1:] == srt[:, :-1]).sum(1)
        exact = torch.where(valid, dist.gather(1, served), float("inf"))
        err = (served_d[a:b].to(dev).double() - exact).abs() / scale[:, None]
        out["dist_err"] = _widest(out["dist_err"], torch.where(valid, err, 0.0))
        if truth:
            best = dist.float().topk(k, largest=False).indices
            hits += int((best[:, :, None] == si[:, None, :]).any(1).sum())

        probes = walk(order, sizes, k, nprobe)
        served_list = torch.where(valid, lists[served], -2)
        gap, stray = _gaps(dist, by_list, probes, exact, valid, served_list, k, scale)
        # near ties of the probe order: the best of the orders they allow
        active = (probes >= 0).sum(1).tolist()
        cd_host, scale_host = cd.cpu().numpy(), scale.cpu().numpy()
        order_host = order.tolist()
        for t in range(b - a):
            for alt in _alternatives(order_host[t], cd_host[t], scale_host[t],
                                     active[t], nprobe, sizes_host):
                ties += 1
                p = walk(torch.tensor([alt], device=dev), sizes, k, nprobe)
                g, s_ = _gaps(dist[t:t + 1], by_list, p, exact[t:t + 1],
                              valid[t:t + 1], served_list[t:t + 1], k,
                              scale[t:t + 1])
                gap[t] = torch.minimum(gap[t], g[0])
                stray[t] = torch.minimum(stray[t], s_[0])
        out["rank_gap"] = _widest(out["rank_gap"], gap)
        out["stray_ids"] += float((stray + repeats).sum())
    if log is not None:
        log(f"check: the answers ({ties} near ties of the probe order)")
    if truth:
        out["recall_at_10"] = hits / (queries.shape[0] * k)
    return out


def _widest(prev: float, values: torch.Tensor) -> float:
    """max(prev, values), where a NaN reads as infinite."""
    if values.numel() == 0:
        return prev
    return max(prev, float(torch.nan_to_num(values, nan=float("inf")).max()))
