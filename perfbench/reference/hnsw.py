"""Plain HNSW search over a served graph, and the comparison that decides
``correct`` for an HNSW cell.

The plain reference is the published search (`vers/src/indexes/hnsw.rs`,
`search_approximate` at :510-548 and `HNSWLayer::search` at :242-307):
start at the entry point of the top layer, which is never searched
itself; on each layer from L-2 down to 0 run the layer search with beam
``ef`` from the entry the layer above returned (its nearest), and return
the k nearest of layer 0's beam. The layer search is the reference's: a
FIFO queue of nodes and a visited set; a popped node's neighbours that
were not visited are marked and evaluated in list order, and each enters
the ef-bounded heap, and the queue, if the heap holds fewer than ``ef``
or it is nearer than the heap's farthest. Every node that ever entered
the heap is expanded, so the search ends when the queue is empty.

Here it runs in plain torch on whole batches of queries at once, in
lockstep (one pop a query a step), in f64: distances are ``1 - q.x``
(cosine on normalised rows) of f64 rows. A neighbour enters the heap
exactly when fewer than ``ef`` of the heap's entries and of the
neighbours evaluated before it in the same list lie at or under its
distance, which is the sequential rule: a neighbour that did not enter
never lowers the heap's farthest. Repeats inside one list are evaluated
once. ``precision="bf16"`` runs the same search on the rows rounded to
bf16: the control, which serves those distances.

``judge`` reads the program's served answers and the graph it serves
from (each layer's padded adjacency in global row ids, -1 pad, and its
members), only to judge them:

- ``dist_err``: the widest gap between a served distance and the exact
  f64 distance of the row served beside it;
- ``stray_ids``: served ids that are no live row, repeat in an answer,
  stand after a larger served distance, or are -1 where k rows exist;
- ``recall_gap``: the reference's recall@k over the program's graph at
  the same ``ef`` less the program's, on the same queries, both against
  the exact k nearest rows in f64;
- ``graph_stray``: edges to no live row of their layer, from a row not
  on the layer, self-loops, repeats within a list, degrees over the
  layer's cap, nodes above layer 0 missing from the layer below, and an
  entry point off the top layer;
- ``self_miss``: the share of the given rows that the reference, asked
  for each row's own vector over the program's graph at ``ef``, does not
  return first: the build judged by itself.

``recall_at_10`` is the program's recall@k. Imports torch only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

_INF = float("inf")
# device bytes of the plain search's visited sets: queries a step, each a
# byte a row
BITMAP_BYTES = 4 << 30


def _rows(n: int, chunk: int):
    return ((s, min(s + chunk, n)) for s in range(0, n, chunk))


def repeats_earlier(ids: torch.Tensor) -> torch.Tensor:
    """(B, m) bool: True where the same id stands at a lower column of
    its row."""
    s, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.zeros_like(rep).scatter_(1, order, rep)


class PlainHNSW:
    """The reference's search over a given graph. ``x`` (n_pad, d) f32
    rows (rows past the live ones are never reached from a sound graph);
    ``adjs`` each layer's (n_pad, deg) adjacency, layer 0 first, global
    row ids, -1 pad; ``entry`` the top layer's entry row."""

    def __init__(self, x: torch.Tensor, adjs: Sequence[torch.Tensor],
                 entry: int, precision: str = "f64"):
        if precision == "f64":
            self.table = x.double()
        elif precision == "bf16":
            self.table = x.to(torch.bfloat16).double()
        else:
            raise ValueError(precision)
        self.adjs = [a.to(x.device, torch.int64) for a in adjs]
        self.entry = int(entry)
        self.chunk = max(1, BITMAP_BYTES // (self.table.shape[0] + 1))

    def dist(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(B, m) f64 ``1 - q.x`` to the rows ``ids`` (B, m); +inf at -1."""
        rows = self.table[ids.clamp(0, self.table.shape[0] - 1)]
        d = 1.0 - torch.bmm(rows, q[:, :, None])[:, :, 0]
        return torch.where(ids >= 0, d, _INF)

    def layer_search(self, q: torch.Tensor, adj: torch.Tensor,
                     entry: torch.Tensor, ef: int):
        """`HNSWLayer::search` for each query (B, d) f64 from its entry
        (B,): (heap distances (B, ef) ascending, rows (B, ef); +inf / -1
        past the heap's size)."""
        b, dev = q.shape[0], q.device
        n_pad, deg = self.table.shape[0], adj.shape[1]
        at = torch.arange(b, device=dev)
        visited = torch.zeros((b, n_pad + 1), dtype=torch.bool, device=dev)
        heap_d = torch.full((b, ef), _INF, dtype=torch.float64, device=dev)
        heap_i = torch.full((b, ef), -1, dtype=torch.int64, device=dev)
        heap_d[:, 0] = self.dist(q, entry[:, None])[:, 0]
        heap_i[:, 0] = entry
        cap = 4 * ef
        queue = torch.full((b, cap + 1), -1, dtype=torch.int64, device=dev)
        queue[:, 0] = entry
        head = torch.zeros(b, dtype=torch.int64, device=dev)
        tail = torch.ones(b, dtype=torch.int64, device=dev)
        earlier = torch.ones((deg, deg), dtype=torch.bool, device=dev).tril(-1)
        while True:
            live = head < tail
            if not bool(live.any()):
                break
            node = torch.where(live, queue[at, head.clamp(max=cap - 1)], -1)
            head += live.long()
            visited[at, torch.where(live, node, n_pad)] = True
            nbrs = torch.where(live[:, None], adj[node.clamp(min=0)], -1)
            slot = torch.where(nbrs >= 0, nbrs, n_pad)
            fresh = ((nbrs >= 0) & ~visited.gather(1, slot)
                     & ~repeats_earlier(nbrs))
            visited.scatter_(1, torch.where(fresh, slot, n_pad), True)
            d = torch.where(fresh, self.dist(q, nbrs), _INF)
            under = torch.searchsorted(heap_d.contiguous(), d, right=True)
            before = ((d[:, None, :] <= d[:, :, None]) & earlier
                      & fresh[:, None, :]).sum(-1)
            enter = fresh & (under + before < ef)
            grown = int((tail + enter.sum(1)).max())
            if grown > cap:
                more = max(cap, grown - cap)
                queue = torch.cat([queue[:, :cap], torch.full(
                    (b, more + 1), -1, dtype=torch.int64, device=dev)], 1)
                cap += more
            pos = tail[:, None] + torch.cumsum(enter.long(), 1) - 1
            queue.scatter_(1, torch.where(enter, pos, cap), nbrs)
            tail += enter.sum(1)
            cat_d = torch.cat([heap_d, d.masked_fill(~enter, _INF)], 1)
            cat_i = torch.cat([heap_i, nbrs.masked_fill(~enter, -1)], 1)
            heap_d, sel = torch.sort(cat_d, dim=1, stable=True)
            heap_d, sel = heap_d[:, :ef], sel[:, :ef]
            heap_i = cat_i.gather(1, sel)
        return heap_d, heap_i

    def search(self, queries: torch.Tensor, k: int, ef: int):
        """(distances (Q, k) f64, rows (Q, k) int64) nearest first; the
        top layer never searched, no result with one layer (`hnsw.rs:526`)."""
        out_d, out_i = [], []
        for a, b in _rows(queries.shape[0], self.chunk):
            q = queries[a:b].to(self.table.device).double()
            if len(self.adjs) < 2:
                out_d.append(torch.full((b - a, k), _INF, dtype=torch.float64,
                                        device=q.device))
                out_i.append(torch.full((b - a, k), -1, dtype=torch.int64,
                                        device=q.device))
                continue
            entry = torch.full((b - a,), self.entry, dtype=torch.int64,
                               device=q.device)
            for layer in range(len(self.adjs) - 2, -1, -1):
                d, i = self.layer_search(q, self.adjs[layer], entry, max(ef, k))
                entry = i[:, 0]
            out_d.append(d[:, :k])
            out_i.append(i[:, :k])
        return torch.cat(out_d), torch.cat(out_i)


def exact_nearest(x64: torch.Tensor, queries: torch.Tensor, k: int,
                  budget_bytes: int = 1 << 30) -> torch.Tensor:
    """(Q, k) rows of the k nearest live rows ``x64`` (n, d) f64 by
    ``1 - q.x``, in f64."""
    step = max(1, budget_bytes // (8 * x64.shape[0]))
    out = []
    for a, b in _rows(queries.shape[0], step):
        dots = queries[a:b].to(x64.device).double() @ x64.T
        out.append(dots.topk(k, dim=1).indices)
    return torch.cat(out)


def recall(ids: torch.Tensor, truth: torch.Tensor) -> float:
    """The mean share of each row of ``truth`` found in the same row of
    ``ids``."""
    hits = (truth[:, :, None] == ids.to(truth.device)[:, None, :]).any(-1)
    return float(hits.double().mean())


def graph_stray(adjs: Sequence[torch.Tensor], members: Sequence[torch.Tensor],
                n: int, caps: Sequence[int], entry: int) -> int:
    """Faults of the served graph (see the module docstring). ``members``
    each layer's rows, ``caps`` each layer's largest degree."""
    count = 0
    below = None
    for layer, (adj, mem) in enumerate(zip(adjs, members)):
        a = adj.long()
        n_pad = a.shape[0]
        dev = a.device
        on = torch.zeros(n_pad + 1, dtype=torch.bool, device=dev)
        on[mem.to(dev).long()] = True
        edge = a >= 0
        live = edge & (a < n)
        count += int(((a < -1) | (a >= n)).sum())
        count += int((live & ~on[a.clamp(0, n_pad)]).sum())
        count += int((edge & ~on[:n_pad, None]).sum())
        count += int((a == torch.arange(n_pad, device=dev)[:, None]).sum())
        count += int((repeats_earlier(a) & edge).sum())
        count += int((edge.sum(1) - caps[layer]).clamp_min(0).sum())
        if below is not None:
            count += int((on & ~below).sum())
        below = on
    if below is not None and not bool(below[entry]):
        count += 1
    return count


def judge(x: torch.Tensor, n: int, queries: torch.Tensor,
          served_d: torch.Tensor, served_i: torch.Tensor, k: int, ef: int,
          adjs: Sequence[torch.Tensor], members: Sequence[torch.Tensor],
          caps: Sequence[int], entry: int, self_rows: torch.Tensor,
          log=None) -> Dict[str, float]:
    """The numbers that decide ``correct`` (see the module docstring) and
    ``recall_at_10``. ``x`` (n_pad, d) f32 rows, the first ``n`` live;
    ``served_*`` (Q, k) for ``queries`` (Q, d); ``self_rows`` the rows
    ``self_miss`` asks for."""
    dev = x.device
    x64 = x[:n].double()
    q64 = queries.to(dev).double()
    si = served_i.to(dev, torch.int64)
    sd = served_d.to(dev).double()
    valid = (si >= 0) & (si < n)
    exact = torch.where(valid, 1.0 - (x64[si.clamp(0, n - 1)]
                                      * q64[:, None, :]).sum(-1), 0.0)
    err = torch.where(valid, (sd - exact).abs(), 0.0)
    out = dict(dist_err=float(torch.nan_to_num(err, nan=_INF).max()))
    sorted_ids = torch.sort(torch.where(valid, si, -1 - torch.arange(
        k, device=dev)), 1).values
    stray = (~valid & (si != -1)).sum() + (sorted_ids[:, 1:]
                                           == sorted_ids[:, :-1]).sum()
    both = valid[:, 1:] & valid[:, :-1]
    stray += (both & ~(sd[:, 1:] >= sd[:, :-1])).sum()
    if n >= k:
        stray += (si == -1).sum()
    out["stray_ids"] = float(stray)
    if log is not None:
        log("check: the served distances and ids")

    truth = exact_nearest(x64, q64, k)
    del x64
    out["recall_at_10"] = recall(si, truth)
    plain = PlainHNSW(x, adjs, entry)
    _, ref_i = plain.search(q64, k, ef)
    out["recall_gap"] = recall(ref_i, truth) - out["recall_at_10"]
    if log is not None:
        log(f"check: the plain search over the program's graph "
            f"(recall {out['recall_at_10'] + out['recall_gap']:.5f})")
    out["graph_stray"] = float(graph_stray(adjs, members, n, caps, entry))
    rows = self_rows.to(dev, torch.int64)
    _, own = plain.search(x[rows].double(), 1, ef)
    out["self_miss"] = float((own[:, 0] != rows).double().mean())
    if log is not None:
        log("check: the graph and its own rows")
    return out


def served_caps(num_layers: int, m: int, max_degree: Optional[int]) -> List[int]:
    """Each layer's largest degree as served: the reference admits M + 1
    neighbours (2M + 1 on layer 0; `hnsw.rs:126`, :400-404), and the
    serving cache keeps at most ``max_degree`` of each list."""
    caps = [2 * m + 1] + [m + 1] * (num_layers - 1)
    return [min(c, max_degree) if max_degree else c for c in caps]
