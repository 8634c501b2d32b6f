"""Plain random-hyperplane forest search over served trees, and the
comparison that decides ``correct`` for a forest cell.

The trees are state, as the graph is in the HNSW judge: each tree's
hyperplanes, node tables and leaf membership as the program serves them
(``ANNIndex.forest_view()``: a node is (level, position), the root at
(0, 0); an inner node's hyperplane sends a vector x to position
``2 s + 1`` of the next level when ``coeff . x + const >= 0``, else to
``2 s``; a leaf node names its leaf). Everything else is recomputed here
in plain torch, f64, in blocks on the device of the rows.

``Forest.probes`` follows the program's documented batched rule
(``vers_tpu_torch/ops/rpforest.descend_forest_flat`` and the deficit
gate of ``ops/forest_shared``): probe 0 of a tree is the leaf the
descent reaches; probe j flips the decision at the level of the j-th
smallest |margin| on that path (a stable order, levels the path never
reached last) and descends from there; a probe that reaches no leaf
repeats the one before it. With the deficit gate (the default probe
count) a rank stays live while the leaves of the ranks before it, each
counted as min(size, k), hold fewer than k rows. The answer is the exact
k nearest rows of the union of the live leaves, each row once.

``Forest.tree_result`` is the reference's own rule (`vers/src/indexes/
lsh.rs:163-216`, `tree_result`): per tree, depth first from the root,
the branch on the query's side before the other one, a leaf giving all
its rows while fewer than the k still missing, else its nearest rows up
to k, and the other branch taken only while rows are missing; the
trees' candidates pooled and the k nearest kept. It measures how far the
batched rule drifts from the reference's.

``judge`` reads the answers the program served and its trees, only to
judge them:

- ``dist_err``: the widest gap between a served distance and the exact
  distance of the row served beside it;
- ``rank_gap``: the widest excess of the i-th served row's exact
  distance over the i-th nearest row of the leaves the plain descent
  probes;
- ``stray_ids``: served rows outside the probed leaves, repeats within an
  answer, rows after a larger served distance, and -1 where probed rows
  exist;
- ``leaf_stray`` (the build): rows in no leaf of a tree or in a leaf
  whose member count disagrees, leaves named by no node or by several,
  and leaves off ``rpforest.build_tree``'s size rule (fewer than
  ``max_node_size`` rows, except the nodes frozen at the last level);
- ``side_miss``: the share of the given rows whose descent does not
  reach their own leaf in some tree (the build judged by itself);
- ``recall_gap``: the reference's rule's recall@k over the same trees,
  on a sample of the queries, less the program's on the same queries,
  both against the exact k nearest rows;

and ``recall_at_10``, the program's recall@k over every query. Shares
are of ``|q|^2 + mean |x|^2``, the size of the terms a squared distance
is the difference of. A margin within ``TIE`` of zero counts either
side, and two |margins| within ``TIE`` of each other either order: the
query's ``rank_gap`` and ``stray_ids`` are the least over its probes and
the probe lists such ties allow (``tie_combos``), and a row with a
margin that close on its path does not count in ``side_miss``. Imports torch and
helpers of the HNSW and IVF references.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Sequence

import torch

from perfbench.reference.hnsw import recall, repeats_earlier
from perfbench.reference.ivf import _rows as _blocks
from perfbench.reference.ivf import _widest

TIE = 1e-5  # margins within this of zero, or of each other, are ties
# the probe lists a query's near ties may combine into, tried at most
COMBOS = 64
_INF = float("inf")


def _tensor(a) -> torch.Tensor:
    """``a`` (a tensor, or an array the caller may hold read-only) as a
    tensor of its own."""
    return a if torch.is_tensor(a) else torch.tensor(a)


def auto_probes(leaf_sizes: Sequence[torch.Tensor], k: int, cap: int = 8) -> int:
    """The program's default probe count: the most leaves any query could
    need in one tree before they hold k rows, each counted as
    min(size, k) and taken smallest first, at most ``cap``."""
    depth = 1
    for sizes in leaf_sizes:
        caps = torch.sort(sizes.clamp_max(k)).values
        cum = torch.cumsum(caps, 0)
        hit = torch.nonzero(cum >= k)
        depth = max(depth, int(hit[0]) + 1 if len(hit) else max(len(caps), 1))
    return min(depth, cap)


class Forest:
    """The served trees on ``x``'s device, in the ids of ``x``'s rows.

    ``trees``: one object a tree with ``coeff`` (L, T, d), ``const``
    (L, T), ``split`` (L, S), ``bucket`` (L, S), ``leaf_of_vec`` (n,) and
    ``leaf_sizes`` (leaves,) (numpy arrays or tensors, as
    ``ANNIndex.forest_view()`` gives them); ``ids`` (n,) the row of ``x``
    each of the trees' rows is; ``x`` (rows, d) the rows the distances
    are taken to (``precision`` "f64" as they are, "bf16" rounded to
    bf16 first: the control)."""

    def __init__(self, trees, ids, x: torch.Tensor, precision: str = "f64"):
        dev = x.device
        if precision == "f64":
            self.x = x.double()
        elif precision == "bf16":
            self.x = x.to(torch.bfloat16).double()
        else:
            raise ValueError(precision)
        self.x_sq = (self.x * self.x).sum(1)
        t_n = len(trees)
        n_rows = x.shape[0]

        def dev_t(a, dtype=torch.int64):
            return _tensor(a).to(dev, dtype)

        self.L = max(t.split.shape[0] for t in trees)
        self.S = max(t.split.shape[1] for t in trees)
        self.split = torch.full((t_n, self.L, self.S), -1, dtype=torch.int64, device=dev)
        self.bucket = torch.full_like(self.split, -1)
        # the hyperplanes a tree's levels use, packed: level l of tree t
        # has its slot s at row base[t, l] + s
        self.base = torch.zeros((t_n, self.L), dtype=torch.int64, device=dev)
        coeffs, consts, pos = [], [], 0
        for t, tr in enumerate(trees):
            split, bucket = dev_t(tr.split), dev_t(tr.bucket)
            lv, sv = split.shape
            self.split[t, :lv, :sv] = split
            self.bucket[t, :lv, :sv] = bucket
            coeff = _tensor(tr.coeff).to(dev)
            const = _tensor(tr.const).to(dev)
            for lvl in range(self.L):
                used = int(split[lvl].max()) + 1 if lvl < lv else 0
                self.base[t, lvl] = pos
                if used > 0:
                    coeffs.append(coeff[lvl, :used].double())
                    consts.append(const[lvl, :used].double())
                    pos += used
        d = x.shape[1]
        self.coeff = torch.cat(coeffs) if coeffs else torch.zeros((1, d), dtype=torch.float64, device=dev)
        self.const = torch.cat(consts) if consts else torch.zeros(1, dtype=torch.float64, device=dev)

        # leaf membership in the rows of x: lov[t, row], -1 for a row of
        # no tree; each leaf's rows in ascending order
        ids = dev_t(ids)
        self.n = int(ids.shape[0])
        self.lov = torch.full((t_n, n_rows), -1, dtype=torch.int64, device=dev)
        for t, tr in enumerate(trees):
            self.lov[t, ids] = dev_t(tr.leaf_of_vec)
        self.n_leaves = [int(tr.leaf_sizes.shape[0]) for tr in trees]
        b_max = max(max(self.n_leaves), 1)
        self.sizes = torch.zeros((t_n, b_max), dtype=torch.int64, device=dev)
        self.starts = torch.zeros_like(self.sizes)
        self.order = torch.zeros((t_n, n_rows), dtype=torch.int64, device=dev)
        for t in range(t_n):
            lov = self.lov[t]
            on = lov >= 0
            cnt = torch.bincount(lov[on], minlength=b_max)[:b_max]
            self.sizes[t] = cnt
            self.starts[t] = torch.cumsum(cnt, 0) - cnt
            keyed = torch.where(on, lov, b_max)
            self.order[t] = torch.argsort(keyed, stable=True)
        self.span = max(int(self.sizes.max()), 1)

    @property
    def trees(self) -> int:
        return self.split.shape[0]

    # -- the descent ----------------------------------------------------

    def margin(self, q: torch.Tensor, tree: torch.Tensor, lvl, slot: torch.Tensor):
        """(R,) f64 ``coeff . q + const`` of each row's hyperplane."""
        row = (self.base[tree, lvl] + slot.clamp_min(0)).clamp_max(self.coeff.shape[0] - 1)
        return (self.coeff[row] * q).sum(1) + self.const[row]

    def node(self, tree, lvl, v):
        """(split slot, leaf) of each row's node (lvl, v); -1 off the tables."""
        ok = (v >= 0) & (v < self.S) & (lvl < self.L)
        lc = torch.as_tensor(lvl, device=v.device).clamp_max(self.L - 1)
        vc = v.clamp(0, self.S - 1)
        return (torch.where(ok, self.split[tree, lc, vc], -1),
                torch.where(ok, self.bucket[tree, lc, vc], -1))

    def descend(self, q: torch.Tensor, tree: torch.Tensor, flip: torch.Tensor,
                inv_lvl: torch.Tensor, inv_node: torch.Tensor):
        """One descent a row of ``q`` (R, d) f64 in its tree (R,): at the
        level ``flip`` the other side is taken, and at the node
        (``inv_lvl``, ``inv_node``) the other side too (-1: none). Returns
        (leaf (R,) or -1, signed margins (R, L) with +inf off the path's
        inner nodes, position (R, L) at each level or -1)."""
        r = q.shape[0]
        dev = q.device
        v = torch.zeros(r, dtype=torch.int64, device=dev)
        leaf = torch.full((r,), -1, dtype=torch.int64, device=dev)
        margins = torch.full((r, self.L), _INF, dtype=torch.float64, device=dev)
        nodes = torch.full((r, self.L), -1, dtype=torch.int64, device=dev)
        for lvl in range(self.L):
            alive = v >= 0
            nodes[:, lvl] = v
            s, b = self.node(tree, lvl, v)
            inner = alive & (s >= 0)
            m = self.margin(q, tree, lvl, s)
            margins[:, lvl] = torch.where(inner, m, _INF)
            side = (m >= 0) ^ (flip == lvl) ^ ((inv_lvl == lvl) & (inv_node == v))
            leaf = torch.where(alive & (b >= 0), b, leaf)
            v = torch.where(inner, 2 * s + side.long(), -1)
        return leaf, margins, nodes

    def probe_rows(self, q, tree, p: int, gate_k: int, inv_lvl=None,
                   inv_node=None, swap=None):
        """Each row's ``p`` probed leaves, -1 where gated (see the module
        docstring), under an alternative: the node (``inv_lvl``,
        ``inv_node``) taking its other side, or the flips of ranks
        ``swap`` and ``swap + 1`` exchanged (-1: none). Returns (leaves
        (R, p), the probes' paths: [(flip level (R,), margins (R, L),
        positions (R, L))] one a probe)."""
        r = q.shape[0]
        none = torch.full((r,), -1, dtype=torch.int64, device=q.device)
        inv_lvl = none if inv_lvl is None else inv_lvl
        inv_node = none if inv_node is None else inv_node
        leaf, m, nodes = self.descend(q, tree, none, inv_lvl, inv_node)
        leaves, paths = [leaf], [(none, m, nodes)]
        if p > 1:
            order = torch.argsort(m.abs(), dim=1, stable=True)
            if swap is not None:
                at = torch.arange(r, device=q.device)
                sw = swap.clamp_min(0)
                a, b = order[at, sw], order[at, (sw + 1).clamp_max(self.L - 1)]
                hit = swap >= 0
                order = order.clone()
                order[at, sw] = torch.where(hit, b, a)
                order[at, (sw + 1).clamp_max(self.L - 1)] = torch.where(hit, a, b)
            for j in range(1, p):
                flip = order[:, j - 1]
                lj, mj, nj = self.descend(q, tree, flip, inv_lvl, inv_node)
                leaves.append(torch.where(lj >= 0, lj, leaves[-1]))
                paths.append((flip, mj, nj))
        out = torch.stack(leaves, 1)
        if gate_k:
            size = torch.where(out >= 0, self.sizes[tree[:, None], out.clamp_min(0)], 0)
            contrib = size.clamp_max(gate_k)
            before = torch.cumsum(contrib, 1) - contrib
            out = torch.where(before < gate_k, out, -1)
        return out, paths

    def probes(self, queries: torch.Tensor, p: int, gate_k: int, ties: bool = False,
               block: int = 4096):
        """Each query's probed leaves (Q, T, p), -1 where gated; with
        ``ties`` also the alternatives the near ties allow: (query (A,),
        tree (A,), leaves (A, p))."""
        t_n, dev = self.trees, self.x.device
        outs, alts = [], []
        for a, b in _blocks(queries.shape[0], block):
            q64 = queries[a:b].to(dev).double()
            m = b - a
            qrow = torch.arange(m, device=dev).repeat_interleave(t_n)
            tree = torch.arange(t_n, device=dev).repeat(m)
            q = q64[qrow]
            leaves, paths = self.probe_rows(q, tree, p, gate_k)
            outs.append(leaves.reshape(m, t_n, p))
            if ties:
                alts.append(self._alternatives(q, qrow + a, tree, p, gate_k, paths))
        probes = torch.cat(outs)
        if not ties:
            return probes
        return probes, tuple(torch.cat(c) for c in zip(*alts))

    def _alternatives(self, q, qidx, tree, p, gate_k, paths):
        """The probe lists one near tie away from each row's: a node on a
        probe's path whose margin is within TIE of zero taking its other
        side, or two of the main path's |margins| within TIE of each other
        at adjacent ranks up to the last flipped one exchanged."""
        spec = []  # (row, inv level, inv node, swap)
        _, m0, n0 = paths[0]
        rows, lvls = torch.nonzero(m0.abs() < TIE, as_tuple=True)
        spec.append((rows, lvls, n0[rows, lvls], torch.full_like(rows, -1)))
        for flip, mj, nj in paths[1:]:
            below = torch.arange(self.L, device=q.device)[None, :] > flip[:, None]
            reached = torch.isfinite(m0.gather(1, flip[:, None].clamp_min(0)))
            rows, lvls = torch.nonzero((mj.abs() < TIE) & below & reached, as_tuple=True)
            spec.append((rows, lvls, nj[rows, lvls], torch.full_like(rows, -1)))
        if p > 1:
            srt = torch.sort(m0.abs(), dim=1, stable=True).values[:, :p]
            close = (srt[:, 1:] - srt[:, :-1] < TIE) & torch.isfinite(srt[:, 1:])
            rows, ranks = torch.nonzero(close, as_tuple=True)
            none = torch.full_like(rows, -1)
            spec.append((rows, none, none, ranks))
        rows, lvl, node, swap = (torch.cat(c) for c in zip(*spec))
        if rows.numel() == 0:
            empty = torch.zeros(0, dtype=torch.int64, device=q.device)
            return empty, empty, torch.zeros((0, p), dtype=torch.int64, device=q.device)
        leaves, _ = self.probe_rows(q[rows], tree[rows], p, gate_k, lvl, node, swap)
        return qidx[rows], tree[rows], leaves

    # -- rows of leaves -------------------------------------------------

    def leaf_rows(self, tree: torch.Tensor, leaf: torch.Tensor):
        """(rows (..., span), live (..., span)): the rows of each leaf
        (-1: none) of its tree, ``tree`` broadcast against ``leaf``."""
        tree = tree.expand_as(leaf)
        lc = leaf.clamp_min(0)
        size = torch.where(leaf >= 0, self.sizes[tree, lc], 0)
        off = torch.arange(self.span, device=leaf.device)
        live = off < size[..., None]
        pos = (self.starts[tree, lc][..., None] + off).clamp_max(self.order.shape[1] - 1)
        return self.order[tree[..., None].expand_as(pos), pos], live

    def candidates(self, probes: torch.Tensor):
        """(rows (m, T * p * span), live): the rows of each query's probed
        leaves, each row once (its repeats not live)."""
        m = probes.shape[0]
        tree = torch.arange(self.trees, device=probes.device)[None, :, None]
        rows, live = self.leaf_rows(tree, probes)
        rows, live = rows.reshape(m, -1), live.reshape(m, -1)
        live &= ~repeats_earlier(torch.where(live, rows, -1))
        return rows, live

    def nearest(self, dist: torch.Tensor, probes: torch.Tensor, k: int):
        """(distances (m, k), rows (m, k)): the k nearest rows of the
        probed leaves by ``dist`` (m, rows of x); +inf and -1 past them."""
        rows, live = self.candidates(probes)
        near = dist.gather(1, rows).masked_fill_(~live, _INF)
        best = near.topk(min(k, near.shape[1]), largest=False)
        d = torch.nn.functional.pad(best.values, (0, k - best.values.shape[1]), value=_INF)
        i = torch.nn.functional.pad(rows.gather(1, best.indices), (0, k - best.indices.shape[1]))
        return d, torch.where(torch.isfinite(d), i, -1)

    def sq_dist(self, q64: torch.Tensor) -> torch.Tensor:
        """(m, rows of x) f64 squared distances."""
        q_sq = (q64 * q64).sum(1)
        return torch.addmm(self.x_sq[None, :], q64, self.x.T, alpha=-2.0) + q_sq[:, None]

    def search(self, queries: torch.Tensor, k: int, p: int, gate_k: int,
               budget_bytes: int = 1 << 30):
        """The plain search: (distances (Q, k) f64, rows (Q, k) int64)."""
        probes = self.probes(queries, p, gate_k)
        out_d, out_i = [], []
        for a, b in _blocks(queries.shape[0], max(1, budget_bytes // (8 * self.x.shape[0]))):
            dist = self.sq_dist(queries[a:b].to(self.x.device).double())
            d, i = self.nearest(dist, probes[a:b], k)
            out_d.append(d)
            out_i.append(i)
        return torch.cat(out_d), torch.cat(out_i)

    # -- the reference's own rule ---------------------------------------

    def tree_result(self, queries: torch.Tensor, k: int, block: int = 256):
        """(Q, k) rows: the reference's `tree_result` in every tree, the
        trees' candidates pooled and the k nearest kept (see the module
        docstring)."""
        t_n, dev = self.trees, self.x.device
        out = []
        for a, b in _blocks(queries.shape[0], block):
            q64 = queries[a:b].to(dev).double()
            m = b - a
            qrow = torch.arange(m, device=dev).repeat_interleave(t_n)
            tree = torch.arange(t_n, device=dev).repeat(m)
            cand = self._tree_result(q64[qrow], tree, k).reshape(m, t_n * k)
            live = (cand >= 0) & ~repeats_earlier(cand)
            rows = self.x[cand.clamp_min(0)]
            d = ((rows - q64[:, None, :]) ** 2).sum(-1).masked_fill_(~live, _INF)
            best = d.topk(min(k, d.shape[1]), largest=False)
            out.append(torch.where(torch.isfinite(best.values),
                                   cand.gather(1, best.indices), -1))
        return torch.cat(out)

    def _tree_result(self, q: torch.Tensor, tree: torch.Tensor, k: int):
        """(R, k) rows of each row's tree, -1 past them: a depth-first walk
        a row, all rows in lockstep, one node a row a step."""
        r, dev = q.shape[0], q.device
        at = torch.arange(r, device=dev)
        cap = self.L + 2
        stack = torch.zeros((r, cap + 1, 2), dtype=torch.int64, device=dev)
        top = torch.ones(r, dtype=torch.int64, device=dev)  # the root (0, 0)
        missing = torch.full((r,), k, dtype=torch.int64, device=dev)
        cand = torch.full((r, k + 1), -1, dtype=torch.int64, device=dev)
        got = torch.zeros(r, dtype=torch.int64, device=dev)
        while True:
            live = (top > 0) & (missing > 0)
            if not bool(live.any()):
                break
            top = top - live.long()
            lvl, v = stack[at, top.clamp_min(0)].unbind(1)
            v = torch.where(live & (lvl < self.L), v, -1)
            s, b = self.node(tree, lvl.clamp_max(self.L - 1), v)
            inner = s >= 0
            # an inner node: the other side below, the query's side on top
            above = (self.margin(q, tree, lvl.clamp_max(self.L - 1), s) >= 0).long()
            for j, side in enumerate((1 - above, above)):
                slot = torch.where(inner, top + j, cap)
                stack[at, slot] = torch.stack([lvl + 1, 2 * s + side], 1)
            top = top + 2 * inner.long()
            # a leaf: its rows nearest first, up to the rows still missing
            rows, on = self.leaf_rows(tree, b)
            d = ((self.x[rows] - q[:, None, :]) ** 2).sum(-1).masked_fill_(~on, _INF)
            rows = rows.gather(1, torch.sort(d, dim=1, stable=True).indices)
            take = torch.minimum(on.sum(1), missing)
            j = torch.arange(self.span, device=dev)[None, :]
            slot = torch.where(j < take[:, None], got[:, None] + j, k)
            cand.scatter_(1, slot, rows)
            got += take
            missing -= take
        return cand[:, :k]


def leaf_stray(trees, max_node_size: int) -> int:
    """Faults of the build (``leaf_stray`` in the module docstring), from
    each tree's tables as served."""
    count = 0
    for tr in trees:
        lov = _tensor(tr.leaf_of_vec).long()
        sizes = _tensor(tr.leaf_sizes).long()
        bucket = _tensor(tr.bucket).long()
        n_leaves = sizes.shape[0]
        ok = (lov >= 0) & (lov < n_leaves)
        count += int((~ok).sum())
        counted = torch.bincount(lov[ok], minlength=n_leaves)[:n_leaves]
        count += int((counted != sizes).sum())
        named = bucket >= 0
        count += int((bucket[named] >= n_leaves).sum())
        leaf_ids = bucket[named & (bucket < n_leaves)]
        named_n = torch.bincount(leaf_ids, minlength=n_leaves)[:n_leaves]
        count += int((named_n != 1).sum())
        # the level each leaf is named on: below the last, under the size
        level = torch.zeros(n_leaves, dtype=torch.int64)
        lvls = torch.nonzero(named & (bucket < n_leaves), as_tuple=True)[0]
        level[leaf_ids] = lvls
        last = bucket.shape[0] - 1
        count += int(((counted >= max_node_size) & (level < last)).sum())
        count += int((counted == 0).sum())
    return count


def side_miss(forest: Forest, x: torch.Tensor, rows: torch.Tensor) -> float:
    """The share of ``rows`` (rows of x in the trees) whose descent in
    some tree does not reach their own leaf, rows with a margin within
    TIE of zero on the path aside."""
    t_n, dev = forest.trees, forest.x.device
    rows = rows.to(dev)
    q = x[rows].to(dev).double().repeat_interleave(t_n, 0)
    tree = torch.arange(t_n, device=dev).repeat(rows.shape[0])
    none = torch.full_like(tree, -1)
    leaf, m, _ = forest.descend(q, tree, none, none, none)
    own = forest.lov[tree, rows.repeat_interleave(t_n)]
    miss = (leaf != own) & ~(m.abs() < TIE).any(1)
    return float(miss.reshape(-1, t_n).any(1).double().mean())


def tie_combos(probes: torch.Tensor, alt_q: torch.Tensor, alt_t: torch.Tensor,
               alt_leaves: torch.Tensor, combos: int = COMBOS):
    """The probe lists a query's near ties allow, beside its own: of the
    alternatives that change a tree's list, each tree's own list or one
    of its alternatives, every combination where they number ``combos``
    or fewer, else one alternative at a time. Returns (query (C,), probe
    lists (C, T, p))."""
    changes = (alt_leaves != probes[alt_q, alt_t]).any(1)
    alt_q, alt_t, alt_leaves = alt_q[changes], alt_t[changes], alt_leaves[changes]
    by_query: Dict[int, Dict[int, list]] = {}
    for i, (q, t) in enumerate(zip(alt_q.tolist(), alt_t.tolist())):
        by_query.setdefault(q, {}).setdefault(t, []).append(i)
    rows, picks = [], []  # picks: (combination, tree, alternative)
    for q, trees in by_query.items():
        options = [[None] + alts for alts in trees.values()]
        if math.prod(map(len, options)) > combos:
            chosen = [[(t, i)] for t, alts in trees.items() for i in alts]
        else:
            chosen = [[(t, i) for t, i in zip(trees, pick) if i is not None]
                      for pick in itertools.product(*options)][1:]
        for combo in chosen:
            picks += [(len(rows), t, i) for t, i in combo]
            rows.append(q)
    cq = torch.tensor(rows, dtype=torch.int64, device=probes.device)
    lists = probes[cq].clone()
    if picks:
        c, t, i = torch.tensor(picks, device=probes.device).unbind(1)
        lists[c, t] = alt_leaves[i]
    return cq, lists


def _gaps(forest: Forest, dist, probes, exact, valid, served, k, scale):
    """Per query: the widest share by which the i-th served row lies
    beyond the i-th nearest probed row, and the served rows outside the
    probed leaves or missing where probed rows exist."""
    ref, _ = forest.nearest(dist, probes, k)
    gap = torch.where(valid, exact - ref, 0.0) / scale[:, None]
    own = forest.lov[:, served.clamp_min(0)].permute(1, 2, 0)  # (m, k, T)
    inside = ((own[:, :, :, None] == probes[:, None, :, :]) & (own[:, :, :, None] >= 0)
              ).flatten(2).any(-1)
    stray = (valid & ~inside).sum(1) + (~valid & torch.isfinite(ref)).sum(1)
    return gap.max(1).values, stray


def judge(x: torch.Tensor, queries: torch.Tensor, served_d: torch.Tensor,
          served_i: torch.Tensor, k: int, forest: Forest, trees, p: int,
          gate_k: int, max_node_size: int, self_rows: torch.Tensor,
          sample: torch.Tensor, budget_bytes: int = 1 << 30,
          log=None) -> Dict[str, float]:
    """The numbers that decide ``correct`` (see the module docstring),
    and ``recall_at_10``. ``x`` (rows, d) f32 the corpus; ``served_*``
    (Q, k) for ``queries`` (Q, d), in rows of x; ``forest`` the trees
    over x at f64; ``trees`` the served tables (``leaf_stray``); ``p`` and
    ``gate_k`` the probes a tree and the deficit gate's k (0: none);
    ``self_rows`` the rows ``side_miss`` asks for; ``sample`` the
    queries ``recall_gap`` compares on."""
    dev = x.device
    n = x.shape[0]
    out = dict(dist_err=0.0, rank_gap=0.0, stray_ids=0.0)
    out["leaf_stray"] = float(leaf_stray(trees, max_node_size))
    out["side_miss"] = side_miss(forest, x, self_rows)
    if log is not None:
        log("check: the build (leaves, sides)")

    probes, alts = forest.probes(queries, p, gate_k, ties=True)
    combo_q, combo_lists = tie_combos(probes, *alts)
    if log is not None:
        log(f"check: the plain descent ({alts[0].numel()} near ties, "
            f"{combo_q.numel()} other probe lists over "
            f"{int(combo_q.unique().numel())} queries)")
    x_mean = float(forest.x_sq.mean())
    truth = torch.empty((queries.shape[0], k), dtype=torch.int64, device=dev)
    hits = 0
    for a, b in _blocks(queries.shape[0], max(1, budget_bytes // (8 * n))):
        q64 = queries[a:b].to(dev).double()
        scale = (q64 * q64).sum(1) + x_mean
        dist = forest.sq_dist(q64)
        si = served_i[a:b].to(dev, torch.int64)
        valid = (si >= 0) & (si < n)
        served = si.clamp(0, n - 1)
        exact = torch.where(valid, dist.gather(1, served), _INF)
        sd = served_d[a:b].to(dev).double()
        err = torch.where(valid, (sd - exact).abs() / scale[:, None], 0.0)
        out["dist_err"] = _widest(out["dist_err"], err)
        order = (valid[:, 1:] & valid[:, :-1] & ~(sd[:, 1:] >= sd[:, :-1])).sum(1)
        repeats = (repeats_earlier(torch.where(valid, si, -1 - torch.arange(
            k, device=dev))) & valid).sum(1)
        truth[a:b] = dist.topk(k, largest=False).indices
        hits += int((truth[a:b, :, None] == si[:, None, :]).any(1).sum())

        gap, stray = _gaps(forest, dist, probes[a:b], exact, valid, si, k, scale)
        mine = (combo_q >= a) & (combo_q < b)
        if bool(mine.any()):
            loc = combo_q[mine] - a
            g, s_ = _gaps(forest, dist[loc], combo_lists[mine], exact[loc], valid[loc],
                          si[loc], k, scale[loc])
            gap = gap.scatter_reduce(0, loc, g, "amin")
            stray = stray.scatter_reduce(0, loc, s_, "amin")
        out["rank_gap"] = _widest(out["rank_gap"], gap)
        out["stray_ids"] += float((stray + repeats + order).sum())
    out["recall_at_10"] = hits / (queries.shape[0] * k)
    if log is not None:
        log("check: the answers")

    sample = sample.to(dev)
    rule = forest.tree_result(queries[sample], k)
    out["recall_gap"] = (recall(rule, truth[sample])
                         - recall(served_i[sample].to(dev), truth[sample]))
    if log is not None:
        log(f"check: the reference's rule on {sample.numel()} queries "
            f"(recall {out['recall_gap'] + recall(served_i[sample].to(dev), truth[sample]):.5f})")
    return out


def scan_work(forest: Forest, probes: torch.Tensor, d: int, k: int) -> dict:
    """Kernel B's work in one call from its probed leaves (Q, T, p), -1
    gated, in ``packed_scan_bound``'s terms summed over the trees: the
    live (query, tree, rank) pairs, the result rows (every pair), the
    (pair, row) products, and the rows of each tree's distinct probed
    leaves."""
    q_n, t_n, p = probes.shape
    live = probes >= 0
    tree = torch.arange(t_n, device=probes.device)[None, :, None].expand_as(probes)
    sizes = torch.where(live, forest.sizes[tree, probes.clamp_min(0)], 0)
    probed = 0
    for t in range(t_n):
        leaves = probes[:, t][live[:, t]].unique()
        probed += int(forest.sizes[t, leaves].sum())
    return dict(live_rows=int(live.sum()), out_rows=q_n * t_n * p,
                scanned=int(sizes.sum()), probed_rows=probed, d=d, k=k)
