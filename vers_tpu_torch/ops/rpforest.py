"""Level-synchronous random-hyperplane tree build and the batched
query descent (counterpart of ``vers_tpu.ops.rpforest``; the reference
is the recursive RP-tree construction of `vers/src/indexes/lsh.rs:58-111`).

Instead of host recursion over id partitions, ALL nodes of one level
split at once:

- every vector carries a compact "alive node id"; a level is one
  batched pass: count members per node, pick two random members per
  splitting node (scatter-max over a random permutation), form each
  hyperplane as the perpendicular bisector of the pair (parity with
  `build_hyperplane`, `lsh.rs:58-94`), project every vector onto its own
  node's plane (row gather + rowwise dot), and route it to child
  ``2*split + side``.
- nodes with fewer than ``max_size`` members freeze into leaves (parity
  with the `indexes.len() < max_size` rule, `lsh.rs:97`).

At most ceil(n/max_size) nodes can split per level, so the per-level
tables are padded to that bound. The same tables drive the query
descent, and they convert losslessly to and from the reference's
recursive Node enum for bincode persistence
(``vers_tpu_torch.index.lsh``).

Every function runs on the device of its input tensors; random draws
come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class ForestTables(NamedTuple):
    """Per-tree level tables. L = max_depth + 1, S = alive-node cap,
    T = splitting-node cap.

    coeff:  (L, T, d) hyperplane normals
    const:  (L, T)    hyperplane constants
    split:  (L, S)    alive node -> split slot, or -1 if leaf/empty
    bucket: (L, S)    alive node -> leaf bucket id, or -1
    leaf_of_vec: (n,) bucket id per vector
    num_buckets: ()   int32
    """

    coeff: torch.Tensor
    const: torch.Tensor
    split: torch.Tensor
    bucket: torch.Tensor
    leaf_of_vec: torch.Tensor
    num_buckets: torch.Tensor


def depth_bound(n: int, max_size: int) -> int:
    """Levels needed assuming reasonably balanced random splits, plus
    slack for skew. Nodes still oversized at the bottom freeze into
    (oversized) leaves — a bounded deviation from the reference's
    unbounded recursion, documented in index/lsh.py."""
    if n <= max(max_size, 1):
        return 1
    return int(math.ceil(math.log2(n / max_size))) + 8


def _scatter_max(size: int, index: torch.Tensor, src: torch.Tensor):
    """(size,) int64, -1 where no entry of ``index`` points."""
    out = torch.full((size,), -1, dtype=torch.int64, device=src.device)
    return out.scatter_reduce_(0, index, src, "amax", include_self=True)


def build_tree(gen: Optional[torch.Generator], data: torch.Tensor,
               n_valid: int, max_size: int, max_depth: int,
               perms: Optional[torch.Tensor] = None) -> ForestTables:
    """Build one RP tree over data (n_pad, d); rows >= n_valid ignored.

    Each level picks every splitting node's two members by the highest
    and second-highest value of a permutation of the rows: level l takes
    ``perms[l]`` ((max_depth, n_pad), each row a permutation of
    arange(n_pad)) when given, else ``torch.randperm`` from ``gen``."""
    n_pad, d = data.shape
    dev = data.device
    t_cap = max(int(n_pad // max(max_size, 1)) + 1, 2)
    s_cap = 2 * t_cap
    arange_n = torch.arange(n_pad, device=dev)
    valid = arange_n < n_valid

    node = torch.where(valid, 0, -1)
    leaf_of_vec = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
    bucket_counter = torch.zeros((), dtype=torch.int64, device=dev)
    splits, buckets, coeffs, consts = [], [], [], []
    for lvl in range(max_depth):
        alive = (node >= 0) & valid
        node_c = torch.where(alive, node, s_cap)  # dump slot s_cap

        counts = torch.bincount(node_c, minlength=s_cap + 1)[:s_cap]
        split_mask = counts >= max_size
        leaf_mask = (counts > 0) & ~split_mask
        split_idx = torch.where(split_mask, torch.cumsum(split_mask, 0) - 1, -1)
        bucket_ids = torch.where(
            leaf_mask, bucket_counter + torch.cumsum(leaf_mask, 0) - 1, -1)
        bucket_counter = bucket_counter + leaf_mask.sum()

        # -- pick two random members per splitting node ---------------
        if perms is not None:
            perm = perms[lvl].to(device=dev, dtype=torch.int64)
        else:
            perm = torch.randperm(n_pad, generator=gen, device=dev)
        pr = torch.where(alive, perm, -1)
        best_a = _scatter_max(s_cap + 1, node_c, pr)
        a_mask = alive & (pr == best_a[node_c]) & (pr >= 0)
        pr2 = torch.where(a_mask, -1, pr)
        best_b = _scatter_max(s_cap + 1, node_c, pr2)
        b_mask = alive & (pr2 == best_b[node_c]) & (pr2 >= 0)
        # the priorities are distinct, so each node has one winner and
        # the scatter-adds write that row's index
        zeros = torch.zeros((s_cap + 1,), dtype=torch.int64, device=dev)
        a_row = zeros.index_add(0, torch.where(a_mask, node_c, s_cap),
                                torch.where(a_mask, arange_n, 0))[:s_cap]
        b_row = zeros.index_add(0, torch.where(b_mask, node_c, s_cap),
                                torch.where(b_mask, arange_n, 0))[:s_cap]

        # hyperplane per splitting node (parity with `lsh.rs:58-94`):
        # coeff = b - a, const = -coeff . (a + b)/2
        xa = data[a_row]  # (S, d)
        xb = data[b_row]
        coeff_node = xb - xa
        const_node = -torch.sum(coeff_node * (xa + xb) * 0.5, dim=1)

        slot = torch.where(split_mask, split_idx, t_cap)
        coeff_l = torch.zeros((t_cap + 1, d), dtype=torch.float32, device=dev)
        coeff_l[slot] = torch.where(split_mask[:, None], coeff_node, 0.0)
        const_l = torch.zeros((t_cap + 1,), dtype=torch.float32, device=dev)
        const_l[slot] = torch.where(split_mask, const_node, 0.0)
        coeff_l, const_l = coeff_l[:t_cap], const_l[:t_cap]

        # -- route every vector ---------------------------------------
        my_split = torch.where(alive, split_idx[node_c % s_cap], -1)
        my_bucket = torch.where(alive, bucket_ids[node_c % s_cap], -1)
        safe = torch.clamp(my_split, 0, t_cap - 1)
        proj = torch.sum(data * coeff_l[safe], dim=1) + const_l[safe]
        side = (proj >= 0.0).to(torch.int64)  # 1 = above = right

        leaf_of_vec = torch.where(alive & (my_bucket >= 0), my_bucket,
                                  leaf_of_vec)
        node = torch.where(alive & (my_split >= 0), 2 * my_split + side, -1)
        splits.append(split_idx)
        buckets.append(bucket_ids)
        coeffs.append(coeff_l)
        consts.append(const_l)

    # vectors still alive after max_depth: freeze whole nodes into
    # leaves (extra buckets appended at the end)
    still = (node >= 0) & valid
    node_c = torch.where(still, node, s_cap)
    occupied = torch.bincount(node_c, minlength=s_cap + 1)[:s_cap] > 0
    extra = torch.where(
        occupied, bucket_counter + torch.cumsum(occupied, 0) - 1, -1)
    leaf_of_vec = torch.where(still, extra[torch.clamp(node, 0, s_cap - 1)],
                              leaf_of_vec)
    bucket_counter = bucket_counter + occupied.sum()

    # overflow level tables: the frozen nodes live at level L as leaves
    splits.append(torch.full((s_cap,), -1, dtype=torch.int64, device=dev))
    buckets.append(extra)
    coeffs.append(torch.zeros((t_cap, d), dtype=torch.float32, device=dev))
    consts.append(torch.zeros((t_cap,), dtype=torch.float32, device=dev))
    return ForestTables(
        coeff=torch.stack(coeffs),
        const=torch.stack(consts),
        split=torch.stack(splits).to(torch.int32),
        bucket=torch.stack(buckets).to(torch.int32),
        leaf_of_vec=leaf_of_vec.to(torch.int32),
        num_buckets=bucket_counter.to(torch.int32),
    )


def descend(queries: torch.Tensor, coeff, const, split, bucket):
    """Route a (Q, d) query batch to leaf buckets of one tree's dense
    level tables. Returns (Q,) int32 bucket ids (parity with the
    main-branch descent of `tree_result`, `lsh.rs:203-214`; the
    deficit/backup rule lives in the host parity path)."""
    q_n = queries.shape[0]
    dev = queries.device
    n_levels, t_cap, _ = coeff.shape
    s_cap = split.shape[1]
    v = torch.zeros((q_n,), dtype=torch.int64, device=dev)
    out = torch.full((q_n,), -1, dtype=torch.int64, device=dev)
    for lvl in range(n_levels):
        alive = v >= 0
        vc = torch.clamp(v, 0, s_cap - 1)
        my_split = torch.where(alive, split[lvl][vc].to(torch.int64), -1)
        my_bucket = torch.where(alive, bucket[lvl][vc].to(torch.int64), -1)
        safe = torch.clamp(my_split, 0, t_cap - 1)
        proj = torch.sum(queries * coeff[lvl][safe], dim=1) + const[lvl][safe]
        side = (proj >= 0.0).to(torch.int64)
        out = torch.where(alive & (my_bucket >= 0), my_bucket, out)
        v = torch.where(alive & (my_split >= 0), 2 * my_split + side, -1)
    return out.to(torch.int32)


def _descend_once_flat(queries, coeff_flat, const_flat, cbase, splits,
                       buckets, tree, flip_level, want_margins: bool):
    """One descent per row of ``tree`` ((R,) tree index of each row; R
    rows run together), on the PACKED hyperplane layout: hyperplanes of
    all trees and levels live in one (total, d) array and ``cbase``
    (T, L) maps a tree's level to its first row (the dense (T, L, TC, d)
    layout is mostly padding). ``flip_level`` (R, Q) flips the decision
    at that level (-1: none). Returns (buckets (R, Q), margins (R, Q, L)
    = |proj| at each traversed split, +inf elsewhere, or None)."""
    dev = queries.device
    q_n = queries.shape[0]
    total = coeff_flat.shape[0]
    _, n_levels, s_cap = splits.shape
    n_rows = tree.shape[0]
    splits_flat = splits.reshape(-1)
    buckets_flat = buckets.reshape(-1)
    # per row and level: where the level's nodes and its hyperplanes start
    node0 = (tree[:, None] * n_levels
             + torch.arange(n_levels, device=dev)) * s_cap  # (R, L)
    plane0 = cbase[tree]                                    # (R, L)
    v = torch.zeros((n_rows, q_n), dtype=torch.int32, device=dev)
    out = torch.full((n_rows, q_n), -1, dtype=torch.int64, device=dev)
    margins = []
    for lvl in range(n_levels):
        alive = v >= 0
        at = node0[:, lvl, None] + torch.clamp(v, 0, s_cap - 1)
        my_split = torch.where(alive, splits_flat[at], -1)
        my_bucket = torch.where(alive, buckets_flat[at], -1)
        row = torch.clamp(plane0[:, lvl, None] + torch.clamp_min(my_split, 0),
                          0, total - 1)
        proj = torch.einsum("rqd,qd->rq", coeff_flat[row], queries) \
            + const_flat[row]
        side = proj >= 0.0  # True = above = right
        if flip_level is not None:
            side = side ^ (flip_level == lvl)
        inner = alive & (my_split >= 0)
        if want_margins:
            margins.append(torch.where(inner, proj.abs(), float("inf")))
        out = torch.where(alive & (my_bucket >= 0), my_bucket, out)
        v = torch.where(inner, 2 * my_split + side, -1)
    return out, (torch.stack(margins, dim=2) if want_margins else None)


def descend_forest_flat(queries, coeff_flat, const_flat, cbase, splits,
                        buckets, offsets, n_probes: int):
    """Multiprobe descent through EVERY tree, all trees in one pass of
    L levels and all flipped probes in a second.

    cbase (T, L) int32, splits/buckets (T, L, SC) int32, offsets (T,)
    shift each tree's bucket ids into one bin space across trees. Probe 0
    of a tree is the main leaf; probe j flips the split decision with
    the j-th smallest |projection| margin (classic multiprobe — recovers
    the recall the reference's backup-branch rule provides,
    `lsh.rs:203-214`, in batched form); a probe that reaches no leaf
    repeats the probe before it. Returns (Q, T*n_probes) int64 bins,
    column t*n_probes + j, equal to descending tree by tree."""
    n_trees, n_levels, _ = splits.shape
    q_n = queries.shape[0]
    dev = queries.device
    off = offsets.to(torch.int64)[:, None]
    trees = torch.arange(n_trees, device=dev)
    main, margins = _descend_once_flat(
        queries, coeff_flat, const_flat, cbase, splits, buckets, trees,
        None, want_margins=n_probes > 1)
    outs = [main + off]  # each (T, Q)
    if n_probes > 1:
        flips = n_probes - 1
        if flips > n_levels:
            raise IndexError(
                f"{n_probes} probes need {flips} levels to flip; the tables "
                f"have {n_levels}")
        # a stable sort: most margins are +inf (levels a query never
        # reached), and which of them a late rank flips decides whether
        # that probe repeats the main leaf
        order = torch.argsort(margins, dim=2, stable=True)[:, :, :flips]
        flip_level = order.permute(0, 2, 1).reshape(n_trees * flips, q_n)
        bj, _ = _descend_once_flat(
            queries, coeff_flat, const_flat, cbase, splits, buckets,
            trees.repeat_interleave(flips), flip_level, want_margins=False)
        bj = bj.reshape(n_trees, flips, q_n)
        for j in range(flips):
            outs.append(torch.where(bj[:, j] >= 0, bj[:, j] + off, outs[-1]))
    # (P, T, Q) -> (Q, T, P) -> (Q, T*P)
    return torch.stack(outs).permute(2, 1, 0).reshape(q_n, n_trees * n_probes)
