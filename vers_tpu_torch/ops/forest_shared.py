"""Shared-corpus RP-forest search (counterpart of
``vers_tpu.ops.forest_shared``) — memory parity with the reference.

The Rust reference stores the corpus ONCE and trees hold only ids
(`vers/src/indexes/lsh.rs:44,53`). This module keeps ONE device corpus
and makes every per-tree table an INDEX table:

- per tree: a group-major padded source map ``src`` (G·r_blk,) int32 of
  ORIGINAL corpus rows (leaves are contiguous spans of the tree's sorted
  order, so the map is built from span copies), plus the matching padded
  bin ids. ``src`` doubles as the result id map (padded position ->
  original row).
- search: multiprobe descent through every tree at once
  (``rpforest.descend_forest_flat``), then a loop over trees whose body
  (a) gathers the tree's padded corpus view from the shared corpus into
  ONE buffer that every tree reuses, (b) runs the packed scan
  (``ops/binned._fused_core``: kernel B on CUDA tensors) over it, and
  (c) folds the tree's top-k into the running answer with the id-dedup
  merge. Peak memory is corpus + one padded tree view, whatever the
  tree count.

With ``trace`` on, the descent (and the deficit gate), each tree's view
gather and each tree's fold into the running answer are stages (spans
and, on a card, markers: ``descend``, ``gather``, ``fold``, and
``forest.end`` after the last fold); the packed scan's own stages lie
between a tree's gather and its fold.

The host-side table functions are numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from vers_tpu_torch import trace
from vers_tpu_torch.core import round_up
from vers_tpu_torch.ops import rpforest
from vers_tpu_torch.ops.binned import (
    _fused_core,
    merge_probe_results,
    pack_bins,
)


def shared_tree_tables(
    lovs: Sequence[np.ndarray],     # per tree: (n,) leaf id per row
    num_buckets: Sequence[int],     # per tree: leaf count
    r_blk: int,
) -> Dict:
    """Host-side per-tree index tables for the shared-corpus search.

    Returns dict with stacked arrays (T leading axis; -1 padding):
      src      (T, G_max*r_blk) original corpus row per padded slot
      rbin     (T, G_max*r_blk) GLOBAL bin id per padded slot
      g_first  (T, G_max+1)     global-bin group boundaries
      order    (T, n_pad)       tree-sorted position -> original row
      rbin_sorted (T, n_pad)    global bin per tree-sorted position
      g_rstart (T, G_max)       tree-local sorted-row start per group
      g_max, g_total, offsets (T,), num_bins, sizes (global concat),
      max_bin
    """
    T = len(lovs)
    n = len(lovs[0]) if T else 0
    n_pad = round_up(max(n, 1), 128)
    kts = [max(int(k), 1) for k in num_buckets]
    offsets = np.concatenate([[0], np.cumsum(kts)]).astype(np.int64)
    num_bins = int(offsets[-1])

    orders, sizes_t, starts_t, firsts = [], [], [], []
    for t in range(T):
        lov = np.asarray(lovs[t], np.int64)
        order = np.argsort(lov, kind="stable").astype(np.int32)
        sizes = np.bincount(lov, minlength=kts[t]).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        orders.append(order)
        sizes_t.append(sizes)
        starts_t.append(starts)
        firsts.append(pack_bins(sizes, r_blk))
    g_max = max((len(f) - 1 for f in firsts), default=1)
    g_total = sum(len(f) - 1 for f in firsts)

    src = np.full((T, g_max * r_blk), -1, np.int32)
    rbin = np.full((T, g_max * r_blk), -1, np.int32)
    g_first = np.zeros((T, g_max + 1), np.int64)
    g_rstart = np.zeros((T, g_max), np.int64)
    order_pad = np.full((T, n_pad), -1, np.int32)
    rbin_sorted = np.full((T, n_pad), -1, np.int32)
    for t in range(T):
        order, sizes, starts, first = (
            orders[t], sizes_t[t], starts_t[t], firsts[t]
        )
        lov_sorted = (
            np.asarray(lovs[t], np.int64)[order] + offsets[t]
        ).astype(np.int32)
        order_pad[t, :n] = order
        rbin_sorted[t, :n] = lov_sorted
        G = len(first) - 1
        for g in range(G):
            lo = int(starts[first[g]]) if first[g] < kts[t] else n
            hi = int(starts[first[g + 1]]) if first[g + 1] < kts[t] else n
            span = min(hi - lo, r_blk)
            src[t, g * r_blk : g * r_blk + span] = order[lo : lo + span]
            rbin[t, g * r_blk : g * r_blk + span] = lov_sorted[lo : lo + span]
            g_rstart[t, g] = lo
        g_first[t, : G + 1] = first + offsets[t]
        g_first[t, G + 1 :] = g_first[t, G]  # pad: zero-query groups
    return dict(
        src=src,
        rbin=rbin,
        g_first=g_first.astype(np.int32),
        g_rstart=g_rstart.astype(np.int32),
        order=order_pad,
        rbin_sorted=rbin_sorted,
        g_max=g_max,
        g_total=g_total,
        offsets=offsets[:-1].astype(np.int32),
        num_bins=num_bins,
        sizes=np.concatenate(sizes_t).astype(np.int64) if T else
        np.zeros((0,), np.int64),
        max_bin=int(max((s.max() for s in sizes_t if len(s)), default=1)),
        r_blk=r_blk,
    )


def _deficit_gate(probes, sizes, num_bins: int, n_probes: int,
                  deficit_k: int):
    """Size-aware probe gating (the batched deficit/backup rule,
    `lsh.rs:203-214`): within each tree's run of ``n_probes`` ranks, a
    rank stays active while the leaves before it (sizes capped at
    ``deficit_k``) hold fewer than ``deficit_k`` rows; gated ranks
    become the sentinel bin ``num_bins``."""
    q_n = probes.shape[0]
    contrib = torch.clamp_max(sizes.to(torch.int64)[probes], deficit_k)
    c = contrib.reshape(q_n, -1, n_probes)
    before = torch.cumsum(c, dim=2) - c
    active = (before < deficit_k).reshape(q_n, -1)
    return torch.where(active, probes, num_bins)


def forest_search_shared(
    queries,        # (Q, d)
    coeff_flat, const_flat, cbase, splits, buckets, offsets,  # packed
    sizes_dev,      # (num_bins,) int32 leaf sizes (deficit gate)
    corpus_pad,     # (n_pad, d) the ONE corpus copy; its LAST row is zero
    xx,             # (n_pad,) squared norms
    src,            # (T, G_max*r_blk) int32
    rbin_pad,       # (T, G_max*r_blk) int32
    g_first,        # (T, G_max+1) int32 global-bin boundaries
    n_probes: int,
    num_bins: int,
    top_k: int,
    q_blk: int,
    r_blk: int,
    chunk: int,
    deficit_k: int = 0,
    kernel_ids: bool = True,
    plain: bool = False,
):
    """Shared-corpus forest query (counterpart of
    ``forest_search_shared_pallas``; with ``plain`` or top_k > 128 the
    scan's plain version runs on the same layout, the role
    ``forest_search_shared_xla`` has in the JAX package): descent for
    all trees, then per tree gather the padded corpus view, run the
    packed scan, dedup-merge into the running top-k. Padding slots
    (``src < 0``) gather the corpus's zero last row and carry bin -1.
    Returns (dists (Q, k) f32, original rows (Q, k) int32)."""
    n_trees = splits.shape[0]
    q_n, d = queries.shape
    dev = queries.device
    n_pad = corpus_pad.shape[0]
    # one view buffer for every tree: the trees run one after another on
    # one stream, so a tree's gather overwrites the view before it
    view = torch.empty((src.shape[1], d), dtype=corpus_pad.dtype, device=dev)
    xx_view = torch.empty((src.shape[1],), dtype=xx.dtype, device=dev)
    bd = torch.full((q_n, top_k), float("inf"), dtype=torch.float32,
                    device=dev)
    bi = torch.full((q_n, top_k), -1, dtype=torch.int32, device=dev)
    with trace.stage("descend", dev):
        probes = rpforest.descend_forest_flat(
            queries, coeff_flat, const_flat, cbase, splits, buckets, offsets,
            n_probes=n_probes,
        )
        if deficit_k:
            probes = _deficit_gate(probes, sizes_dev, num_bins, n_probes,
                                   deficit_k)
        probes = probes.reshape(q_n, n_trees, n_probes)
    for t in range(n_trees):
        with trace.stage("gather", dev):
            rows = torch.where(src[t] >= 0, src[t], n_pad - 1)
            torch.index_select(corpus_pad, 0, rows, out=view)
            torch.index_select(xx, 0, rows, out=xx_view)
        td, ti = _fused_core(
            queries, probes[:, t], view, rbin_pad[t][None, :],
            xx_view[None, :], src[t], g_first[t],
            num_bins=num_bins, nprobe=n_probes, top_k=top_k,
            q_blk=q_blk, r_blk=r_blk, chunk=chunk, metric="sq_euclidean",
            probes_given=True,
            # trees overlap and a query can probe one leaf twice: keep dedup
            dedup=True, kernel_ids=kernel_ids, plain=plain,
        )
        with trace.stage("fold", dev):
            bd, bi = merge_probe_results(
                torch.cat([bd, td], dim=1),
                torch.cat([bi, ti.to(torch.int32)], dim=1),
                top_k,
            )
    trace.mark("forest.end", dev)
    return bd, bi
