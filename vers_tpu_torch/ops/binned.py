"""Binned (bucketed) dense search — the engine behind IVFFlat's cluster
probe (counterpart of the parts of ``vers_tpu.ops.binned`` that the IVF
path runs).

The corpus is stored **bin-major** (rows sorted so each bin — k-means
cluster — is one contiguous row range). Queries are probed, paired with
their probed bins, bin-sorted, and scanned by the packed-scan kernel
(``ops/cuda_binned.py``) against whole-bin corpus groups under a
bin-equality mask; the per-probe results are unsorted and merged.

Layouts are dicts of tensors on the corpus's device plus small numpy
tables for tile planning, with the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import numpy as np
import torch

from vers_tpu_torch import graphs, trace
from vers_tpu_torch.core import SHARD_STATE, round_up
from vers_tpu_torch.ops.cuda_binned import (
    _workitems_blocks,
    cuda_rank_merge,
    packed_scan,
    padded_group_layout,
    rank_merge_plain,
    scans_on_host,
)
from vers_tpu_torch.ops.distance import pairwise_distance
from vers_tpu_torch.ops.topk import repeats_earlier, topk_smallest


@contextlib.contextmanager
def captured_scans(only=None, shard=None):
    """Record every packed-scan call the search path makes inside the
    block as (args, kwargs less ``plain``), the arguments
    ``cuda_packed_scan`` and ``packed_scan_plain`` take; the calls
    themselves go through unchanged, eagerly (``graphs.disabled``: a
    replayed graph makes no calls, and a capture's arguments live in its
    pool). For the tests and the timing tools.

    ``only``: ordinals (from 0) of the calls to record, with their tensor
    arguments copied. The forest search scans every tree out of one view
    buffer, so a later tree overwrites what an earlier call was given,
    and eight views of a large corpus are too much to keep.

    ``shard``: record only the calls made by shard ``shard``'s body under
    ``parallel.mesh.map_shards`` (``only`` then counts that shard's
    calls): the shards scan at once, from threads of their own."""
    global packed_scan
    calls = []
    scan = packed_scan
    seen = 0
    lock = threading.Lock()

    def keep(v):
        return v.clone() if only is not None and isinstance(v, torch.Tensor) else v

    def record(*args, **kw):
        nonlocal seen
        if shard is None or getattr(SHARD_STATE, "shard", None) == shard:
            with lock:
                n, seen = seen, seen + 1
            if only is None or n in only:
                call = (tuple(keep(a) for a in args),
                        {k: keep(v) for k, v in kw.items() if k != "plain"})
                with lock:
                    calls.append(call)
        return scan(*args, **kw)

    packed_scan = record
    try:
        with graphs.disabled():
            yield calls
    finally:
        packed_scan = scan


def make_layout(values: np.ndarray, bin_ids: np.ndarray, num_bins: int,
                device=None) -> Dict:
    """Build a bin-major layout on ``device`` (the CPU when None) from
    (n, d) host values and their (n,) bin assignments. Returns a dict
    with corpus_sorted (n_pad, d), sorted_to_orig (n_pad,), start
    (num_bins,), size (num_bins,), rbin (n_pad,), their host tables and
    max_bin (python int)."""
    values = np.asarray(values, dtype=np.float32)
    bin_ids = np.asarray(bin_ids)
    n = values.shape[0]
    order = np.argsort(bin_ids[:n], kind="stable")
    sizes = np.bincount(bin_ids[:n], minlength=num_bins).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    n_pad = round_up(max(n, 1), 128)
    corpus_sorted = np.pad(values[order], ((0, n_pad - n), (0, 0)))
    sorted_to_orig = np.full((n_pad,), -1, np.int32)
    sorted_to_orig[:n] = order.astype(np.int32)
    rbin = np.full((n_pad,), -1, np.int32)
    rbin[:n] = np.repeat(np.arange(num_bins, dtype=np.int32), sizes)
    dev = device if device is not None else "cpu"
    return dict(
        corpus_sorted=torch.as_tensor(corpus_sorted, device=dev),
        sorted_to_orig=torch.as_tensor(sorted_to_orig, device=dev),
        start=torch.as_tensor(starts, device=dev),
        size=torch.as_tensor(sizes, device=dev),
        rbin=torch.as_tensor(rbin, device=dev),
        sizes_host=sizes,
        starts_host=starts,
        max_bin=int(sizes.max()) if n else 1,
        num_bins=num_bins,
    )


def make_layout_device(values_dev: torch.Tensor, bin_ids_dev: torch.Tensor,
                       num_bins: int, n_valid: int) -> Dict:
    """``make_layout`` for a device-resident (n_pad, d) corpus: the
    corpus never leaves its device (only the (num_bins,) size vector is
    copied to the host for tile planning). ``bin_ids_dev`` is (n_pad,);
    entries >= n_valid are ignored."""
    n_pad = values_dev.shape[0]
    dev = values_dev.device
    rows = torch.arange(n_pad, device=dev)
    # padding rows sort last as pseudo-bin num_bins
    ids = torch.where(rows < n_valid, bin_ids_dev.to(torch.int64), num_bins)
    order = torch.argsort(ids, stable=True)
    corpus_sorted = values_dev[order]
    ids_sorted = ids[order]
    sizes = torch.bincount(ids, minlength=num_bins + 1)[:num_bins].to(torch.int32)
    starts = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(sizes, dim=0)[:-1].to(torch.int32),
    ])
    rbin = torch.where(ids_sorted == num_bins, -1, ids_sorted).to(torch.int32)
    sorted_to_orig = torch.where(rbin >= 0, order, -1).to(torch.int32)
    sizes_host = sizes.cpu().numpy()
    starts_host = np.concatenate([[0], np.cumsum(sizes_host)[:-1]]).astype(
        np.int32
    )
    return dict(
        corpus_sorted=corpus_sorted,
        sorted_to_orig=sorted_to_orig,
        start=starts,
        size=sizes,
        rbin=rbin,
        sizes_host=sizes_host,
        starts_host=starts_host,
        max_bin=int(sizes_host.max()) if n_valid else 1,
        num_bins=num_bins,
    )


def slacken_layout(layout: Dict, min_slack: int = 8, frac: int = 8) -> Dict:
    """Rebuild a bin-major layout with per-bin slack capacity so
    incremental inserts become in-place writes (the IVFFlat ``add`` fast
    path; the reference's add is one Vec push, `ivfflat.rs:200-213`).
    One scatter moves every live row to its capacity slot, on the
    layout's device.

    Conventions of a slacked layout:
    - ``sizes_host``/``starts_host``/``max_bin`` describe the CAPACITY
      footprint (what tile packing must span; slack rows carry
      rbin = -1 and are invisible to the scan's bin-equality mask),
    - ``true_sizes_host`` / ``size`` (device) hold the occupied sizes
      (what adaptive probing must see)."""
    true_sizes = np.asarray(
        layout.get("true_sizes_host", layout["sizes_host"]), np.int64
    )
    caps = true_sizes + np.maximum(min_slack, true_sizes // frac)
    cap_starts = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
    cap_total = round_up(int(caps.sum()), 128)
    corpus = layout["corpus_sorted"]
    dev = corpus.device
    rbin_old = layout["rbin"]
    n_old = corpus.shape[0]
    starts_old = torch.as_tensor(
        np.asarray(layout["starts_host"], np.int64), device=dev
    )
    capd = torch.as_tensor(cap_starts.astype(np.int64), device=dev)
    live = rbin_old >= 0
    rb_safe = torch.clamp_min(rbin_old.to(torch.int64), 0)
    tgt = (capd[rb_safe] + torch.arange(n_old, device=dev) - starts_old[rb_safe])[live]
    new_corpus = torch.zeros((cap_total, corpus.shape[1]), dtype=corpus.dtype,
                             device=dev)
    new_corpus[tgt] = corpus[live]
    new_rbin = torch.full((cap_total,), -1, dtype=torch.int32, device=dev)
    new_rbin[tgt] = rbin_old[live]
    new_s2o = torch.full((cap_total,), -1, dtype=torch.int32, device=dev)
    new_s2o[tgt] = layout["sorted_to_orig"][live]
    return dict(
        corpus_sorted=new_corpus,
        sorted_to_orig=new_s2o,
        start=torch.as_tensor(cap_starts, device=dev),
        size=torch.as_tensor(true_sizes.astype(np.int32), device=dev),
        rbin=new_rbin,
        sizes_host=caps.astype(np.int32),
        starts_host=cap_starts,
        true_sizes_host=true_sizes.astype(np.int32),
        caps_host=caps.astype(np.int32),
        max_bin=int(caps.max()) if caps.size else 1,
        num_bins=layout["num_bins"],
        slacked=True,
    )


def layout_insert(layout: Dict, row_vec, bin_c: int, orig_row: int) -> bool:
    """In-place insert of one row into bin ``bin_c`` of a slacked layout.
    Returns False when the bin's slack is exhausted — the caller
    rebuilds with fresh slack. The cached group-major padded copy is
    dropped; it rebuilds with one device gather on the next search."""
    if not layout.get("slacked"):
        raise ValueError("layout_insert requires a slacken_layout layout")
    c = int(bin_c)
    true_sizes = layout["true_sizes_host"]
    if true_sizes[c] >= layout["caps_host"][c]:
        return False
    pos = int(layout["starts_host"][c]) + int(true_sizes[c])
    corpus = layout["corpus_sorted"]
    corpus[pos] = torch.as_tensor(
        np.asarray(row_vec, dtype=np.float32).reshape(-1), dtype=corpus.dtype
    ).to(corpus.device)
    layout["rbin"][pos] = c
    layout["sorted_to_orig"][pos] = int(orig_row)
    layout["size"][c] += 1
    true_sizes[c] += 1
    layout.pop("_padded", None)
    return True


def pack_bins(sizes: np.ndarray, r_blk: int) -> np.ndarray:
    """Greedy pack consecutive whole bins into groups of <= r_blk rows.
    Returns (G+1,) int64 bin boundaries; bins larger than r_blk get a
    group of their own (callers size r_blk >= max_bin)."""
    first = [0]
    used = 0
    for c, s in enumerate(sizes):
        if used and used + int(s) > r_blk:
            first.append(c)
            used = 0
        used += int(s)
    first.append(len(sizes))
    return np.asarray(first, np.int64)


def static_groups(layout: Dict, r_blk: int):
    """Pack the layout's bins into groups of <= r_blk corpus rows
    (``pack_bins``), from its bin sizes alone. Returns numpy arrays
    (group_first_bin (G+1,), group_rstart (G,))."""
    first = pack_bins(layout["sizes_host"], r_blk).astype(np.int32)
    return first, np.asarray(layout["starts_host"], np.int32)[first[:-1]]


def _rank_select_topk(all_d: torch.Tensor, all_i: torch.Tensor, top_k: int):
    """Sort-free top-k over a small width w: each column's merged rank
    is its count of strictly-smaller (or equal-and-earlier) columns.
    Output is ascending with (inf, -1) padding; ties break by column
    index (probe-rank order), as in the JAX package."""
    q_n, w = all_d.shape
    dev = all_d.device
    col = torch.arange(w, device=dev)
    earlier = col[None, :] < col[:, None]  # [j, j'] = j' < j
    a = all_d[:, :, None]   # d[j]  (Q, w, 1)
    b = all_d[:, None, :]   # d[j'] (Q, 1, w)
    beats = (b < a) | ((b == a) & earlier[None])
    rank = beats.sum(dim=2)
    rank = torch.where(torch.isfinite(all_d), rank, w)  # park inf: dropped
    # ranks are distinct below w; ranks >= top_k land in a dump column
    slot = torch.clamp_max(rank, top_k)
    fin_d = torch.full((q_n, top_k + 1), float("inf"), dtype=all_d.dtype,
                       device=dev)
    fin_i = torch.full((q_n, top_k + 1), -1, dtype=all_i.dtype, device=dev)
    fin_d.scatter_(1, slot, all_d)
    fin_i.scatter_(1, slot, all_i)
    fin_d, fin_i = fin_d[:, :top_k], fin_i[:, :top_k]
    return fin_d, torch.where(torch.isfinite(fin_d), fin_i, -1)


def merge_probe_results(all_d: torch.Tensor, all_i: torch.Tensor, top_k: int,
                        dedup: bool = True):
    """Merge (Q, P*top_k) candidates from P probes: drop duplicate ids
    (``dedup``), then the final top-k. Returns (dists (Q, top_k), ids
    (Q, top_k)).

    ``dedup=False`` is correct whenever the probe ranks cover DISJOINT
    id sets (IVF: each row lives in exactly one cluster and a query's
    probes are distinct clusters)."""
    q_n, w = all_d.shape
    if dedup:
        dup = repeats_earlier(all_i) & (all_i >= 0)
        all_d = torch.where(dup, float("inf"), all_d)
    if w <= 64:
        return _rank_select_topk(all_d, all_i, top_k)
    if top_k <= 32 and w % top_k == 0:
        # tournament of batched pairwise rank-selects: the top-k of a
        # union is the top-k of the halves' top-ks, so fold rank pairs
        # (Q, p*k) -> (Q*p/2, 2k) -> (Q, p/2*k) until one select fits
        p = w // top_k
        while p > 1 and p * top_k > 64:
            if p % 2:
                all_d = torch.nn.functional.pad(all_d, (0, top_k),
                                                value=float("inf"))
                all_i = torch.nn.functional.pad(all_i, (0, top_k), value=-1)
                p += 1
            all_d, all_i = _rank_select_topk(
                all_d.reshape(q_n * p // 2, 2 * top_k),
                all_i.reshape(q_n * p // 2, 2 * top_k),
                top_k,
            )
            p //= 2
            all_d = all_d.reshape(q_n, p * top_k)
            all_i = all_i.reshape(q_n, p * top_k)
        if p == 1:
            return all_d, all_i
        return _rank_select_topk(all_d, all_i, top_k)
    fin_d, sel = topk_smallest(all_d, top_k)
    fin_i = torch.gather(all_i, 1, sel)
    return fin_d, torch.where(torch.isfinite(fin_d), fin_i, -1)


def bin_counts(bins: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(num_bins,) int64 count of each bin in ``bins`` (int64, values in
    [0, num_bins]: the sentinel bin ``num_bins`` of gated ranks falls off
    the count). A fixed-size scatter of ones, as the JAX package counts
    (``zeros.at[bins].add(1)``): unlike ``torch.bincount``, which reads
    the maximum on the host, it enqueues without waiting for the card.
    Integer atomics are exact, so the counts are ``bincount``'s."""
    counts = torch.zeros((num_bins + 1,), dtype=torch.int64, device=bins.device)
    counts.index_add_(0, bins, torch.ones_like(bins))
    return counts[:num_bins]


def adaptive_probe_depth(sizes: np.ndarray, top_k: int) -> int:
    """Worst-case probe depth of the reference's adaptive cluster walk
    (`ivfflat.rs:166-195`): each probed bin contributes min(size, top_k)
    candidates and the walk stops at top_k total, so no query needs more
    probes than the SMALLEST contributions take to reach top_k."""
    caps = np.minimum(np.asarray(sizes, np.int64), top_k)
    cum = np.cumsum(np.sort(caps))  # ascending = adversarial ordering
    hit = np.nonzero(cum >= top_k)[0]
    if len(hit) == 0:
        return max(len(caps), 1)  # corpus smaller than top_k: probe all
    return int(hit[0]) + 1


def adaptive_probes(queries, centroids, sizes, num_bins: int, p_max: int,
                    top_k: int, metric: str = "sq_euclidean"):
    """Per-query adaptive probe selection (the batched analogue of the
    reference's walk): rank bins nearest-first, keep probing while the
    running candidate count (bin sizes capped at top_k) is still short
    of top_k. Inactive ranks are set to the sentinel bin ``num_bins``,
    which the packed scan's bin-equality mask ignores. Returns (Q, p_max)
    int32."""
    cdist = pairwise_distance(queries, centroids, metric)
    _, probes = topk_smallest(cdist, min(p_max, num_bins))
    contrib = torch.clamp_max(sizes.to(torch.int64)[probes], top_k)
    before = torch.cumsum(contrib, dim=1) - contrib  # exclusive cumsum
    active = before < top_k
    return torch.where(active, probes, num_bins).to(torch.int32)


def _fused_core(
    queries, centroids_or_probes, corpus_padded, rbin_padded, xx_padded,
    s2o_padded, g_first,
    num_bins: int, nprobe: int, top_k: int, q_blk: int, r_blk: int,
    chunk: int, metric: str, probes_given: bool, dedup: bool = True,
    kernel_ids: bool = False, plain: bool = False,
):
    """Binned search on the packed scan (counterpart of
    ``vers_tpu.ops.binned._pallas_fused_core``): probe, sort every
    (query, rank) pair into one bin ordering, build work items over the
    one group table ``g_first`` (G+1,), scan, unsort, mask gated ranks
    and merge. Each corpus group is visited once across all ranks.
    ``plain`` runs the scan's plain version. The merge is kernel F
    (``cuda_rank_merge``) where kernel B ran on the card, p > 1 and the
    ranks are disjoint (``dedup`` false), else ``rank_merge_plain``.

    The tile plan follows from the shapes: the p*Q pairs are padded to
    p runs of Q rows rounded up to ``q_blk``, plus one scratch block
    where invalid work items park, and the work items are one per
    stacked block plus one per group and one more.

    With ``trace`` on, the stages probe (unless the probes are given),
    sort (pairs, work items), scan (kernel B) and merge (the inverse
    pair order, then kernel F or the plain merge) are spans and, on a
    card, each opens with its marker; the marker ``end`` closes the
    last."""
    q_n = queries.shape[0]
    dev = queries.device
    if probes_given:
        probes = centroids_or_probes.to(torch.int64)
    else:
        with trace.stage("probe", dev):
            cdist = pairwise_distance(queries, centroids_or_probes, metric)
            probes = topk_smallest(cdist, nprobe)[1].to(torch.int64)
    p = probes.shape[1]
    pq = p * q_n
    rows_pad = p * round_up(q_n, q_blk)
    with trace.stage("sort", dev):
        # rank-major pair index i = r*q_n + q; a stable sort keeps
        # pairs of one bin in pair order
        bins_flat = probes.T.reshape(-1)
        order = torch.argsort(bins_flat, stable=True)
        qidx = torch.remainder(order, q_n)
        tail = rows_pad - pq + q_blk  # pad + scratch block
        q_stack = torch.nn.functional.pad(queries[qidx], (0, 0, 0, tail))
        qbin_stack = torch.nn.functional.pad(
            bins_flat[order].to(torch.int32), (0, tail), value=-1
        )[None, :]
        counts = bin_counts(bins_flat, num_bins)
        qb, gb = _workitems_blocks(
            counts, 0, g_first, q_blk, rows_pad // q_blk + g_first.shape[-1],
            rows_pad // q_blk,
        )
    with trace.stage("scan", dev):
        res_d, res_i = packed_scan(
            q_stack.contiguous(), qbin_stack.contiguous(), qb, gb,
            corpus_padded, rbin_padded, xx_padded, top_k=top_k, q_blk=q_blk,
            chunk=chunk, r_chunks=r_blk // chunk, metric=metric,
            ids_padded=s2o_padded[None, :] if kernel_ids else None,
            plain=plain,
        )
    with trace.stage("merge", dev):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(pq, device=dev)
        args = (res_d, res_i, inv, probes, s2o_padded, num_bins, top_k,
                kernel_ids)
        # kernel F where kernel B ran and the ranks are disjoint; ranks
        # that may overlap (the forest's trees) keep the dedup merge
        if (p > 1 and not dedup and res_d.is_cuda
                and not scans_on_host(top_k, plain)):
            out = cuda_rank_merge(*args)
        else:
            out = rank_merge_plain(*args, dedup=dedup)
    trace.mark("end", dev)
    return out


def binned_topk_kernel(
    queries: torch.Tensor,
    centroids,
    nprobe: int,
    layout: Dict,
    top_k: int,
    metric: str = "sq_euclidean",
    probes=None,
    q_blk: int | None = None,
    r_blk: int | None = None,
    chunk: int | None = None,
    dedup: bool = True,
    kernel_ids: bool = True,
    plain: bool = False,
):
    """Binned search on the packed-scan kernel path (counterpart of
    ``vers_tpu.ops.binned.binned_topk_pallas``, same tile defaults).
    Exact top-k over the probed bins; tie order may differ from other
    engines. ``kernel_ids``: the scan writes original ids instead of
    padded positions. ``plain``: run the scan's plain version."""
    p = nprobe if probes is None else int(probes.shape[1])
    padded, plan = kernel_plan(layout, top_k, q_blk=q_blk, r_blk=r_blk,
                               chunk=chunk)
    return _fused_core(
        queries,
        centroids if probes is None else probes,
        padded["corpus"], padded["rbin"], padded["xx"], padded["s2o"],
        padded["g_first"],
        num_bins=layout["num_bins"], nprobe=p, top_k=top_k, metric=metric,
        probes_given=probes is not None, dedup=dedup, kernel_ids=kernel_ids,
        plain=plain, **plan,
    )


def group_rows(max_bin: int, top_k: int, chunk: int,
               r_blk: int | None = None) -> int:
    """Rows of one corpus group of the packed scan: at least ``r_blk``
    (1024 when None), the largest bin and top_k, rounded up to whole
    chunks."""
    return round_up(max(1024 if r_blk is None else r_blk, max_bin, top_k),
                    chunk)


def kernel_plan(layout: Dict, top_k: int, q_blk: int | None = None,
                r_blk: int | None = None, chunk: int | None = None):
    """The tiles of ``binned_topk_kernel``: (the layout's group-major
    padded corpus, built on the first call and cached on the layout; the
    tile sizes ``_fused_core`` takes). Host work only once the padded
    corpus exists."""
    chunk = 1024 if chunk is None else chunk
    r_blk = group_rows(layout["max_bin"], top_k, chunk, r_blk)
    return padded_group_layout(layout, r_blk), dict(
        q_blk=128 if q_blk is None else q_blk, r_blk=r_blk, chunk=chunk)
