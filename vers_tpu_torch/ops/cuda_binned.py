"""Kernel B: the IVF packed binned scan, hand-written in CUDA C++ for
Hopper (``csrc/packed_scan.cu``), with its layout helpers.

Replaces ``vers_tpu/ops/pallas_binned.py:pallas_packed_scan``. What
bounds it on the H100 and how the design answers that is in the source
note at the top of the ``.cu`` file. Its plain version is
``packed_scan_plain`` below, with the same signature.

The kernel walks the work items one of two ways, with one result bit for
bit: the run walk (a block owns a run of items with one query block and
walks its groups in turn) or the split walk (a block takes one item's
group alone and writes the rows whose bins lie there). ``split_walk``
picks from shapes and the card's SM count: the split walk where the run
walk's blocks are fewer than the SMs, as for a 64-query batch whose one
query block probes nearly every group. Launches that split are counted
in ``LAUNCHES_SPLIT``.

``packed_scan_units`` mirrors either walk on the host (its blocks and
their live tiles); ``packed_scan_work`` counts from it what the kernel
issues against what counts, and ``packed_scan_tiled_plain`` follows it
in plain torch (for the tests). ``cuda_packed_scan_walk`` has the
kernel report the tiles each block walked, which holds the mirror to
the kernel.

Layout, as in the JAX package: the corpus is **group-major padded** —
group g (a run of whole bins packed to <= r_blk rows) occupies rows
[g*r_blk, g*r_blk + span_g) — and work items are (query block, group)
pairs over bin-sorted query rows. One difference: the feature axis is
not padded to 128 lanes; that padding served the TPU's vector layout
and only adds zero columns to every dot product here.

Dispatch, by the input tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.

Kernel F (``csrc/rank_merge.cu``, ``cuda_rank_merge``) is the search's
cross-probe merge after kernel B: each query's top k over the rows of
its live probe ranks, in one launch. Its plain version is
``rank_merge_plain``, the unsort, gate masks and rank-select merge the
search ran before it; its launches are counted in ``LAUNCHES_MERGE``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vers_tpu_torch import trace
from vers_tpu_torch.core import count
from vers_tpu_torch.ops import _build
from vers_tpu_torch.ops.cuda_topk import MAX_K, _sm_count, values_buffer_keys
from vers_tpu_torch.ops.topk import topk_smallest

# Launches of the CUDA kernel (one per successful launch).
LAUNCHES = 0
# ... of them, those that took the split walk (``split_walk``).
LAUNCHES_SPLIT = 0
# Scans routed to the plain version because top_k > MAX_K.
LARGE_K_PLAIN = 0
# Launches of kernel F, the cross-probe merge.
LAUNCHES_MERGE = 0
# (All move by ``core.count``: shards launch from several threads at
# once.)


def padded_group_layout(layout: Dict, r_blk: int) -> Dict:
    """Group-major padded layout: the layout's bins packed into groups
    of <= r_blk rows (``binned.static_groups``), one group table that
    every probe rank shares. Returns the padded arrays and the table
    g_first (G+1,). Cached on the layout per r_blk; a build is the span
    ``layout.padded``."""
    cache = layout.setdefault("_padded", {})
    if r_blk not in cache:
        with trace.span("layout.padded"):
            cache[r_blk] = _padded_groups(layout, r_blk)
    return cache[r_blk]


def _padded_groups(layout: Dict, r_blk: int) -> Dict:
    """`padded_group_layout`'s build."""
    from vers_tpu_torch.ops.binned import static_groups

    first, rstart = static_groups(layout, r_blk)
    n_groups = len(rstart)
    sizes = layout["sizes_host"]
    starts = layout["starts_host"]
    k = len(sizes)
    corpus = layout["corpus_sorted"]
    n_src = corpus.shape[0]
    dev = corpus.device

    # the (n_groups * r_blk,) source-row map is built on the host (group
    # tables are k-sized); the corpus is regrouped with one device gather
    src = np.full((n_groups * r_blk,), -1, np.int64)
    for g in range(n_groups):
        lo = int(rstart[g])
        hi_bin = int(first[g + 1])
        hi = int(starts[hi_bin]) if hi_bin < k else (
            int(starts[-1] + sizes[-1]) if k else 0
        )
        span = min(hi - lo, r_blk)
        src[g * r_blk : g * r_blk + span] = np.arange(lo, lo + span)
    srcd = torch.as_tensor(src, device=dev)
    live = srcd >= 0
    safe = torch.clamp(srcd, 0, max(n_src - 1, 0))
    xp = torch.where(live[:, None], corpus[safe], 0.0).contiguous()
    rb = torch.where(live, layout["rbin"][safe], -1).to(torch.int32)
    so = torch.where(live, layout["sorted_to_orig"][safe], -1).to(torch.int32)
    xx = torch.sum(xp * xp, dim=1)
    return dict(
        corpus=xp,
        rbin=rb[None, :],
        s2o=so,
        xx=xx[None, :],
        g_first=torch.as_tensor(first, device=dev),
        n_groups=n_groups,
        g_max=n_groups,
        r_blk=r_blk,
    )


def _workitems_blocks(qcounts, rank_off, g_first, q_blk: int,
                      w_rank: int, qb_scratch: int):
    """Block-aligned work items over the sorted query rows: (qb, gb)
    int32 (w_rank,) tensors. Group g's tiles are the query BLOCKS
    overlapping its sorted-query span [qlo, qhi); invalid items park on
    the scratch block."""
    dev = qcounts.device
    qcum = torch.cat([
        torch.zeros((1,), dtype=torch.int64, device=dev),
        torch.cumsum(qcounts.to(torch.int64), dim=0),
    ])
    g_first = g_first.to(torch.int64)
    qlo = qcum[g_first[:-1]] + rank_off
    qhi = qcum[g_first[1:]] + rank_off
    nq = qhi - qlo
    b0 = qlo // q_blk
    b1 = torch.where(nq > 0, (qhi - 1) // q_blk, b0 - 1)
    tiles = torch.clamp_min(b1 - b0 + 1, 0)
    tcum = torch.cumsum(tiles, dim=0)
    w = torch.arange(w_rank, dtype=torch.int64, device=dev)
    if tiles.shape[0] == 0:
        return (torch.full((w_rank,), qb_scratch, dtype=torch.int32, device=dev),
                torch.zeros((w_rank,), dtype=torch.int32, device=dev))
    total = tcum[-1]
    g = torch.searchsorted(tcum, w, right=True)
    g_c = torch.clamp(g, 0, tiles.shape[0] - 1)
    prev = torch.where(g_c > 0, tcum[torch.clamp_min(g_c - 1, 0)], 0)
    valid = w < total
    qb = torch.where(valid, b0[g_c] + (w - prev), qb_scratch)
    gb = torch.where(valid, g_c, 0)
    return qb.to(torch.int32), gb.to(torch.int32)


def packed_scan_plain(
    q_stack,        # (rows, d) bin-sorted query rows
    qbin_stack,     # (1, rows) int32 bin per row, -1 padding
    qb,             # (W,) int32 query block per work item
    gb,             # (W,) int32 group per work item
    corpus_padded,  # (G * r_blk, d) group-major padded
    rbin_padded,    # (1, G * r_blk) int32
    xx_padded,      # (1, G * r_blk) f32 squared norms
    top_k: int,
    q_blk: int,
    chunk: int,
    r_chunks: int,
    metric: str = "sq_euclidean",
    ids_padded=None,  # optional (1, G * r_blk) int32 original row ids
):
    """Plain version of kernel B: a Python loop over work items with
    the kernel's inputs, outputs, carry and tie rule. A run of
    consecutive items with one query block carries that block's best
    set; each chunk merges into it with the carried entries winning
    ties, then the lower column. Returns (res_d, res_i) over the stacked
    rows; ids are padded-corpus positions unless ``ids_padded`` is
    given. Rows no run writes stay (+inf, -1)."""
    n_rows = q_stack.shape[0]
    dev = q_stack.device
    r_blk = chunk * r_chunks
    out_d = torch.full((n_rows, top_k), float("inf"), dtype=torch.float32,
                       device=dev)
    out_i = torch.full((n_rows, top_k), -1, dtype=torch.int32, device=dev)
    qbin = qbin_stack.reshape(-1)
    rbin = rbin_padded.reshape(-1)
    xx = xx_padded.reshape(-1)
    ids = None if ids_padded is None else ids_padded.reshape(-1)
    qb_h = qb.tolist()
    gb_h = gb.tolist()
    n_w = len(qb_h)
    w = 0
    while w < n_w:
        block = qb_h[w]
        end = w + 1
        while end < n_w and qb_h[end] == block:
            end += 1
        rows = slice(block * q_blk, (block + 1) * q_blk)
        qbins = qbin[rows]
        if bool((qbins >= 0).any()):
            q = q_stack[rows].float()
            qq = torch.sum(q * q, dim=1, keepdim=True)
            best_d = torch.full((q.shape[0], top_k), float("inf"),
                                dtype=torch.float32, device=dev)
            best_i = torch.full((q.shape[0], top_k), -1, dtype=torch.int32,
                                device=dev)
            for v in range(w, end):
                for j in range(r_chunks):
                    lo = gb_h[v] * r_blk + j * chunk
                    x = corpus_padded[lo : lo + chunk].float()
                    dot = q @ x.T
                    if metric == "cosine":
                        dist = 1.0 - dot
                    else:
                        dist = torch.clamp_min(qq + xx[None, lo : lo + chunk]
                                               - 2.0 * dot, 0.0)
                    ok = (qbins[:, None] == rbin[None, lo : lo + chunk]) & (
                        qbins[:, None] >= 0
                    )
                    dist = torch.where(ok, dist, float("inf"))
                    if ids is None:
                        cid = torch.arange(lo, lo + chunk, dtype=torch.int32,
                                           device=dev)
                    else:
                        cid = ids[lo : lo + chunk]
                    cand_d = torch.cat([best_d, dist], dim=1)
                    cand_i = torch.cat(
                        [best_i, cid[None, :].expand(q.shape[0], -1)], dim=1
                    )
                    best_d, sel = topk_smallest(cand_d, top_k)
                    best_i = torch.gather(cand_i, 1, sel)
            out_d[rows] = best_d
            out_i[rows] = torch.where(torch.isfinite(best_d), best_i, -1)
        w = end
    return out_d, out_i


# Kernel B's tiles (csrc/packed_scan.cu: QT query rows, CT corpus rows)
# and the most (work item, 64-row part) units its plan orders (PLAN_MAX).
QUERY_TILE = 64
TILE_ROWS = 128
PLAN_MAX = 4096


def _host(t) -> np.ndarray:
    return (t.cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t)).reshape(-1)


def split_walk(n_rows: int, q_blk: int, sm_count: int) -> bool:
    """Whether kernel B takes the split walk for ``n_rows`` stacked query
    rows in blocks of ``q_blk`` on a card of ``sm_count`` SMs: when the
    run walk's units, one for each 64-row part of each query block, are
    fewer than the SMs. The run walk then leaves SMs idle while a few
    blocks walk long runs of groups; the split walk gives each (work
    item, part) a block of its own. A function of shapes alone, so a
    CUDA graph captures one walk."""
    return n_rows // q_blk * -(-q_blk // QUERY_TILE) < sm_count


def walk_splits(q_stack, q_blk: int) -> bool:
    """``split_walk`` for these stacked rows on their card."""
    return split_walk(q_stack.shape[0], q_blk, _sm_count(q_stack.device))


def packed_scan_units(qbin_stack, qb, gb, rbin_padded, q_blk: int, r_blk: int,
                      split: bool = False):
    """Kernel B's walk, mirrored on the host: one unit for every block of
    the kernel that does work. Returns [(row0, nq, tiles, items)]: the
    first stacked row the unit writes, its row count, the padded first
    rows of its live 128-row tiles in the order the kernel takes them
    (item order, then row order), and the item range it walks (first,
    end).

    The run walk (``split`` false): a unit is (run of consecutive work
    items with one query block, 64-row part of that block) with a live
    query row; it writes every row of the part, and a tile is live if
    one of its rows has a bin inside the part's [lowest, highest] live
    bin. The split walk: a unit is (work item, 64-row part) whose part
    has rows with bins inside the bin range of the item's group (its
    lowest and highest row bin); it writes those rows (contiguous, the
    rows being bin-sorted), and a tile is live if one of its rows has
    one of their bins."""
    qbin, qb_h, gb_h, rbin = (_host(t) for t in (qbin_stack, qb, gb,
                                                 rbin_padded))
    n_rows, n_w = qbin.shape[0], qb_h.shape[0]
    starts = np.arange(0, r_blk, TILE_ROWS)
    walks, w = [], 0
    while w < n_w:
        end = w + 1
        while end < n_w and qb_h[end] == qb_h[w]:
            end += 1
        walks += [(v, v + 1) for v in range(w, end)] if split else [(w, end)]
        w = end
    units = []
    for w, end in walks:
        block = int(qb_h[w])
        if split:
            rg = rbin[int(gb_h[w]) * r_blk : (int(gb_h[w]) + 1) * r_blk]
            if not (rg >= 0).any():
                continue
            g_lo, g_hi = rg[rg >= 0].min(), rg.max()
        for y0 in range(0, q_blk, QUERY_TILE):
            row0 = block * q_blk + y0
            nq = min(QUERY_TILE, q_blk - y0, n_rows - row0)
            if nq <= 0:
                continue
            bins = qbin[row0 : row0 + nq]
            if split:
                inside = np.flatnonzero((bins >= g_lo) & (bins <= g_hi))
                if not inside.size:
                    continue
                row0, nq = row0 + int(inside[0]), int(inside[-1] - inside[0]) + 1
                wanted = np.unique(qbin[row0 : row0 + nq])
                live = lambda rb: np.isin(rb, wanted)  # noqa: E731
            else:
                if not (bins >= 0).any():
                    continue
                lo, hi = bins[bins >= 0].min(), bins.max()
                live = lambda rb: (rb >= lo) & (rb <= hi)  # noqa: E731
            tiles = []
            for v in range(w, end):
                g0 = int(gb_h[v]) * r_blk
                hit = np.logical_or.reduceat(live(rbin[g0 : g0 + r_blk]), starts)
                tiles.extend((g0 + starts[hit]).tolist())
            units.append((row0, nq, tiles, (w, end)))
    return units


def units_walked(units, n_items: int, q_blk: int) -> np.ndarray:
    """The units of ``packed_scan_units`` as ``cuda_packed_scan_walk``
    reports them: (n_items, parts) int32, the count of live tiles of the
    block that works for (the first item of its walk, 64-row part), -1
    for every block that returns at once."""
    walked = np.full((n_items, -(-q_blk // QUERY_TILE)), -1, np.int32)
    for row0, _, tiles, (w, _) in units:
        walked[w, row0 % q_blk // QUERY_TILE] = len(tiles)
    return walked


def packed_scan_work(qbin_stack, qb, gb, rbin_padded, q_blk: int, r_blk: int,
                     split: bool = False):
    """What kernel B issues for these inputs against what counts, from
    the host mirror of its walk (the split walk if ``split``): its grid,
    the blocks that work, their live tiles, the 64 x 128 products issued
    (a tile is computed whole), the products of (query row, corpus row)
    pairs with equal bins, and the masked share 1 - useful / issued."""
    qbin, gb_h, rbin = (_host(t) for t in (qbin_stack, gb, rbin_padded))
    units = packed_scan_units(qbin_stack, qb, gb, rbin_padded, q_blk, r_blk,
                              split)
    n_bins = int(rbin.max()) + 1 if rbin.size else 0
    useful = 0
    for row0, nq, _, (w, end) in units:
        rows = np.concatenate([rbin[int(g) * r_blk : (int(g) + 1) * r_blk]
                               for g in gb_h[w:end]])
        sizes = np.bincount(rows[rows >= 0], minlength=n_bins + 1)
        bins = qbin[row0 : row0 + nq]
        useful += int(sizes[np.clip(bins[bins >= 0], 0, n_bins)].sum())
    n_tiles = [len(t) for _, _, t, _ in units]
    issued = QUERY_TILE * TILE_ROWS * sum(n_tiles)
    return dict(
        grid=[int(_host(qb).shape[0]), -(-q_blk // QUERY_TILE)],
        r_blk=r_blk, working_blocks=len(units), live_tiles=sum(n_tiles),
        max_tiles_per_block=max(n_tiles, default=0),
        issued_products=issued, useful_products=useful,
        masked_share=1.0 - useful / issued if issued else 0.0,
    )


def packed_scan_tiled_plain(
    q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded, xx_padded,
    top_k: int, q_blk: int, chunk: int, r_chunks: int,
    metric: str = "sq_euclidean", ids_padded=None, split: bool = False,
):
    """Kernel B's walk in plain torch, for the tests: each unit of
    ``packed_scan_units`` (the split walk's if ``split``) takes its live
    tiles alone, in order, carries (distance, padded position) best sets
    with the carried entries winning ties, then the lower position, and
    gathers the ids once at the end. Same result as
    ``packed_scan_plain``."""
    n_rows = q_stack.shape[0]
    dev = q_stack.device
    r_blk = chunk * r_chunks
    out_d = torch.full((n_rows, top_k), float("inf"), dtype=torch.float32,
                       device=dev)
    out_i = torch.full((n_rows, top_k), -1, dtype=torch.int32, device=dev)
    qbin = qbin_stack.reshape(-1)
    rbin = rbin_padded.reshape(-1)
    xx = xx_padded.reshape(-1)
    for row0, nq, tiles, _ in packed_scan_units(qbin_stack, qb, gb,
                                                rbin_padded, q_blk, r_blk,
                                                split):
        # products of the unit's whole 64-row part, as the kernel's tile:
        # a matmul of fewer rows may round otherwise
        p0 = row0 - row0 % q_blk % QUERY_TILE
        part = q_stack[p0 : p0 + min(QUERY_TILE, q_blk - p0 % q_blk,
                                     n_rows - p0)].float()
        mine = slice(row0 - p0, row0 - p0 + nq)
        q = part[mine]
        qbins = qbin[row0 : row0 + nq]
        qq = torch.sum(q * q, dim=1, keepdim=True)
        best_d = torch.full((nq, top_k), float("inf"), dtype=torch.float32,
                            device=dev)
        best_p = torch.full((nq, top_k), -1, dtype=torch.int32, device=dev)
        for g0 in tiles:
            nx = min(TILE_ROWS, r_blk - g0 % r_blk)
            dot = (part @ corpus_padded[g0 : g0 + nx].float().T)[mine]
            if metric == "cosine":
                dist = 1.0 - dot
            else:
                dist = torch.clamp_min(qq + xx[None, g0 : g0 + nx] - 2.0 * dot,
                                       0.0)
            ok = (qbins[:, None] == rbin[None, g0 : g0 + nx]) & (
                qbins[:, None] >= 0)
            dist = torch.where(ok, dist, float("inf"))
            pos = torch.arange(g0, g0 + nx, dtype=torch.int32, device=dev)
            best_d, sel = topk_smallest(torch.cat([best_d, dist], dim=1), top_k)
            best_p = torch.gather(
                torch.cat([best_p, pos[None, :].expand(nq, -1)], dim=1), 1, sel)
        found = torch.isfinite(best_d)
        if ids_padded is not None:
            best_p = ids_padded.reshape(-1)[torch.clamp_min(best_p, 0).long()]
        out_d[row0 : row0 + nq] = best_d
        out_i[row0 : row0 + nq] = torch.where(found, best_p, -1)
    return out_d, out_i


def _check_inputs(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
                  xx_padded, ids_padded, top_k, q_blk, r_blk):
    f32 = dict(q_stack=q_stack, corpus_padded=corpus_padded,
               xx_padded=xx_padded)
    i32 = dict(qbin_stack=qbin_stack, qb=qb, gb=gb, rbin_padded=rbin_padded)
    if ids_padded is not None:
        i32["ids_padded"] = ids_padded
    dev = q_stack.device
    for want, group in ((torch.float32, f32), (torch.int32, i32)):
        for name, t in group.items():
            if not t.is_cuda or t.device != dev:
                raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                                 f"got {t.device}")
            if t.dtype != want:
                raise TypeError(f"{name} must be {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    n_rows, d = q_stack.shape
    n_corpus = corpus_padded.shape[0]
    if corpus_padded.ndim != 2 or corpus_padded.shape[1] != d:
        raise ValueError(f"corpus_padded must be (G*r_blk, {d}), got "
                         f"{tuple(corpus_padded.shape)}")
    if r_blk <= 0 or n_corpus % r_blk:
        raise ValueError(f"corpus rows {n_corpus} not a multiple of r_blk {r_blk}")
    if q_blk <= 0 or n_rows % q_blk:
        raise ValueError(f"query rows {n_rows} not a multiple of q_blk {q_blk}")
    if qbin_stack.numel() != n_rows:
        raise ValueError("qbin_stack must hold one bin per query row")
    for name, t in (("rbin_padded", rbin_padded), ("xx_padded", xx_padded),
                    ("ids_padded", ids_padded)):
        if t is not None and t.numel() != n_corpus:
            raise ValueError(f"{name} must hold one entry per corpus row")
    if qb.ndim != 1 or qb.shape != gb.shape:
        raise ValueError("qb and gb must be (W,) of one length")
    if not 1 <= top_k <= MAX_K:
        raise ValueError(f"kernel takes 1 <= top_k <= {MAX_K}, got {top_k}")
    if max(n_rows, n_corpus) >= 2**31:
        raise ValueError("row counts must fit the kernel's int32 sizes")


def check_work_items(qb, gb, n_rows: int, q_blk: int, n_corpus: int,
                     r_blk: int) -> None:
    """Raise unless every work item names a query block of the stacked
    rows and a group of the padded corpus. Reading the bounds syncs with
    the device, so the search path does not call this: ``_workitems_blocks``
    builds items in range by construction. Tests and the smoke run call it
    on the items they hand to the kernel."""
    if not qb.numel():
        return
    lo_q, hi_q, lo_g, hi_g = torch.stack(
        [qb.min(), qb.max(), gb.min(), gb.max()]).tolist()
    if lo_q < 0 or hi_q >= n_rows // q_blk:
        raise ValueError(f"qb outside [0, {n_rows // q_blk})")
    if lo_g < 0 or hi_g >= n_corpus // r_blk:
        raise ValueError(f"gb outside [0, {n_corpus // r_blk})")


def cuda_packed_scan(
    q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded, xx_padded,
    top_k: int, q_blk: int, chunk: int, r_chunks: int,
    metric: str = "sq_euclidean", ids_padded=None,
):
    """Kernel B with ``pallas_packed_scan``'s signature (less
    ``interpret``). CUDA tensors launch the kernel; CPU tensors take
    ``packed_scan_plain``. Returns (res_d, res_i) over the stacked
    query rows, prefilled with (+inf, -1) so rows without a run read as
    empty. Device, dtypes, shapes and contiguity are checked here; the
    values of ``qb``/``gb`` are not (that needs a device sync) and must
    be in range, as ``check_work_items`` verifies."""
    if metric not in ("sq_euclidean", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    if not q_stack.is_cuda:
        return packed_scan_plain(
            q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
            xx_padded, top_k, q_blk, chunk, r_chunks,
            metric=metric, ids_padded=ids_padded,
        )
    return _launch(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
                   xx_padded, top_k, q_blk, chunk * r_chunks, metric,
                   ids_padded, None, None)


def cuda_packed_scan_walk(
    q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded, xx_padded,
    top_k: int, q_blk: int, chunk: int, r_chunks: int,
    metric: str = "sq_euclidean", ids_padded=None, split=None,
):
    """Kernel B reporting its walk: (res_d, res_i, walked), walked
    (W, parts) int32 with the count of live tiles each block walked and
    -1 for the blocks that returned at once (no row to write, or, in the
    run walk, not the first item of a run). ``split``: None takes the
    walk ``split_walk`` picks; True or False forces the split or the
    run walk, for the tests and the timing tools, which hold
    ``packed_scan_units`` to the report. CPU tensors take the plain
    version and the host mirror's count (the run walk's unless
    ``split``)."""
    if metric not in ("sq_euclidean", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    if not q_stack.is_cuda:
        out = packed_scan_plain(
            q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
            xx_padded, top_k, q_blk, chunk, r_chunks,
            metric=metric, ids_padded=ids_padded)
        units = packed_scan_units(qbin_stack, qb, gb, rbin_padded, q_blk,
                                  chunk * r_chunks, bool(split))
        return (*out, torch.from_numpy(units_walked(units, qb.shape[0], q_blk)))
    walked = torch.full((qb.shape[0], -(-q_blk // QUERY_TILE)), -1,
                        dtype=torch.int32, device=q_stack.device)
    out = _launch(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
                  xx_padded, top_k, q_blk, chunk * r_chunks, metric,
                  ids_padded, walked, split)
    return (*out, walked)


def kernel_constants() -> Dict[str, int]:
    """QUERY_TILE, TILE_ROWS and PLAN_MAX as the built kernel has them."""
    import ctypes

    out = (ctypes.c_int * 3)()
    lib = _build.load_library()
    _build.check(lib, lib.vers_packed_scan_constants(out),
                 "vers_packed_scan_constants")
    return dict(QUERY_TILE=out[0], TILE_ROWS=out[1], PLAN_MAX=out[2])


def _launch(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
            xx_padded, top_k, q_blk, r_blk, metric, ids_padded, walked, split):
    _check_inputs(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
                  xx_padded, ids_padded, top_k, q_blk, r_blk)
    n_rows, d = q_stack.shape
    dev = q_stack.device
    if split is None:
        split = walk_splits(q_stack, q_blk)
    out_d = torch.full((n_rows, top_k), float("inf"), dtype=torch.float32,
                       device=dev)
    out_i = torch.full((n_rows, top_k), -1, dtype=torch.int32, device=dev)
    # scratch of the kernel's plan (heavy blocks first): 64-bit sort keys
    # and the order, per (work item, 64-row part)
    n_w = qb.shape[0]
    units = n_w * -(-q_blk // QUERY_TILE)
    plan = (torch.empty((3 * units,), dtype=torch.int32, device=dev)
            if units <= PLAN_MAX else None)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.vers_packed_scan(
            q_stack.data_ptr(), qbin_stack.data_ptr(), qb.data_ptr(),
            gb.data_ptr(), corpus_padded.data_ptr(), rbin_padded.data_ptr(),
            xx_padded.data_ptr(),
            None if ids_padded is None else ids_padded.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            None if plan is None else plan.data_ptr(),
            None if walked is None else walked.data_ptr(),
            n_rows, corpus_padded.shape[0], d, n_w, q_blk, r_blk, top_k,
            int(metric == "cosine"), int(split),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_packed_scan")
    count(globals(), "LAUNCHES")
    if split:
        count(globals(), "LAUNCHES_SPLIT")
    return out_d, out_i


def scans_on_host(top_k: int, plain: bool = False) -> bool:
    """Whether ``packed_scan`` takes the plain version, which reads its
    work items on the host (``plain``, or top_k > MAX_K): a search that
    does cannot be captured in a CUDA graph (``graphs``)."""
    return plain or top_k > MAX_K


def packed_scan(*args, plain: bool = False, **kwargs):
    """The packed scan as the search path calls it: kernel B through
    ``cuda_packed_scan``, or the plain version when ``plain`` is set or
    top_k > MAX_K (the JAX package's kernel limit, kept and counted in
    ``LARGE_K_PLAIN``)."""
    top_k = kwargs["top_k"]
    if top_k > MAX_K:
        count(globals(), "LARGE_K_PLAIN")
    if scans_on_host(top_k, plain):
        return packed_scan_plain(*args, **kwargs)
    return cuda_packed_scan(*args, **kwargs)


def rank_merge_plain(res_d, res_i, inv, probes, s2o_padded, num_bins: int,
                     top_k: int, kernel_ids: bool = False, dedup: bool = False):
    """Plain version of kernel F: the binned search's merge stage as
    plain torch ops. Unsort kernel B's rows ``res_d``/``res_i`` (stacked
    pairs) to (query, rank) order through ``inv`` ((p*Q,) int64: the
    stacked row of pair (rank r, query q) at r*Q + q), mask the ranks
    whose ``probes`` ((Q, p) int64) entry is the sentinel ``num_bins``,
    take the ids as they are (``kernel_ids``) or map padded positions
    through ``s2o_padded``, and merge the p ranks to each query's top_k
    (``binned.merge_probe_results``; ``dedup`` drops repeated ids, for
    ranks that may overlap). At p = 1 the scan's row is the answer.
    Returns (dists (Q, top_k) f32, ids (Q, top_k) int32)."""
    from vers_tpu_torch.ops.binned import merge_probe_results

    q_n, p = probes.shape
    # q-major inverse gather: output row q*p + r is pair (r, q), so
    # the (p, q, k) -> (q, p*k) transpose is a reshape
    idx_qm = inv.reshape(p, q_n).T.reshape(-1)
    dd = res_d[idx_qm]
    pos = res_i[idx_qm]
    live = (probes < num_bins).reshape(-1)[:, None]
    dd = torch.where(live, dd, float("inf"))
    if kernel_ids:
        ii = torch.where(live & (pos >= 0), pos, -1)
    else:
        ii = torch.where(
            live & (pos >= 0),
            s2o_padded[torch.clamp_min(pos, 0).to(torch.int64)], -1,
        )
    out = dd.reshape(q_n, p * top_k), ii.reshape(q_n, p * top_k)
    if p > 1:
        # a single probe needs no merge: the scan already emits each
        # query's top_k in ascending order with distinct ids
        out = merge_probe_results(*out, top_k, dedup=dedup)
    return out


def _check_merge_inputs(res_d, res_i, inv, probes, s2o_padded, top_k,
                        kernel_ids):
    dev = res_d.device
    want = dict(res_d=(res_d, torch.float32), res_i=(res_i, torch.int32),
                inv=(inv, torch.int64), probes=(probes, torch.int64))
    if not kernel_ids:
        want["s2o_padded"] = (s2o_padded, torch.int32)
    for name, (t, dtype) in want.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        # probes may be a slice of wider rows (the probe stage's top-p)
        rows_apart = name == "probes" and t.ndim == 2 and t.stride(1) == 1 \
            and t.stride(0) >= t.shape[1]
        if not (t.is_contiguous() or rows_apart):
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= top_k <= MAX_K:
        raise ValueError(f"kernel takes 1 <= top_k <= {MAX_K}, got {top_k}")
    if res_d.ndim != 2 or res_d.shape[1] != top_k or res_i.shape != res_d.shape:
        raise ValueError(f"res_d and res_i must be (rows, {top_k}), got "
                         f"{tuple(res_d.shape)} and {tuple(res_i.shape)}")
    if probes.ndim != 2 or inv.shape != (probes.numel(),):
        raise ValueError(f"probes must be (Q, p) and inv (p*Q,), got "
                         f"{tuple(probes.shape)} and {tuple(inv.shape)}")
    if not kernel_ids and s2o_padded.ndim != 1:
        raise ValueError("s2o_padded must be one id per padded corpus row")
    if max(probes.shape[0], probes.stride(0), probes.shape[1] * top_k) >= 2**31:
        raise ValueError("Q, p*top_k and the probes' row stride must fit the "
                         "kernel's int32 sizes")


def cuda_rank_merge(res_d, res_i, inv, probes, s2o_padded, num_bins: int,
                    top_k: int, kernel_ids: bool = False):
    """Kernel F: the merge of ``rank_merge_plain`` for disjoint probe
    ranks (no dedup), one launch; the same results bit for bit.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Devices, dtypes, shapes and contiguity are checked here; the values
    of ``inv`` are not (that needs a device sync) and must name rows of
    ``res_d``, as the search's pair sort makes them."""
    if not res_d.is_cuda:
        return rank_merge_plain(res_d, res_i, inv, probes, s2o_padded,
                                num_bins, top_k, kernel_ids)
    _check_merge_inputs(res_d, res_i, inv, probes, s2o_padded, top_k,
                        kernel_ids)
    q_n, p = probes.shape
    dev = res_d.device
    out_d = torch.empty((q_n, top_k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, top_k), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.vers_rank_merge(
            res_d.data_ptr(), res_i.data_ptr(), inv.data_ptr(),
            probes.data_ptr(), None if kernel_ids else s2o_padded.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), q_n, p, probes.stride(0),
            top_k, values_buffer_keys(top_k), num_bins,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_rank_merge")
    count(globals(), "LAUNCHES_MERGE")
    return out_d, out_i
