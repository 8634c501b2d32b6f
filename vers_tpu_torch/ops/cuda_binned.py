"""Kernel B: the IVF packed binned scan, hand-written in CUDA C++ for
Hopper (``csrc/packed_scan.cu``), with its layout helpers.

Replaces ``vers_tpu/ops/pallas_binned.py:pallas_packed_scan``. What
bounds it on the H100 and how the design answers that is in the source
note at the top of the ``.cu`` file. Its plain version is
``packed_scan_plain`` below, with the same signature.
``packed_scan_units`` mirrors the kernel's walk on the host (its blocks
and their live tiles); ``packed_scan_work`` counts from it what the
kernel issues against what counts, and ``packed_scan_tiled_plain``
follows it in plain torch (for the tests). ``cuda_packed_scan_walk``
has the kernel report the tiles each block walked, which holds the
mirror to the kernel.

Layout, as in the JAX package: the corpus is **group-major padded** —
group g (a run of whole bins packed to <= r_blk rows) occupies rows
[g*r_blk, g*r_blk + span_g) — and work items are (query block, group)
pairs over bin-sorted query rows. One difference: the feature axis is
not padded to 128 lanes; that padding served the TPU's vector layout
and only adds zero columns to every dot product here.

Dispatch, by the input tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vers_tpu_torch import trace
from vers_tpu_torch.core import count
from vers_tpu_torch.ops import _build
from vers_tpu_torch.ops.cuda_topk import MAX_K
from vers_tpu_torch.ops.topk import topk_smallest

# Launches of the CUDA kernel (one per successful launch).
LAUNCHES = 0
# Scans routed to the plain version because top_k > MAX_K.
LARGE_K_PLAIN = 0
# (Both move by ``core.count``: shards launch from several threads at
# once.)


def padded_group_layout(layout: Dict, r_blk: int) -> Dict:
    """Single-table special case of `padded_forest_layout` (IVF: every
    probe rank shares one group table over all bins)."""
    return padded_forest_layout(layout, r_blk, [0, layout["num_bins"]])


def padded_forest_layout(layout: Dict, r_blk: int, bounds) -> Dict:
    """Group-major padded layout for a stacked multi-table layout:
    per-table group tables over each table's bin range
    [bounds[t], bounds[t+1]), concatenated into one global group list.
    Returns the padded arrays plus stacked per-table tables
    (g_first (T, Gmax+1)) and each table's global group base. Cached on
    the layout per (r_blk, bounds); a build is the span
    ``layout.padded``."""
    cache = layout.setdefault("_padded_forest", {})
    key = (r_blk, tuple(int(b) for b in bounds))
    if key not in cache:
        with trace.span("layout.padded"):
            cache[key] = _padded_forest(layout, r_blk, key[1])
    return cache[key]


def _padded_forest(layout: Dict, r_blk: int, bounds) -> Dict:
    """`padded_forest_layout`'s build."""
    from vers_tpu_torch.ops.binned import stack_group_tables, static_groups

    tables = [
        static_groups(layout, r_blk, int(bounds[t]), int(bounds[t + 1]))
        for t in range(len(bounds) - 1)
    ]
    g_first_stacked, _ = stack_group_tables(tables)
    g_base = np.concatenate(
        [[0], np.cumsum([len(r) for _, r in tables])]
    ).astype(np.int64)
    n_groups = int(g_base[-1])

    sizes = layout["sizes_host"]
    starts = layout["starts_host"]
    k = len(sizes)
    corpus = layout["corpus_sorted"]
    n_src = corpus.shape[0]
    dev = corpus.device

    # the (n_groups * r_blk,) source-row map is built on the host (group
    # tables are k-sized); the corpus is regrouped with one device gather
    src = np.full((n_groups * r_blk,), -1, np.int64)
    g = 0
    for fi, ri in tables:
        for j in range(len(ri)):
            lo = int(ri[j])
            hi_bin = int(fi[j + 1])
            hi = int(starts[hi_bin]) if hi_bin < k else (
                int(starts[-1] + sizes[-1]) if k else 0
            )
            span = min(hi - lo, r_blk)
            src[g * r_blk : g * r_blk + span] = np.arange(lo, lo + span)
            g += 1
    srcd = torch.as_tensor(src, device=dev)
    live = srcd >= 0
    safe = torch.clamp(srcd, 0, max(n_src - 1, 0))
    xp = torch.where(live[:, None], corpus[safe], 0.0).contiguous()
    rb = torch.where(live, layout["rbin"][safe], -1).to(torch.int32)
    so = torch.where(live, layout["sorted_to_orig"][safe], -1).to(torch.int32)
    xx = torch.sum(xp * xp, dim=1)
    out = dict(
        corpus=xp,
        rbin=rb[None, :],
        s2o=so,
        xx=xx[None, :],
        g_first=torch.as_tensor(g_first_stacked, device=dev),
        g_base=tuple(int(b) for b in g_base[:-1]),
        n_groups=n_groups,
        g_max=max(len(r) for _, r in tables),
        r_blk=r_blk,
    )
    return out


def _workitems_blocks(qcounts, rank_off, g_first, q_blk: int,
                      w_rank: int, qb_scratch: int, g_base: int = 0):
    """Block-aligned work items for one probe rank: (qb, gb) int32
    (w_rank,) tensors. Group g's tiles are the query BLOCKS overlapping
    its sorted-query span [qlo, qhi); invalid items park on the scratch
    block. ``g_base`` offsets local group ids into the global padded
    layout (multi-table case)."""
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
    gb = torch.where(valid, g_base + g_c, 0)
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
    q_pad_rank: int,
    metric: str = "sq_euclidean",
    ids_padded=None,  # optional (1, G * r_blk) int32 original row ids
):
    """Plain version of kernel B: a Python loop over work items with
    the kernel's inputs, outputs, carry and tie rule. A run of
    consecutive items with one query block carries that block's best
    set; each chunk merges into it with the carried entries winning
    ties, then the lower column. Returns (res_d, res_i) over the stacked
    rows; ids are padded-corpus positions unless ``ids_padded`` is
    given. Rows no run writes stay (+inf, -1). ``q_pad_rank`` is
    accepted for signature parity and unused, as in the kernel."""
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


def packed_scan_units(qbin_stack, qb, gb, rbin_padded, q_blk: int, r_blk: int):
    """Kernel B's walk, mirrored on the host: one unit for every block of
    the kernel that does work, i.e. every (run of consecutive work items
    with one query block, 64-row part of that block) with a live query
    row. Returns [(row0, nq, tiles, items)]: the unit's first stacked
    row, its row count, the padded first rows of its live 128-row tiles
    in the order the kernel takes them (item order, then row order), and
    its run's item range (first, end). A tile is live if one of its rows
    has a bin inside the unit's [lowest, highest] live query bin."""
    qbin, qb_h, gb_h, rbin = (_host(t) for t in (qbin_stack, qb, gb,
                                                 rbin_padded))
    n_rows, n_w = qbin.shape[0], qb_h.shape[0]
    starts = np.arange(0, r_blk, TILE_ROWS)
    units = []
    w = 0
    while w < n_w:
        block = int(qb_h[w])
        end = w + 1
        while end < n_w and qb_h[end] == block:
            end += 1
        for y0 in range(0, q_blk, QUERY_TILE):
            row0 = block * q_blk + y0
            nq = min(QUERY_TILE, q_blk - y0, n_rows - row0)
            if nq <= 0:
                continue
            bins = qbin[row0 : row0 + nq]
            live = bins[bins >= 0]
            if not live.size:
                continue
            lo, hi = live.min(), live.max()
            tiles = []
            for v in range(w, end):
                g0 = int(gb_h[v]) * r_blk
                rb = rbin[g0 : g0 + r_blk]
                hit = np.logical_or.reduceat((rb >= lo) & (rb <= hi), starts)
                tiles.extend((g0 + starts[hit]).tolist())
            units.append((row0, nq, tiles, (w, end)))
        w = end
    return units


def units_walked(units, n_items: int, q_blk: int) -> np.ndarray:
    """The units of ``packed_scan_units`` as ``cuda_packed_scan_walk``
    reports them: (n_items, parts) int32, the count of live tiles of the
    block that works for (first item of a run, 64-row part), -1 for every
    block that returns at once."""
    walked = np.full((n_items, -(-q_blk // QUERY_TILE)), -1, np.int32)
    for row0, _, tiles, (w, _) in units:
        walked[w, row0 % q_blk // QUERY_TILE] = len(tiles)
    return walked


def packed_scan_work(qbin_stack, qb, gb, rbin_padded, q_blk: int, r_blk: int):
    """What kernel B issues for these inputs against what counts, from
    the host mirror of its walk: its grid, the blocks that work, their
    live tiles, the 64 x 128 products issued (a tile is computed whole),
    the products of (query row, corpus row) pairs with equal bins, and
    the masked share 1 - useful / issued."""
    qbin, gb_h, rbin = (_host(t) for t in (qbin_stack, gb, rbin_padded))
    units = packed_scan_units(qbin_stack, qb, gb, rbin_padded, q_blk, r_blk)
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
    top_k: int, q_blk: int, chunk: int, r_chunks: int, q_pad_rank: int,
    metric: str = "sq_euclidean", ids_padded=None,
):
    """Kernel B's walk in plain torch, for the tests: each unit of
    ``packed_scan_units`` takes its live tiles alone, in order, carries
    (distance, padded position) best sets with the carried entries
    winning ties, then the lower position, and gathers the ids once at
    the end. Same result as ``packed_scan_plain``."""
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
                                                rbin_padded, q_blk, r_blk):
        q = q_stack[row0 : row0 + nq].float()
        qbins = qbin[row0 : row0 + nq]
        qq = torch.sum(q * q, dim=1, keepdim=True)
        best_d = torch.full((nq, top_k), float("inf"), dtype=torch.float32,
                            device=dev)
        best_p = torch.full((nq, top_k), -1, dtype=torch.int32, device=dev)
        for g0 in tiles:
            nx = min(TILE_ROWS, r_blk - g0 % r_blk)
            dot = q @ corpus_padded[g0 : g0 + nx].float().T
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
    top_k: int, q_blk: int, chunk: int, r_chunks: int, q_pad_rank: int,
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
            xx_padded, top_k, q_blk, chunk, r_chunks, q_pad_rank,
            metric=metric, ids_padded=ids_padded,
        )
    return _launch(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
                   xx_padded, top_k, q_blk, chunk * r_chunks, metric,
                   ids_padded, None)


def cuda_packed_scan_walk(
    q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded, xx_padded,
    top_k: int, q_blk: int, chunk: int, r_chunks: int, q_pad_rank: int,
    metric: str = "sq_euclidean", ids_padded=None,
):
    """Kernel B reporting its walk: (res_d, res_i, walked), walked
    (W, parts) int32 with the count of live tiles each block walked and
    -1 for the blocks that returned at once (not the first item of a
    run, or no live query row). The tests and the timing tools hold
    ``packed_scan_units`` to it. CPU tensors take the plain version and
    the host mirror's count."""
    if metric not in ("sq_euclidean", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    if not q_stack.is_cuda:
        out = packed_scan_plain(
            q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
            xx_padded, top_k, q_blk, chunk, r_chunks, q_pad_rank,
            metric=metric, ids_padded=ids_padded)
        units = packed_scan_units(qbin_stack, qb, gb, rbin_padded, q_blk,
                                  chunk * r_chunks)
        return (*out, torch.from_numpy(units_walked(units, qb.shape[0], q_blk)))
    walked = torch.full((qb.shape[0], -(-q_blk // QUERY_TILE)), -1,
                        dtype=torch.int32, device=q_stack.device)
    out = _launch(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
                  xx_padded, top_k, q_blk, chunk * r_chunks, metric,
                  ids_padded, walked)
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
            xx_padded, top_k, q_blk, r_blk, metric, ids_padded, walked):
    _check_inputs(q_stack, qbin_stack, qb, gb, corpus_padded, rbin_padded,
                  xx_padded, ids_padded, top_k, q_blk, r_blk)
    n_rows, d = q_stack.shape
    dev = q_stack.device
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
            int(metric == "cosine"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_packed_scan")
    count(globals(), "LAUNCHES")
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
