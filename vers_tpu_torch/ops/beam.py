"""Batched greedy beam search over a padded adjacency matrix — the
counterpart of ``vers_tpu.ops.beam``, re-expressing HNSW's layer search
(`vers/src/indexes/hnsw.rs:242-307`) as rectangles:

- the beam is a sorted (Q, ef) best-candidate set (the ef-bounded
  max-heap),
- each step expands the best not-yet-expanded entries of every query:
  gather their neighbour rows, gather the neighbours' vectors, one
  batched dot product, drop ids already in the beam or repeated in the
  step (the visited set), merge by a stable sort,
- the loop ends when no query has an unexpanded entry left, or at a
  step cap.

Distances are cosine distance ``1 - dot`` on normalized vectors
(parity with `cosine_similarity_simd`, `base.rs:158-223`).

Numerics. A bf16 navigation table holds the nav rows; they are gathered
in bf16 (the bytes are the cost) and multiplied in f32 against the
query rounded to bf16, which is exact for every product: the JAX
package's bf16 x bf16 dots with f32 accumulation, up to summation
order, TF32 or not. The f32 rescore needs TF32 off, as the port's other
exact paths do.

Loop. A step after a query's last unexpanded entry is a no-op for it
(nothing picked, nothing merged, a stable re-sort of a sorted beam), so
the loop may stop at any step once no query is active, or run to the
cap: ``sync_every`` says how often the host reads the active flag
(0: never; run to the cap with no sync).

The layer-1 routing scan of ``full_descent_scan`` runs on kernel A
(``ops/cuda_topk.cuda_distance_topk``) on a CUDA tensor and on its
plain version on a CPU tensor; see ``route_scan``.
"""

from __future__ import annotations

import torch

from vers_tpu_torch.ops import cuda_topk
from vers_tpu_torch.ops.distance import _check_f32_matmul
from vers_tpu_torch.ops.topk import topk_smallest

_INF = float("inf")

# f32 bytes of one gathered (rows, d) block of a dot product: larger
# batches are cut into query chunks (the results do not change).
GATHER_BYTES = 1 << 30


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for in-range row indices of any shape, as one
    ``index_select`` (a vectorized row gather; advanced indexing takes
    an element-wise route)."""
    return torch.index_select(table, 0, idx.reshape(-1)).view(
        *idx.shape, *table.shape[1:])


def in_beam(ids: torch.Tensor, beam_i: torch.Tensor) -> torch.Tensor:
    """(Q, m) bool: ``ids[q, j]`` equals some ``beam_i[q, :]`` — the
    (Q, m, ef) comparison reduced by ``any``, by a binary search of
    each sorted beam instead."""
    sb = torch.sort(beam_i, dim=1).values
    pos = torch.searchsorted(sb, ids.contiguous()).clamp_(max=sb.shape[1] - 1)
    return sb.gather(1, pos) == ids


def row_dots(vecs: torch.Tensor, ids: torch.Tensor,
             queries: torch.Tensor) -> torch.Tensor:
    """(Q, m) f32 dot products of each query with the rows ``ids``
    (Q, m) of ``vecs`` (clipped into range; callers mask -1). The rows
    are gathered in the table's dtype and multiplied in f32."""
    if vecs.dtype == torch.float32:
        _check_f32_matmul(vecs)
    q_n, m = ids.shape
    n_pad, d = vecs.shape
    safe = ids.clamp(0, n_pad - 1)
    qf = queries.float()
    step = max(1, GATHER_BYTES // max(1, 4 * m * d))
    if q_n <= step:
        return torch.bmm(take_rows(vecs, safe).float(), qf[:, :, None])[:, :, 0]
    out = torch.empty((q_n, m), dtype=torch.float32, device=vecs.device)
    for c0 in range(0, q_n, step):
        c1 = min(q_n, c0 + step)
        out[c0:c1] = torch.bmm(take_rows(vecs, safe[c0:c1]).float(),
                               qf[c0:c1, :, None])[:, :, 0]
    return out


def cosine_to(vecs, ids, queries) -> torch.Tensor:
    """(Q, m) cosine distances ``1 - q.x`` to the rows ``ids``; +inf
    where an id is -1."""
    return torch.where(ids >= 0, 1.0 - row_dots(vecs, ids, queries), _INF)


def repeats_earlier(ids: torch.Tensor) -> torch.Tensor:
    """(Q, m) bool: True where the same id stands at a lower column of
    its row (the JAX package's ``ncol < nrow`` mask), by a stable sort
    instead of the (Q, m, m) comparison."""
    s, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.zeros_like(rep).scatter_(1, order, rep)


def init_beam(entry: torch.Tensor, ef: int, seed_d_fn, entry_d=None):
    """Beam state (beam_d, beam_i, expanded) seeded with ``entry`` (Q,)
    or (Q, S) ids (distinct per row, -1 pad); ``entry_d`` gives their
    distances, else ``seed_d_fn(entry)`` computes them."""
    entry = entry.long()
    if entry.ndim == 1:
        entry = entry[:, None]
    q_n = entry.shape[0]
    s = min(entry.shape[1], ef)
    entry = entry[:, :s]
    seed_d = seed_d_fn(entry) if entry_d is None else entry_d[:, :s].float()
    seed_d = torch.where(entry >= 0, seed_d, _INF)
    dev = entry.device
    beam_i = torch.full((q_n, ef), -1, dtype=torch.int64, device=dev)
    beam_d = torch.full((q_n, ef), _INF, dtype=torch.float32, device=dev)
    beam_i[:, :s] = entry
    beam_d[:, :s] = seed_d
    return beam_d, beam_i, torch.zeros((q_n, ef), dtype=torch.bool, device=dev)


def pick_unexpanded(beam_d, beam_i, expanded, e: int):
    """The ``e`` best unexpanded entries of each beam: (picked ids (Q,
    e), -1 where none; has (Q, e); expanded with them marked)."""
    cand_rank = beam_d.masked_fill(expanded | (beam_i < 0), _INF)
    pick_d, pick = topk_smallest(cand_rank, e)
    has = pick_d < _INF
    picked = torch.where(has, beam_i.gather(1, pick), -1)
    mark = torch.zeros_like(expanded).scatter_(1, pick, has)
    return picked, has, expanded | mark


def merge_beam(beam_d, beam_i, expanded, nd, nbrs, ef: int):
    """Merge candidates (nd, nbrs) into the beam by a stable sort:
    (beam_d, beam_i, expanded, active), ``active`` a 0-d bool tensor,
    True while some query has an unexpanded finite entry."""
    cat_d = torch.cat([beam_d, nd], dim=1)
    cat_i = torch.cat([beam_i, nbrs], dim=1)
    cat_e = torch.cat([expanded, torch.zeros_like(nbrs, dtype=torch.bool)], dim=1)
    new_d, sel = topk_smallest(cat_d, ef)
    fin = torch.isfinite(new_d)
    new_i = torch.where(fin, cat_i.gather(1, sel), -1)
    new_e = cat_e.gather(1, sel)
    active = ((~new_e) & (new_i >= 0) & fin).any()
    return new_d, new_i, new_e, active


def run_beam(state, step_fn, max_steps: int, sync_every: int):
    """Run ``step_fn(state) -> (state, active)`` up to ``max_steps``
    times; every ``sync_every`` steps the host reads ``active`` and
    stops once it is False (0: run to the cap)."""
    for step in range(1, max_steps + 1):
        state, active = step_fn(state)
        if sync_every and step % sync_every == 0 and step < max_steps:
            if not bool(active):
                break
    return state


def gather_beam(queries_nav, vecs, adj, entry, ef: int, max_steps: int,
                expand: int, entry_d=None, rank_map=None,
                dedup_self: bool = True, sync_every: int = 4):
    """One layer's beam search on the classic row gathers, shared by the
    query beam (``beam_search_layer``) and the construction beam
    (``ops/hnsw_build._beam``). ``queries_nav`` are already rounded to
    the table's dtype. ``rank_map`` (n_pad,) maps a global id to its
    compact adjacency row (-1 absent); None: ids are rows. Returns
    (beam_d, beam_i) ascending, -1 / +inf padded."""
    q_n = queries_nav.shape[0]
    n_pad = vecs.shape[0]
    rows_total, deg = adj.shape
    e = max(1, min(expand, ef))

    def dist_to(ids):
        return cosine_to(vecs, ids, queries_nav)

    def step(state):
        beam_d, beam_i, expanded = state
        picked, has, expanded = pick_unexpanded(beam_d, beam_i, expanded, e)
        if rank_map is None:
            rows = picked.clamp(0, n_pad - 1)
            live = has
        else:
            rows = rank_map[picked.clamp(0, n_pad - 1)].long()
            live = has & (rows >= 0)
        nbrs = take_rows(adj, rows.clamp(0, rows_total - 1)).long()  # (Q, E, deg)
        nbrs = torch.where(live[:, :, None], nbrs, -1).reshape(q_n, e * deg)
        nd = dist_to(nbrs)
        dup = in_beam(nbrs, beam_i)
        if dedup_self:
            dup |= repeats_earlier(nbrs)
        nd = nd.masked_fill(dup & (nbrs >= 0), _INF)
        beam_d, beam_i, expanded, active = merge_beam(
            beam_d, beam_i, expanded, nd, nbrs, ef)
        return (beam_d, beam_i, expanded), active

    state = init_beam(entry, ef, dist_to, entry_d)
    beam_d, beam_i, _ = run_beam(state, step, max_steps, sync_every)
    return beam_d, beam_i


def beam_search_layer(
    queries,      # (Q, d) f32
    vecs,         # (n_pad, d) node vectors (compact ids), bf16 or f32
    adj,          # (n_pad, deg) int neighbour compact ids, -1 pad
    entry,        # (Q,) or (Q, S) compact entry node(s) per query
    ef: int,
    max_steps: int,
    expand_per_step: int = 4,
    entry_d=None,  # (Q, S) f32 precomputed seed distances (optional)
    sync_every: int = 4,
):
    """Returns (beam_d (Q, ef) ascending, beam_i (Q, ef) int64; -1/inf
    padding). Emulates one HNSWLayer::search with ef candidates.

    ``entry`` may carry S seed nodes per query (e.g. the top-S of the
    routing scan), distinct per query or -1; ``entry_d`` supplies their
    distances when the caller already computed them.

    ``expand_per_step``: how many best unexpanded beam entries expand
    per iteration (1 = classic sequential best-first)."""
    q_nav = queries.to(vecs.dtype)
    return gather_beam(q_nav, vecs, adj, entry, ef, max_steps,
                       expand_per_step, entry_d=entry_d,
                       sync_every=sync_every)


def route_scan(queries, l1_tab, n1: int, k: int):
    """The exact top-``k`` layer-1 members of each query by cosine
    distance, with bf16 products and f32 sums: ``l1_tab`` (n1_pad, d)
    holds the layer-1 rows in bf16 (zero past ``n1``; an f32 table of
    bf16 values gives the same result) and the queries are rounded the
    same way, as precision "default" rounds them. CUDA tensors launch
    kernel A's bf16 route at that precision
    (``cuda_topk.cuda_distance_topk``, which raises rather than fall
    back), CPU tensors take its plain version. Returns (d (Q, k) f32,
    row positions (Q, k) int32, -1 past n1)."""
    return cuda_topk.cuda_distance_topk(queries.float().contiguous(), l1_tab,
                                        n1, k, metric="cosine",
                                        precision="default")


def scan_seeds(queries, l1_tab, l1_members, n1: int, k: int):
    """(seed_d (Q, k), seed ids (Q, k) int64, -1 pad) from the routing
    scan: scan positions mapped to compact node ids."""
    seed_d, seed_pos = route_scan(queries, l1_tab, n1, k)
    n1_pad = l1_members.shape[0]
    seed_pos = seed_pos.long()
    seed_ids = torch.where(seed_pos >= 0,
                           l1_members[seed_pos.clamp(0, n1_pad - 1)].long(), -1)
    return seed_d, seed_ids


def full_descent(
    queries,     # (Q, d) f32
    vecs_f32,    # (n_pad, d) f32 (rescore table)
    vecs_nav,    # (n_pad, d) nav dtype
    adjs,        # sequence of (n_pad, deg_l) int, layers 0..L-2
    entry,       # (Q,) entry rows (top-layer entrypoint)
    top_k: int,
    ef: int,
    ef_r: int,
    rescore: bool,
    expand: int = 4,
    steps_cap=None,
):
    """The whole query descent (``route_mode="beam"``): routing beams on
    layers L-2..1, the ef-wide layer-0 beam, and the exact f32 rescore.
    ``adjs`` holds the searched layers only (the reference never
    searches the top layer, `hnsw.rs:526`). Returns (d (Q, top_k),
    ids (Q, top_k))."""
    beam_d = beam_i = None
    for layer_idx in range(len(adjs) - 1, -1, -1):
        ef_l = ef if layer_idx == 0 else ef_r
        beam_d, beam_i = beam_search_layer(
            queries, vecs_nav, adjs[layer_idx], entry, ef=ef_l,
            max_steps=steps_cap or max(4 * ef_l, 64),
            expand_per_step=min(max(1, expand), ef_l),
        )
        if layer_idx != 0:
            entry = beam_i[:, 0]
    if rescore:
        beam_d, beam_i = rescore_cosine(queries, vecs_f32, beam_i, top_k)
    return beam_d[:, :top_k], beam_i[:, :top_k]


def full_descent_scan(
    queries,      # (Q, d) f32
    vecs_f32,     # (n_pad, d) f32 (rescore table)
    vecs_nav,     # (n_pad, d) nav dtype
    adj0,         # (n_pad, deg) int layer-0 adjacency
    l1_tab,       # (n1_pad, d) bf16 layer-1 rows
    l1_members,   # (n1_pad,) compact node id of each l1 row
    n1: int,      # live rows of l1_tab
    top_k: int,
    ef: int,
    seeds: int,
    rescore: bool,
    expand: int = 8,
    steps_cap=None,
):
    """Query descent with brute-force routing (``route_mode="scan"``,
    PARITY D14): one exact scan over the layer-1 members (``route_scan``:
    kernel A on the card) finds the top-``seeds`` entries, which seed
    the layer-0 beam directly in place of the greedy descent through
    layers L-2..1 (`hnsw.rs:516-541`). Every node of a layer >= 1 is in
    layer 1, so the scan dominates any routing descent, and the layer-0
    beam starts from ``seeds`` good candidates.

    Returns (d (Q, top_k), ids (Q, top_k))."""
    seed_d, seed_ids = scan_seeds(queries, l1_tab, l1_members, n1,
                                  min(seeds, ef))
    beam_d, beam_i = beam_search_layer(
        queries, vecs_nav, adj0, seed_ids, ef=ef,
        max_steps=steps_cap or max(4 * ef, 64),
        expand_per_step=min(max(1, expand), ef),
        entry_d=seed_d,
    )
    if rescore:
        beam_d, beam_i = rescore_cosine(queries, vecs_f32, beam_i, top_k)
    return beam_d[:, :top_k], beam_i[:, :top_k]


def insertion_candidates(
    query,       # (1, d) f32 — the vector being inserted
    vecs_f32,    # (n_pad, d) f32 rescore table
    vecs_nav,    # (n_pad, d) nav dtype
    adjs,        # sequence of (n_pad, deg_l) int, layers 0..L-1 (ALL layers)
    entry,       # (1,) top-layer entry row
    efc: int,
    l_ins: int,
    expand: int = 8,
    steps_cap=None,
):
    """Insertion descent for an incremental ``add`` on a device-built
    graph (the search phase of `_add_node`, `hnsw.rs:348-416`): beams
    route from the TOP layer down (insertion searches the top layer
    too, unlike queries), and every layer <= ``l_ins`` emits its
    f32-rescored efc-wide candidate set plus the candidates' f32
    vectors (for the host-side heuristic neighbour selection).

    Returns (cand_d (l_ins+1, efc), cand_i (l_ins+1, efc),
    cand_vecs (l_ins+1, efc, d)); row j holds layer ``l_ins - j``."""
    outs_d, outs_i = [], []
    n_pad = vecs_f32.shape[0]
    for l in range(len(adjs) - 1, -1, -1):
        beam_d, beam_i = beam_search_layer(
            query, vecs_nav, adjs[l], entry, ef=efc,
            max_steps=steps_cap or max(4 * efc, 64),
            expand_per_step=min(max(1, expand), efc),
        )
        if l <= l_ins:
            rd, ri = rescore_cosine(query, vecs_f32, beam_i, efc)
            outs_d.append(rd[0])
            outs_i.append(ri[0])
        entry = beam_i[:, :1]
    cand_d = torch.stack(outs_d)                     # (l_ins+1, efc)
    cand_i = torch.stack(outs_i)
    cand_v = vecs_f32[cand_i.clamp(0, n_pad - 1)]    # (l_ins+1, efc, d)
    return cand_d, cand_i, cand_v


def rescore_cosine(queries, vecs_f32, ids, top_k: int):
    """Exact f32 rescore of beam results (after bf16 navigation):
    gather the top candidates' f32 vectors, recompute 1-dot (TF32 off),
    and re-sort ascending. Returns (d (Q, top_k), ids (Q, top_k))."""
    cand = ids[:, :top_k].long()
    d = cosine_to(vecs_f32, cand, queries)
    d_sorted, sel = topk_smallest(d, min(top_k, cand.shape[1]))
    i_sorted = torch.where(torch.isfinite(d_sorted), cand.gather(1, sel), -1)
    return d_sorted, i_sorted
