"""Batched HNSW construction on the device — the counterpart of
``vers_tpu.ops.hnsw_build``.

The reference builds its graph one node at a time on the host
(`vers/src/indexes/hnsw.rs:348-432`): descend with ef_construction
searches, heuristic-select M neighbours, add undirected edges, trim.
That loop is serial, so a 1M-vector build is hours of pointer-chasing.

Here construction is **wave-parallel insertion**, as in the JAX
package: nodes are inserted in waves (1, 8, 64, ... up to
``wave_cap``); within a wave every node runs the same layer-descent
beam search against the frozen graph of all previous waves, selects
neighbours with the paper's heuristic (one (W, ef, ef) candidate-pair
distance product and a loop over candidates), and edges are committed
with scatters:

- forward rows are written directly (new nodes own empty rows),
- reverse edges go into per-row slack slots (rank within the wave's
  incoming set, from one stable sort), then affected rows are compacted
  back to degree by distance.

Wave members don't see each other as candidates (the graph is frozen
per wave) — the standard batched-HNSW relaxation. Reverse-edge trimming
is distance-based (the reference's `_trim_neighbours` re-runs the
heuristic — a documented deviation, PARITY.md).

Layers use compact row indexing (insertion layers are drawn up front,
so per-layer membership is static): adjacency rows exist only for a
layer's members; neighbour ids are global. Each layer's buffers carry
one spare row at the end: the scatters send masked writes there, and
every read of it is masked.

Every decision that shapes the graph is the JAX package's: the wave
schedule, ``wave_cap="auto"``, ``beam_steps="auto"``,
``route_steps="auto"`` and the per-layer ``sub_caps`` rule. A wave runs
on its live rows only; the JAX package pads it to a power-of-two
bucket, whose dead rows change no live row's result.

Two options change how a wave searches, as in the JAX package:

- ``route_scan``: exact scans of each upper layer's built members
  replace every routing and upper-layer insertion beam
  (``scan_members``: kernel A's bf16 route at precision "default" on a
  CUDA tensor, its plain version on a CPU tensor, the plain version for
  k > 128 on either, counted);
- ``insert_inline``: the layer-0 insertion beam scores candidates on a
  construction-time table of the neighbours' PCA-projected blocks,
  kept slot for slot with the adjacency (``_beam_inline``,
  ``_commit_edges(inline=...)``).

Each wave is a span ``hnsw.wave`` of the port's trace
(``vers_tpu_torch.trace``).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from vers_tpu_torch import trace
from vers_tpu_torch.core import resolve_device, round_up
from vers_tpu_torch.ops import cuda_topk
from vers_tpu_torch.ops.beam import (
    cosine_to,
    gather_beam,
    in_beam,
    init_beam,
    merge_beam,
    pick_unexpanded,
    run_beam,
    take_rows,
)
from vers_tpu_torch.ops.topk import topk_smallest

_INF = float("inf")
_INT32_MAX = 2**31 - 1

# Guard on the construction-time inline table (build_graph
# insert_inline), counted as the JAX package counts it (its power-of-two
# rows), so that both refuse the same builds.
_INLINE_BUILD_MAX_BYTES = 8 << 30


def draw_insertion_layers(n: int, num_layers: int, m: int, seed: int) -> np.ndarray:
    """Parity with `get_insertion_layer` (`hnsw.rs:335-346`):
    min(int(-ln(U) / ln(M)), L-1), drawn up front for the whole corpus."""
    rng = np.random.default_rng(seed)
    u = np.maximum(rng.random(n), 1e-12)
    mult = 1.0 / math.log(m)
    return np.minimum((-np.log(u) * mult).astype(np.int64), num_layers - 1)


def _beam(q, vecs, adj, rank_map, entry, ef: int, max_steps: int,
          expand: int = 8, dedup_self: bool = False, entry_d=None,
          sync_every: int = 4):
    """Masked beam search over one layer. ``adj`` rows are compact
    (layer-local); ``rank_map`` (n_pad,) maps global id -> compact row
    (-1 absent). ``q`` are rows of the nav table (already in its dtype);
    entry (W,) or (W, S) global ids. Returns (beam_d, beam_i)
    ascending, beam_i global ids (-1 pad).

    ``expand``: best unexpanded entries expanded per step.
    ``dedup_self`` (off, as in the JAX package) also drops repeats
    within one step's neighbour set; cross-step repeats are always
    dropped by the beam mask. ``sync_every``: how often the host reads
    whether any member is still active (0: run to the step cap; the
    extra steps are no-ops). A read every 4 steps lets the routing beams
    of small upper layers, which converge in a few steps, stop early."""
    return gather_beam(q, vecs, adj, entry, ef, max_steps, expand,
                       entry_d=entry_d, rank_map=rank_map,
                       dedup_self=dedup_self, sync_every=sync_every)


def _pow2_rows(count: int) -> int:
    """The JAX package's power-of-two row count of a layer's buffers."""
    return max(8, 1 << (max(count, 1) - 1).bit_length())


def scan_members(q, tab, tab_members, n_built: int, k: int, chunk: int):
    """The exact top-``k`` of the first ``n_built`` rows of a layer's
    member table ``tab`` (nav dtype) for the nav rows ``q``, by cosine
    distance at precision "default" (bf16 products, f32 sums): (dists
    (W, k) f32, global ids (W, k) int64, -1 / +inf past n_built). A CUDA
    tensor launches kernel A's bf16 route (``cuda_topk.distance_topk``,
    which raises rather than fall back); a CPU tensor, or k > 128 on any
    device (counted in ``cuda_topk.LARGE_K_PLAIN``), takes its plain
    version with corpus chunks of ``chunk`` rows."""
    d, pos = cuda_topk.distance_topk(q.float().contiguous(), tab, n_built, k,
                                     metric="cosine", chunk_size=chunk,
                                     precision="default")
    pos = pos.long()
    ids = torch.where(pos >= 0,
                      tab_members[pos.clamp(0, tab.shape[0] - 1)].long(), -1)
    return d, ids


def _beam_inline(q, qp, vecs, inline_tab, adj_fwd, rank_map, entry,
                 ef: int, max_steps: int, expand: int = 8,
                 refine: int = 64, entry_d=None, sync_every: int = 4):
    """The neighbourhood-inlined insertion beam (the build side of
    ``ops/beam_inline``): ``inline_tab`` (rows + 1, deg + slack, dp)
    holds, slot for slot with the full adjacency width, each node's
    neighbours' projected bf16 blocks. A step gathers W * expand wide
    rows instead of W * expand * deg thin ones, scores every candidate
    by its projected dot with ``qp`` (W, dp), keeps the best ``refine``
    and ranks those by their exact nav distances, so the beam keeps
    exact order (projection only filters). ``adj_fwd`` gives the
    candidate ids (forward columns; the blocks of slack slots are
    gathered but not read). Same beam and visited semantics as
    ``_beam``, cross-step repeats only, as in the JAX package."""
    w = q.shape[0]
    n_pad = vecs.shape[0]
    rows_total, width, dp = inline_tab.shape
    deg = adj_fwd.shape[1]
    e = max(1, min(expand, ef))
    r = max(1, min(refine, e * deg))
    qpf = qp.float()[:, :, None]

    def dist_to(ids):
        return cosine_to(vecs, ids, q)

    def step(state):
        beam_d, beam_i, expanded = state
        nodes, has, expanded = pick_unexpanded(beam_d, beam_i, expanded, e)
        rows = rank_map[nodes.clamp(0, n_pad - 1)].long()
        safe = rows.clamp(0, rows_total - 1)
        nbrs = take_rows(adj_fwd, safe).long()                 # (W, E, deg)
        nbrs = torch.where((has & (rows >= 0))[:, :, None], nbrs,
                           -1).reshape(w, e * deg)
        # E wide rows a query instead of E * deg thin ones
        blocks = take_rows(inline_tab, safe)                 # (W, E, width, dp)
        nv = blocks[:, :, :deg, :].reshape(w, e * deg, dp)
        dots = torch.bmm(nv.float(), qpf)[:, :, 0]
        nd = torch.where(nbrs >= 0, 1.0 - dots, _INF)
        nd = nd.masked_fill(in_beam(nbrs, beam_i) & (nbrs >= 0), _INF)
        # the projection filters the top r; the beam merges exact navs
        sc, sel = topk_smallest(nd, r)
        cand = torch.where(torch.isfinite(sc), nbrs.gather(1, sel), -1)
        beam_d, beam_i, expanded, active = merge_beam(
            beam_d, beam_i, expanded, dist_to(cand), cand, ef)
        return (beam_d, beam_i, expanded), active

    state = init_beam(entry, ef, dist_to, entry_d)
    beam_d, beam_i, _ = run_beam(state, step, max_steps, sync_every)
    return beam_d, beam_i


def _heuristic_select(q, vecs, beam_d, beam_i, m: int):
    """Vectorized neighbour-selection heuristic (paper §4, reference
    `hnsw.rs:104-164` incl. the m+1 quirk): accept candidate c iff
    d(c, target) <= min over already-selected s of d(c, s).
    Returns (sel_d, sel_i) of width m+1, ascending, -1/inf padded.
    ``q`` is unused (the candidates' own distances are in beam_d), as
    in the JAX package."""
    w, ef = beam_d.shape
    n_pad = vecs.shape[0]
    cv = take_rows(vecs, beam_i.clamp(0, n_pad - 1)).float()      # (W, ef, d)
    # pair[w, i, j] = d(c_i, c_j); the loop reads row i (the JAX
    # package reads column i of the same symmetric product)
    pair = 1.0 - torch.bmm(cv, cv.transpose(1, 2))
    del cv
    valid = (beam_i >= 0) & torch.isfinite(beam_d)

    min_sel = torch.full((w, ef), _INF, device=beam_d.device)
    count = torch.zeros((w,), dtype=torch.int32, device=beam_d.device)
    accepted = torch.zeros((w, ef), dtype=torch.bool, device=beam_d.device)
    for i in range(ef):
        # count == 0 leaves min_sel at +inf, and a valid d_i is finite,
        # so ``d_i <= min_sel`` covers the reference's count == 0 case
        accept = valid[:, i] & (beam_d[:, i] <= min_sel[:, i]) & (count <= m)
        # only columns after i are read again
        if i + 1 < ef:
            upd = pair[:, i, i + 1:].masked_fill(~accept[:, None], _INF)
            torch.minimum(min_sel[:, i + 1:], upd, out=min_sel[:, i + 1:])
        count += accept
        accepted[:, i] = accept
    sel_d = beam_d.masked_fill(~accepted, _INF)
    out_d, order = topk_smallest(sel_d, min(m + 1, ef))
    out_i = torch.where(torch.isfinite(out_d), beam_i.gather(1, order), -1)
    return out_d, out_i


def _commit_edges(adj, dist, rank_map, u_ids, sel_i, sel_d, connect,
                  deg: int, slack: int, inline=None, proj=None):
    """Write forward rows for new nodes and reverse edges into slack
    slots, then compact affected rows back to ``deg`` by distance.
    adj/dist: (rows + 1, deg + slack), the last row the dump row, both
    updated in place. u_ids (W,) global; sel_i/sel_d (W, S <= deg).
    Returns (adj, dist).

    With ``inline`` (rows + 1, deg + slack, dp) and ``proj`` (n_pad, dp)
    the construction-time inline table is kept slot for slot with the
    adjacency, in place: forward rows get their neighbours' projected
    blocks, a reverse edge drops ``proj[u]`` into the id's slack slot,
    and compaction moves the blocks by the ids' own permutation."""
    w, s = sel_i.shape
    dump = adj.shape[0] - 1
    width = deg + slack
    n_pad = rank_map.shape[0]
    dev = adj.device
    sel_i = sel_i.long()

    # ---- forward rows -------------------------------------------------
    fwd_i = torch.full((w, width), -1, dtype=adj.dtype, device=dev)
    fwd_d = torch.full((w, width), _INF, dtype=dist.dtype, device=dev)
    fwd_i[:, :s] = sel_i.to(adj.dtype)
    fwd_d[:, :s] = sel_d
    u_row = rank_map[u_ids.clamp(0, n_pad - 1)].long()
    u_row = torch.where(connect & (u_ids >= 0) & (u_row >= 0), u_row, dump)
    adj[u_row] = fwd_i   # wave members own distinct rows; repeats only at dump
    dist[u_row] = fwd_d
    if inline is not None:
        dp = proj.shape[1]
        blk = proj[sel_i.clamp(0, n_pad - 1)].masked_fill(
            (sel_i < 0)[:, :, None], 0)                      # (W, S, dp)
        fwd_blk = torch.zeros((w, width, dp), dtype=inline.dtype, device=dev)
        fwd_blk[:, :s] = blk
        inline[u_row] = fwd_blk

    # ---- reverse edges ------------------------------------------------
    e = w * s
    v_flat = torch.where(connect[:, None], sel_i, -1).reshape(e)
    d_flat = torch.where(connect[:, None], sel_d, _INF).reshape(e)
    u_flat = u_ids[:, None].expand(w, s).reshape(e)
    valid = (v_flat >= 0) & torch.isfinite(d_flat)

    # sort by (v, d): closest incoming edges win the slack slots. The
    # JAX package sorts two int32 keys stably, the distance key being
    # the f32 bit pattern of d+1 compared as a signed int; here one
    # int64 key v * 2^32 + (that int32 + 2^31) under a stable sort
    # gives the same order.
    v_key = torch.where(valid, v_flat, _INT32_MAX)
    d_bits = (torch.where(valid, d_flat, _INF) + 1.0).view(torch.int32).long()
    _, perm = torch.sort(v_key * (1 << 32) + (d_bits + (1 << 31)), stable=True)
    v2, d2, u2, val2 = v_key[perm], d_flat[perm], u_flat[perm], valid[perm]

    iota = torch.arange(e, device=dev)
    is_start = torch.ones((e,), dtype=torch.bool, device=dev)
    is_start[1:] = v2[1:] != v2[:-1]
    seg_start = torch.cummax(torch.where(is_start, iota, -1), dim=0).values
    rank = iota - seg_start
    keep = val2 & (rank < slack)
    v_row = rank_map[v2.clamp(0, n_pad - 1)].long()
    v_row_k = torch.where(keep & (v_row >= 0), v_row, dump)
    slot = torch.where(keep, deg + rank, 0)
    # each kept (v, rank) pair is one (row, slot); repeats only at dump
    adj[v_row_k, slot] = u2.to(adj.dtype)
    dist[v_row_k, slot] = d2
    if inline is not None:
        inline[v_row_k, slot] = proj[u2.clamp(0, n_pad - 1)]

    # ---- compact affected rows back to deg ----------------------------
    rows = torch.where(val2 & (v_row >= 0), v_row, dump)
    off = (rows == dump)[:, None]
    ga = adj[rows].masked_fill(off, -1)
    gd = dist[rows].masked_fill(off, _INF)
    gd = torch.where(ga >= 0, gd, _INF)
    nd, order = topk_smallest(gd, deg)
    ni = torch.where(torch.isfinite(nd), ga.gather(1, order), -1)
    # slack columns are cleared after compaction
    ni = torch.nn.functional.pad(ni, (0, width - deg), value=-1)
    nd = torch.nn.functional.pad(nd, (0, width - deg), value=_INF)
    # a row with several incoming edges appears several times in
    # ``rows``; every copy carries the same values (computed from the
    # same gathered state), so a plain index_put_ is safe
    adj[rows] = ni
    dist[rows] = nd
    if inline is not None:
        # the blocks ride the ids' compaction permutation; repeated rows
        # write equal values, as for adj and dist above
        g_blk = inline[rows].masked_fill(off[:, :, None], 0)
        nblk = g_blk.gather(1, order[:, :, None].expand(-1, -1, dp))
        nblk = nblk.masked_fill(~torch.isfinite(nd[:, :deg])[:, :, None], 0)
        inline[rows] = torch.nn.functional.pad(nblk, (0, 0, 0, width - deg))
    return adj, dist


def _fit(sel_d, sel_i, deg: int):
    """Pad (with +inf / -1) or cut the selection to ``deg`` columns."""
    if sel_d.shape[1] < deg:
        padn = deg - sel_d.shape[1]
        sel_d = torch.nn.functional.pad(sel_d, (0, padn), value=_INF)
        sel_i = torch.nn.functional.pad(sel_i, (0, padn), value=-1)
    return sel_d[:, :deg], sel_i[:, :deg]


def make_wave_step(num_layers: int, m: int, efc: int, degs: List[int],
                   slack: int, sub_caps: tuple, layer_sizes: tuple,
                   ef_route: int = 8, expand: int = 8,
                   route_expand: int = 4, dedup_self: bool = False,
                   beam_steps: int | None = None,
                   route_steps: int | None = 16,
                   route_scan: bool = False, seed_count: int = 1,
                   scan_chunk: int = 16384,
                   insert_inline: bool = False,
                   inline_refine: int = 64,
                   inline_steps: int | None = None):
    """The per-wave insertion function. degs[l] = forward degree cap of
    layer l (m_l + 1 for the heuristic's m+1 quirk); adjacency buffers
    are (rows + 1, degs[l] + slack).

    ``beam_steps`` / ``route_steps`` cap the steps of the insertion /
    routing beams (None = the 4*ef ceiling). ``sub_caps[l]`` (l >= 1)
    is the row count of the wave prefix that runs an efc-wide beam at
    layer l (each wave is sorted by insertion layer, descending, so
    the prefix covers every member with ins >= l); the other members
    only need an entry point for the layer below, found by an
    ``ef_route``-wide routing beam. So the caps decide which member
    runs which beam and shape the graph. ``sub_caps[l] == 0``: nothing
    inserts at l. ``layer_sizes[l]`` = the layer's final member count;
    a layer of one member holds only the global entry node, so routing
    through it is the identity and is skipped.

    ``route_scan``: every upper-layer beam gives way to exact scans.
    Waves insert in global-id order and membership is drawn up front, so
    the built members of layer l are the first ``n_built[l]`` rows of its
    member table ``tabs[l]`` (ascending global id). The prefix of the
    wave that inserts at layer l >= 1 takes its candidates from an exact
    top-``min(efc, rows)`` scan of that prefix (``scan_members``), and
    the layer-0 insertion beam starts from the top-``seed_count``
    layer-1 members, their scan distances as seed distances. The wave
    step takes ``(tabs, tab_members, n_built)`` after ``entry``.

    ``insert_inline``: the layer-0 insertion beam is ``_beam_inline``
    (``inline_refine`` exact rows a step, ``inline_steps`` steps, else
    ``beam_steps``) and ``_commit_edges`` keeps its table; the wave step
    takes ``(inline_tab, proj, basis)`` after ``entry``.

    Returns ``wave_step(vecs, rank_maps, adjs, dists, wave_ids, ins_l,
    entry, *option_args)``, which updates the buffers in place."""

    def insert_layer0(q, vecs, rank_maps, adjs, dists, wave_ids, ins_l,
                      beam_d, beam_i, inline=None, proj=None):
        deg = degs[0]
        connect = (wave_ids >= 0) & (ins_l >= 0)
        sel_d, sel_i = _fit(
            *_heuristic_select(q, vecs, beam_d, beam_i, 2 * m), deg)
        _commit_edges(adjs[0], dists[0], rank_maps[0], wave_ids, sel_i, sel_d,
                      connect, deg, slack, inline=inline, proj=proj)

    def layer0_beam(q, vecs, rank_maps, adjs, seeds, seed_d=None):
        return _beam(
            q, vecs, adjs[0][:, :degs[0]], rank_maps[0], seeds, efc,
            max_steps=beam_steps or 4 * efc, expand=expand,
            dedup_self=dedup_self, entry_d=seed_d,
        )

    if route_scan:

        def wave_step_scan(vecs, rank_maps, adjs, dists, wave_ids, ins_l,
                           entry, tabs, tab_members, n_built):
            w = wave_ids.shape[0]
            n_pad = vecs.shape[0]
            alive = wave_ids >= 0
            q = vecs[wave_ids.clamp(0, n_pad - 1)]
            for l in range(num_layers - 1, 0, -1):
                c = min(sub_caps[l], w)
                if c == 0:
                    continue
                deg = degs[l]
                rows_l = tabs[l].shape[0]
                cd, ci = scan_members(q[:c], tabs[l], tab_members[l],
                                      n_built[l], min(efc, rows_l),
                                      min(scan_chunk, rows_l))
                connect = alive[:c] & (ins_l[:c] >= l)
                sel_d, sel_i = _fit(
                    *_heuristic_select(q[:c], vecs, cd, ci, m), deg)
                _commit_edges(adjs[l], dists[l], rank_maps[l], wave_ids[:c],
                              sel_i, sel_d, connect, deg, slack)
            # layer 0: seed the insertion beam with the nearest built
            # layer-1 members
            rows_1 = tabs[1].shape[0]
            seed_d, seeds = scan_members(q, tabs[1], tab_members[1],
                                         n_built[1],
                                         max(1, min(seed_count, rows_1)),
                                         min(scan_chunk, rows_1))
            beam_d, beam_i = layer0_beam(q, vecs, rank_maps, adjs, seeds,
                                         seed_d)
            insert_layer0(q, vecs, rank_maps, adjs, dists, wave_ids, ins_l,
                          beam_d, beam_i)
            return adjs, dists

        return wave_step_scan

    def wave_step(vecs, rank_maps, adjs, dists, wave_ids, ins_l, entry,
                  *inline_args):
        w = wave_ids.shape[0]
        n_pad = vecs.shape[0]
        alive = wave_ids >= 0
        q = vecs[wave_ids.clamp(0, n_pad - 1)]
        ent = torch.full((w,), int(entry), dtype=torch.int64, device=vecs.device)

        for l in range(num_layers - 1, 0, -1):
            c = min(sub_caps[l], w)
            if c == 0 and layer_sizes[l] <= 1:
                continue  # single-member layer == the entry node
            deg = degs[l]
            # beams gather only the forward columns: the slack columns
            # are -1 outside _commit_edges
            adj_fwd = adjs[l][:, :deg]
            new_ent = ent
            if c < w and layer_sizes[l] > 1:
                ef_r = min(ef_route, efc)
                _, rb_i = _beam(
                    q, vecs, adj_fwd, rank_maps[l], ent, ef_r,
                    max_steps=route_steps or max(4 * ef_r, 64),
                    expand=route_expand, dedup_self=dedup_self,
                )
                best = rb_i[:, 0]
                new_ent = torch.where(alive & (best >= 0), best, ent)
            if c > 0:
                qs, es = q[:c], ent[:c]
                beam_d, beam_i = _beam(
                    qs, vecs, adj_fwd, rank_maps[l], es, efc,
                    max_steps=beam_steps or 4 * efc, expand=expand,
                    dedup_self=dedup_self,
                )
                connect = alive[:c] & (ins_l[:c] >= l)
                sel_d, sel_i = _fit(
                    *_heuristic_select(qs, vecs, beam_d, beam_i, m), deg)
                _commit_edges(adjs[l], dists[l], rank_maps[l], wave_ids[:c],
                              sel_i, sel_d, connect, deg, slack)
                # inserting members take their full beam's best as the
                # next-layer entry (`hnsw.rs:383,415`)
                best = beam_i[:, 0]
                new_ent = new_ent.clone()
                new_ent[:c] = torch.where(alive[:c] & (best >= 0), best, es)
            ent = new_ent

        # layer 0: every member inserts — full-width beam
        if insert_inline:
            from vers_tpu_torch.ops.beam_inline import project_rows

            inline_tab, proj, basis = inline_args
            beam_d, beam_i = _beam_inline(
                q, project_rows(q, basis, proj.shape[1]), vecs, inline_tab,
                adjs[0][:, :degs[0]], rank_maps[0], ent, efc,
                max_steps=inline_steps or beam_steps or 4 * efc,
                expand=expand, refine=inline_refine,
            )
        else:
            beam_d, beam_i = layer0_beam(q, vecs, rank_maps, adjs, ent)
        insert_layer0(q, vecs, rank_maps, adjs, dists, wave_ids, ins_l, beam_d,
                      beam_i, *inline_args[:2])  # (inline_tab, proj)
        return adjs, dists

    return wave_step


def wave_caps(ins_wave: np.ndarray, num_layers: int, m: int, wsz: int,
              wave_cap: int, route_layers: bool = True):
    """The JAX package's per-wave (bucket, sub_caps) rule, kept exactly:
    the bucket is the wave size rounded up to a power of two (at most
    ``round_up(wave_cap, 8)``), and ``sub_caps[l]`` a power of two, at
    least 16, covering both the realized count of members inserting at
    layer >= l and mean + 6 sd + 4 of its Binomial(bucket, M^-l) law;
    0 where no member inserts at l. ``ins_wave``: the wave's insertion
    layers."""
    bucket = 1 << (wsz - 1).bit_length()
    bucket = min(bucket, round_up(wave_cap, 8))
    caps = [0] * num_layers
    for l in range(1, num_layers):
        if not route_layers:
            caps[l] = bucket  # faithful: full beams for everyone
            continue
        cnt = int((ins_wave >= l).sum())
        if cnt == 0:
            caps[l] = 0
        else:
            exp_cnt = bucket / float(m) ** l
            stat = exp_cnt + 6.0 * math.sqrt(exp_cnt) + 4.0
            cap = max(16, 1 << (int(max(cnt, stat)) - 1).bit_length())
            caps[l] = min(bucket, cap)
    return bucket, tuple(caps)


def wave_schedule(n: int, wave_cap: int) -> List[np.ndarray]:
    """Waves of ids: 1, then 8, 64, 512, ... up to ``wave_cap``."""
    order = np.arange(n)
    waves: List[np.ndarray] = [order[:1]]
    pos, size = 1, 8
    while pos < n:
        take = min(size, wave_cap, n - pos)
        waves.append(order[pos : pos + take])
        pos += take
        size *= 8
    return waves


def resolve_build_knobs(n: int, ef_construction: int, expand: int,
                        wave_cap, beam_steps, route_steps):
    """``"auto"`` wave_cap / beam_steps / route_steps as the JAX package
    resolves them: waves of 4096 at >= 512k rows, 2048 at >= 64k, else
    1024; beam steps max(12, ceil(efc / expand)); routing steps 16."""
    if wave_cap == "auto":
        wave_cap = 4096 if n >= 512_000 else (2048 if n >= 64_000 else 1024)
    if beam_steps == "auto":
        beam_steps = max(12, math.ceil(ef_construction / max(1, expand)))
    if route_steps == "auto":
        route_steps = 16
    return wave_cap, beam_steps, route_steps


def build_graph(
    vectors,
    num_layers: int,
    ef_construction: int,
    m: int,
    seed: int = 0,
    wave_cap: int | str = "auto",
    slack: int | None = None,
    n_valid: int | None = None,
    expand: int = 8,
    route_expand: int = 8,
    route_layers: bool = True,
    nav_dtype: str = "bfloat16",
    dedup_self: bool = False,
    beam_steps: int | None = "auto",
    route_steps: int | None = "auto",
    as_arrays: bool = False,
    route_scan: bool = False,
    seed_count: int = 1,
    scan_chunk: int = 16384,
    insert_inline: bool = False,
    inline_dp: int = 32,
    inline_refine: int = 64,
    inline_steps: int | None = None,
    device=None,
    timings: dict | None = None,
):
    """Run the full batched build. Returns (ins_layers (n,), per-layer
    adjacency dict {global_id: [(nbr_global_id, dist), ...]}).

    ``as_arrays=True`` returns per-layer ``(member_ids (m,), adj
    (m, deg+slack) int32 global ids, dist (m, deg+slack) f32)`` numpy
    triples instead; the index materializes dicts lazily only for
    host-path consumers (save/add/single-query).

    ``vectors``: a numpy (n, d) array, uploaded to ``device`` (the first
    CUDA card when None), or a torch tensor already padded to a row
    multiple of 128 (``n_valid`` live rows), built on where it lies.

    ``beam_steps="auto"`` caps insertion beams at max(12,
    ceil(efc/expand)) steps; None = 4*efc; an int overrides.

    ``route_scan`` (with two or more layers): exact scans route the
    construction (see ``make_wave_step``). Layer l's built members are
    the first ``searchsorted(members[l], wave_start)`` rows of a static
    member table (nav rows in ascending global id, power-of-two rows
    whose padding repeats member 0 and lies past the built prefix);
    each upper layer's candidates come from a top-``min(efc, rows)``
    scan of that prefix and the layer-0 beam's ``seed_count`` seeds from
    a scan of layer 1's. ``scan_chunk`` is the plain version's corpus
    chunk (the kernel tiles itself).

    ``insert_inline``: the layer-0 insertion beam runs on a
    construction-time inline table, (rows0, deg0 + slack, ``inline_dp``)
    bf16 next to the nav table, kept slot for slot with the adjacency
    (``_beam_inline``, ``inline_refine`` exact rows a step,
    ``inline_steps`` steps, else ``beam_steps``), on the top
    ``inline_dp`` PCA components of the nav rows. A table over 8 GiB
    (counted as the JAX package counts it) raises ValueError.
    ``route_scan`` with ``insert_inline`` raises NotImplementedError, as
    in the JAX package: they are two layer-0 paths.

    ``timings``, if given, receives the seconds of the upload and of
    the waves (host clock, ending in a device sync), and with
    ``insert_inline`` the inline table's bytes."""
    import time

    t0 = time.perf_counter()
    if isinstance(vectors, torch.Tensor):
        n_pad = vectors.shape[0]
        n = int(n_valid) if n_valid is not None else n_pad
        vecs = vectors.float()
        dev = vecs.device
    else:
        vectors = np.asarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        n_pad = round_up(max(n, 1), 128)
        vecs = None
        dev = resolve_device(device)
    if n == 0:
        if as_arrays:
            empty = (
                np.zeros((0,), np.int64),
                np.zeros((0, 1), np.int32),
                np.zeros((0, 1), np.float32),
            )
            return np.zeros((0,), np.int64), [empty] * num_layers
        return np.zeros((0,), np.int64), [dict() for _ in range(num_layers)]
    slack = slack if slack is not None else max(m, 8)
    wave_cap, beam_steps, route_steps = resolve_build_knobs(
        n, ef_construction, expand, wave_cap, beam_steps, route_steps)
    ins = draw_insertion_layers(n, num_layers, m, seed)
    ins[0] = num_layers - 1  # first node joins every layer (hnsw.rs:417-429)

    if vecs is None:
        vecs = torch.zeros((n_pad, vectors.shape[1]), dtype=torch.float32,
                           device=dev)
        vecs[:n] = torch.from_numpy(vectors).to(dev)
    # navigation table: the wave beams and the selection heuristic are
    # bound by their row gathers, so a bf16 copy halves the dominant
    # cost; distances accumulate in f32. The f32 corpus is never
    # gathered during construction.
    if nav_dtype != "float32":
        vecs = vecs.to(getattr(torch, nav_dtype))

    rank_maps, adjs, dists, degs = [], [], [], []
    members: List[np.ndarray] = []
    for l in range(num_layers):
        mem = np.where(ins >= l)[0]
        members.append(mem)
        rank = np.full((n_pad,), -1, np.int32)
        rank[mem] = np.arange(len(mem), dtype=np.int32)
        rank_maps.append(torch.from_numpy(rank).to(dev))
        # +1: the heuristic admits m+1 (quirk parity)
        deg = (2 * m if l == 0 else m) + 1
        degs.append(deg)
        rows = len(mem) + 1  # + the dump row
        adjs.append(torch.full((rows, deg + slack), -1, dtype=torch.int32,
                               device=dev))
        dists.append(torch.full((rows, deg + slack), _INF, dtype=torch.float32,
                                device=dev))

    # construction-time inline table: layer-0 rows (+ the dump row), the
    # full adjacency width (slot alignment with adj, see _commit_edges)
    inline_args = ()
    if insert_inline:
        if route_scan:
            raise NotImplementedError(
                "insert_inline + route_scan are separate layer-0 paths; "
                "pick one (insert_inline implies classic routing beams)")
        from vers_tpu_torch.ops.beam_inline import pca_projection, project_rows

        width0 = degs[0] + slack
        table_bytes = _pow2_rows(len(members[0])) * width0 * inline_dp * 2
        if table_bytes > _INLINE_BUILD_MAX_BYTES:
            raise ValueError(
                f"construction inline table would be "
                f"{table_bytes / 2**30:.1f} GB ({len(members[0])} rows x "
                f"width {width0} x dp {inline_dp} bf16) > the "
                f"{_INLINE_BUILD_MAX_BYTES / 2**30:.1f} GB guard; "
                f"reduce inline_dp or disable insert_inline")
        basis = pca_projection(vecs, inline_dp)
        proj = project_rows(vecs, basis, inline_dp)
        inline_tab = torch.zeros((adjs[0].shape[0], width0, inline_dp),
                                 dtype=torch.bfloat16, device=dev)
        inline_args = (inline_tab, proj, basis)

    # static member tables of the layers >= 1 for route_scan, rows in
    # members[l] order (ascending global id), so the built prefix at any
    # wave is contiguous
    scan_tables = None
    if route_scan and num_layers > 1:
        tabs, tab_members = [None], [None]  # layer 0 is never scanned
        for l in range(1, num_layers):
            mem_pad = np.zeros((_pow2_rows(len(members[l])),), np.int64)
            mem_pad[: len(members[l])] = members[l]
            mids = torch.from_numpy(mem_pad).to(dev)
            tabs.append(vecs[mids])
            tab_members.append(mids)
        scan_tables = (tabs, tab_members)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    step_fns = {}
    entry = 0
    layer_sizes = tuple(len(mem) for mem in members)
    waves = wave_schedule(n, wave_cap)[1:]
    for wave in waves:
        wsz = len(wave)
        # sort wave rows by insertion layer DESC so layer-l inserters
        # form a prefix; intra-wave order has no other effect (the wave
        # builds against the frozen prior graph)
        wave = wave[np.argsort(-ins[wave], kind="stable")]
        bucket, caps = wave_caps(ins[wave], num_layers, m, wsz, wave_cap,
                                 route_layers)
        if caps not in step_fns:
            step_fns[caps] = make_wave_step(
                num_layers, m, ef_construction, degs, slack,
                sub_caps=caps, layer_sizes=layer_sizes,
                expand=expand, route_expand=route_expand,
                dedup_self=dedup_self, beam_steps=beam_steps,
                route_steps=route_steps,
                route_scan=scan_tables is not None, seed_count=seed_count,
                scan_chunk=scan_chunk, insert_inline=insert_inline,
                inline_refine=inline_refine, inline_steps=inline_steps,
            )
        ids = torch.from_numpy(wave.astype(np.int64)).to(dev)
        ins_w = torch.from_numpy(ins[wave].astype(np.int64)).to(dev)
        extra = inline_args
        if scan_tables is not None:
            # built-prefix row counts per layer (waves are contiguous id
            # ranges, so the wave's first id bounds the built members)
            n_built = [int(np.searchsorted(mem, int(wave.min())))
                       for mem in members]
            extra = (*scan_tables, n_built)
        with trace.span("hnsw.wave"):
            step_fns[caps](vecs, rank_maps, adjs, dists, ids, ins_w, entry,
                           *extra)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if timings is not None:
        timings.update(upload_s=t1 - t0, waves_s=time.perf_counter() - t1,
                       waves=len(waves),
                       wave_cap=wave_cap)
        if inline_args:
            timings["inline_table_bytes"] = (inline_args[0].numel()
                                             * inline_args[0].element_size())

    if as_arrays:
        return ins, [
            (
                members[l],
                adjs[l][: len(members[l])].cpu().numpy(),
                dists[l][: len(members[l])].cpu().numpy(),
            )
            for l in range(num_layers)
        ]

    # pull back to host adjacency dicts
    out_layers = []
    for l in range(num_layers):
        adj_h = adjs[l].cpu().numpy()
        dist_h = dists[l].cpu().numpy()
        layer = {}
        for rank_pos, gid in enumerate(members[l]):
            row = adj_h[rank_pos]
            dr = dist_h[rank_pos]
            layer[int(gid)] = [
                (int(row[j]), float(dr[j]))
                for j in range(row.shape[0])
                if row[j] >= 0 and np.isfinite(dr[j])
            ]
        out_layers.append(layer)
    return ins, out_layers
