"""Neighbourhood-inlined beam search — the counterpart of
``vers_tpu.ops.beam_inline``, for the HNSW layer-0 beam at large n.

The classic beam step (``ops/beam.beam_search_layer``) gathers
``Q * expand * deg`` individual neighbour rows per iteration. Here a
build-time INLINE table holds, for every node v, the concatenation of
v's neighbours' PCA-projected, renormalized bf16 vectors:

    inline[v] = concat(proj[adj[v, 0]], ..., proj[adj[v, deg-1]])
                                                    (n_pad, deg * dp)

One beam step then gathers ``Q * expand`` wide rows plus the same
(Q, expand) adjacency rows, and scores all ``expand * deg`` candidates
with one batched dot product in the projected space. With
``refine_r > 0`` (the default through ``HNSWConfig``) the projection
only filters: the top ``refine_r`` candidates are gathered full-dim
(bf16) and merged on their exact distances, so the beam ranks in exact
space end to end. The caller rescores the final beam in f32.

The step has two versions with one result up to the order of f32 sums:
the plain step below (PyTorch ops), and one hand-written CUDA kernel
(``csrc/beam_step.cu``, launched by ``cuda_beam_step``) that does the
whole step for every query in one launch and updates the state in
place. ``inline_step`` takes the kernel for CUDA tensors whose widths
``beam_step_takes`` accepts and the plain step otherwise; both are
counted (``LAUNCHES``, ``LAUNCHES_PLAIN``).

Reference being re-expressed: the layer search `vers/src/indexes/
hnsw.rs:242-307` (same beam/visited semantics as ``beam_search_layer``).
"""

from __future__ import annotations

import numpy as np
import torch

from vers_tpu_torch import graphs, trace
from vers_tpu_torch.core import count
from vers_tpu_torch.ops import _build
from vers_tpu_torch.ops.beam import (
    cosine_to,
    in_beam,
    init_beam,
    loop_beam,
    merge_beam,
    pick_unexpanded,
    repeats_earlier,
    rescore_cosine,
    run_beam,
    scan_seeds,
    take_rows,
)
from vers_tpu_torch.ops.distance import _check_f32_matmul
from vers_tpu_torch.ops.topk import topk_smallest

_INF = float("inf")

# Steps of the inline beam, counted by ``core.count`` (shards step from
# several threads at once): the kernel's launches, and the plain step's
# (CPU tensors, and widths or dtypes outside ``beam_step_takes``).
LAUNCHES = 0
LAUNCHES_PLAIN = 0

# The step kernel's range (csrc/beam_step.cu): the inline table's widths,
# the beam's, the candidates of a step (e * deg) and the full-dim rows'.
STEP_DPS = (32, 64)
STEP_MAX_EF = 256
STEP_MAX_CANDIDATES = 512
STEP_MAX_D = 1024


def pca_projection(corpus: torch.Tensor, dp: int, sample: int = 131072):
    """Top-``dp`` PCA basis of the corpus (n_pad, d) -> (d, dp) f32 on
    the corpus's device.

    The covariance is one (d, d) f32 matmul over the first ``sample``
    rows, on the corpus's device with TF32 off; the eigendecomposition
    runs on the host with numpy, as in the JAX package (an eigensolver
    on the device may return other signs and orders of near-equal
    eigenvectors). No centering: rows are unit-norm and the beam only
    needs a rotation that concentrates dot-product energy in few dims."""
    s = min(sample, corpus.shape[0])
    xs = corpus[:s].float()
    _check_f32_matmul(xs)
    cov = (xs.T @ xs).cpu().numpy()
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    basis = vecs[:, ::-1][:, :dp].copy()  # (d, dp) top components
    return torch.from_numpy(basis.astype(np.float32)).to(corpus.device)


def project_rows(vecs: torch.Tensor, basis: torch.Tensor, dp: int,
                 row_chunk: int = 1 << 18) -> torch.Tensor:
    """(m, d) x (d, dp) -> renormalized (m, dp) bf16 rows (zero rows
    stay zero); f32 products with TF32 off, in row chunks."""
    _check_f32_matmul(basis)
    out = torch.empty((vecs.shape[0], dp), dtype=torch.bfloat16,
                      device=vecs.device)
    for r0 in range(0, vecs.shape[0], row_chunk):
        p = vecs[r0 : r0 + row_chunk].float() @ basis[:, :dp]
        norm = torch.linalg.vector_norm(p, dim=1, keepdim=True)
        out[r0 : r0 + row_chunk] = (p / torch.clamp_min(norm, 1e-12)).to(
            torch.bfloat16)
    return out


def build_inline_table(proj: torch.Tensor, adj: torch.Tensor, dp: int,
                       row_chunk: int = 65536, max_bytes: int = 8 << 30):
    """(n_pad, dp) projected rows + (n_pad, deg) adjacency ->
    (n_pad, deg * dp) bf16 inline table (-1 neighbours -> zero blocks,
    which renormalization never produces; the id mask in the step
    drops them anyway).

    Chunked over rows, so no (n_pad, deg, dp) intermediate exists.
    ``max_bytes`` guards the allocation: refuse loudly (pick a smaller
    dp, or let nav_inline_dp="auto" budget it)."""
    n_pad, deg = adj.shape
    table_bytes = n_pad * deg * dp * 2
    if table_bytes > max_bytes:
        raise ValueError(
            f"inline table would be {table_bytes / 2**30:.1f} GB "
            f"({n_pad} rows x deg {deg} x dp {dp} bf16) "
            f"> the {max_bytes / 2**30:.1f} GB guard; reduce "
            f"nav_inline_dp (or use 'auto', which budgets it via "
            f"inline_hbm_budget_gb)"
        )
    out = torch.empty((n_pad, deg * dp), dtype=torch.bfloat16,
                      device=proj.device)
    rows_p = proj.shape[0]
    for r0 in range(0, n_pad, row_chunk):
        rows = adj[r0 : r0 + row_chunk].long()
        v = proj[rows.clamp(0, rows_p - 1)]              # (chunk, deg, dp)
        v = v.masked_fill((rows < 0)[:, :, None], 0)
        out[r0 : r0 + row_chunk] = v.reshape(rows.shape[0], deg * dp)
    return out


def inline_dots(inline_tab: torch.Tensor, rows: torch.Tensor,
                queries_p: torch.Tensor, dp: int) -> torch.Tensor:
    """(Q, E*deg) f32 projected dots: the wide rows ``rows`` (Q, E) of
    the inline table against the (Q, dp) bf16 projected queries, bf16
    products summed in f32."""
    q_n, e = rows.shape
    blocks = take_rows(inline_tab, rows).reshape(q_n, -1, dp)  # (Q, E*deg, dp)
    return torch.bmm(blocks.float(), queries_p.float()[:, :, None])[:, :, 0]


def beam_search_layer_inline(
    queries_p,    # (Q, dp) bf16 projected+renormalized queries
    inline_tab,   # (n_pad, deg * dp) bf16 inline neighbourhood table
    adj,          # (n_pad, deg) int neighbour ids, -1 pad
    entry,        # (Q, S) seed nodes (-1 pad)
    entry_d,      # (Q, S) f32 seed distances (projected space, or exact
                  #         bf16 when refining — must match the beam's)
    ef: int,
    max_steps: int,
    expand_per_step: int = 8,
    refine_r: int = 0,
    queries_nav=None,  # (Q, d) bf16 full-dim (required when refining)
    vecs_nav=None,     # (n_pad, d) bf16 full-dim nav table (ditto)
    sync_every: int = 4,
):
    """``beam_search_layer`` with the inline-neighbourhood step: same
    beam / visited semantics.

    ``refine_r == 0``: distances are projected cosine throughout.
    ``refine_r > 0`` (exact-refine): each step scores all expand*deg
    candidates in projected space, keeps the top ``refine_r``, gathers
    only those full-dim bf16 rows, and merges with their exact
    distances; the beam ranks and retains in exact space (seeds
    included)."""
    state = init_beam(entry, ef, None, entry_d)
    step = inline_step(queries_p, inline_tab, adj, ef, expand_per_step,
                       refine_r, queries_nav, vecs_nav)
    beam_d, beam_i, _ = run_beam(state, step, max_steps, sync_every)
    return beam_d, beam_i


def beam_step_takes(ef: int, e: int, deg: int, dp: int, r: int, d: int,
                    bf16: bool = True) -> bool:
    """Whether the step kernel takes a step of these widths: ``e``
    entries expanded a step of an ``ef``-wide beam, ``deg`` neighbours
    each, the inline table ``dp`` wide, ``r`` candidates refined on
    ``d``-wide full-dim rows (``d`` unused when ``r`` is 0); ``bf16``:
    the queries and tables the step reads are bf16."""
    m = e * deg
    return (bf16 and dp in STEP_DPS and 1 <= e <= ef <= STEP_MAX_EF
            and 1 <= m <= STEP_MAX_CANDIDATES and 0 <= r <= m
            and (r == 0 or 1 <= d <= STEP_MAX_D))


def _load_width(vecs_nav: torch.Tensor) -> int:
    """bf16 values a full-dim load of the kernel takes: the widest of 8,
    4 and 2 that divides the row width and the table's address (in
    values), else 1."""
    d = vecs_nav.shape[1]
    for vw in (8, 4, 2):
        if d % vw == 0 and vecs_nav.data_ptr() % (2 * vw) == 0:
            return vw
    return 1


def _check_step_inputs(state, queries_p, adj, inline_tab, ef, r, queries_nav,
                       vecs_nav):
    beam_d, beam_i, expanded = state
    q_n, dp = queries_p.shape
    n_pad, deg = adj.shape
    want = [(beam_d, torch.float32, (q_n, ef)), (beam_i, torch.int64, (q_n, ef)),
            (expanded, torch.bool, (q_n, ef)),
            (queries_p, torch.bfloat16, (q_n, dp)),
            (adj, torch.int32, (n_pad, deg)),
            (inline_tab, torch.bfloat16, (n_pad, deg * dp))]
    if r:
        d = vecs_nav.shape[1]
        want += [(queries_nav, torch.bfloat16, (q_n, d)),
                 (vecs_nav, torch.bfloat16, (n_pad, d))]
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != queries_p.device or not t.is_contiguous()):
            raise ValueError(f"the beam step kernel takes a contiguous {dtype} "
                             f"{shape} on {queries_p.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for t in (queries_p, inline_tab):
        if t.data_ptr() % 16:
            raise ValueError("the beam step kernel takes 16-byte aligned "
                             "projected queries and inline table")


def cuda_beam_step(state, queries_p, adj, inline_tab, ef: int, e: int, r: int,
                   queries_nav=None, vecs_nav=None):
    """One step of the inline beam by the kernel (``csrc/beam_step.cu``)
    for CUDA tensors of widths ``beam_step_takes`` accepts: ``e``
    entries expanded, ``r`` candidates refined (the plain step's ``e``
    and ``r``). The new state is written into ``state``'s own tensors.
    Returns (state, active), ``active`` a 0-d bool tensor as the plain
    step's. Raises on inputs the kernel does not take."""
    _check_step_inputs(state, queries_p, adj, inline_tab, ef, r, queries_nav,
                       vecs_nav)
    beam_d, beam_i, expanded = state
    q_n, dp = queries_p.shape
    n_pad, deg = adj.shape
    dev = queries_p.device
    active = torch.zeros((), dtype=torch.bool, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.vers_beam_step(
            beam_d.data_ptr(), beam_i.data_ptr(), expanded.data_ptr(),
            queries_p.data_ptr(), queries_nav.data_ptr() if r else None,
            adj.data_ptr(), inline_tab.data_ptr(),
            vecs_nav.data_ptr() if r else None, active.data_ptr(),
            q_n, ef, e, deg, n_pad, dp, r, vecs_nav.shape[1] if r else 0,
            _load_width(vecs_nav) if r else 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_beam_step")
    count(globals(), "LAUNCHES")
    return (beam_d, beam_i, expanded), active


def inline_step(queries_p, inline_tab, adj, ef: int, expand_per_step: int,
                refine_r: int = 0, queries_nav=None, vecs_nav=None):
    """The inline beam's step (see ``beam_search_layer_inline``):
    ``step(state) -> (state, active)``. On CUDA tensors whose widths and
    dtypes ``beam_step_takes`` accepts, the step kernel
    (``cuda_beam_step``, which writes the new state into the old one's
    tensors); otherwise ``plain_step``."""
    dp = queries_p.shape[1]
    deg = adj.shape[1]
    e = max(1, min(expand_per_step, ef))
    r = min(refine_r, e * deg) if refine_r else 0
    bf16 = (queries_p.dtype == inline_tab.dtype == torch.bfloat16
            and (not r or queries_nav.dtype == vecs_nav.dtype == torch.bfloat16))
    if queries_p.is_cuda and beam_step_takes(
            ef, e, deg, dp, r, vecs_nav.shape[1] if r else 0, bf16):
        adj32 = adj.to(torch.int32).contiguous()

        def kernel_step(state):
            return cuda_beam_step(state, queries_p, adj32, inline_tab, ef, e,
                                  r, queries_nav, vecs_nav)

        return kernel_step
    return plain_step(queries_p, inline_tab, adj, ef, e, r, queries_nav,
                      vecs_nav)


def plain_step(queries_p, inline_tab, adj, ef: int, e: int, r: int,
               queries_nav=None, vecs_nav=None):
    """The inline beam's step in PyTorch ops, ``e`` entries expanded and
    ``r`` candidates refined a step (``inline_step`` resolves both):
    ``step(state) -> (state, active)``, counted in ``LAUNCHES_PLAIN``."""
    q_n, dp = queries_p.shape
    n_pad, deg = adj.shape

    def step(state):
        count(globals(), "LAUNCHES_PLAIN")
        beam_d, beam_i, expanded = state
        picked, has, expanded = pick_unexpanded(beam_d, beam_i, expanded, e)
        safe = picked.clamp(0, n_pad - 1)
        nbrs = take_rows(adj, safe).long()                    # (Q, E, deg)
        nbrs = torch.where(has[:, :, None], nbrs, -1).reshape(q_n, e * deg)
        # E wide rows per query instead of E*deg thin ones
        dots = inline_dots(inline_tab, safe, queries_p, dp)
        nd = torch.where(nbrs >= 0, 1.0 - dots, _INF)
        dup = in_beam(nbrs, beam_i) | repeats_earlier(nbrs)
        nd = nd.masked_fill(dup & (nbrs >= 0), _INF)
        if r:
            # the projection gates the top-r candidates; the beam
            # merges on their exact bf16 full-dim distances
            sc, sel = topk_smallest(nd, r)
            cand = torch.where(torch.isfinite(sc), nbrs.gather(1, sel), -1)
            nd = cosine_to(vecs_nav, cand, queries_nav)
            nbrs = cand
        beam_d, beam_i, expanded, active = merge_beam(
            beam_d, beam_i, expanded, nd, nbrs, ef)
        return (beam_d, beam_i, expanded), active

    return step


def full_descent_scan_inline(
    queries,      # (Q, d) f32
    vecs_f32,     # (n_pad, d) f32 rescore table
    vecs_nav,     # (n_pad, d) bf16 full-dim nav table (refine path)
    basis,        # (d, dp) f32 PCA basis
    proj,         # (n_pad, dp) bf16 projected+renormalized node rows
    inline_tab,   # (n_pad, deg * dp) bf16
    adj0,         # (n_pad, deg) int
    l1_tab,       # (n1_pad, d) bf16 layer-1 rows
    l1_members,   # (n1_pad,)
    n1: int,
    top_k: int,
    ef: int,
    seeds: int,
    expand: int = 8,
    steps_cap=None,
    refine_r: int = 0,
    site=None,
):
    """``full_descent_scan`` with the inline layer-0 beam: the exact
    routing scan over layer 1 (kernel A on the card) for the seeds, the
    inline beam (projected, or projection-filtered exact when
    ``refine_r`` > 0), then an exact f32 rescore of the whole ef-wide
    beam. ``site`` as ``ops/beam.full_descent_scan`` takes it."""
    dp = proj.shape[1]
    n_pad = proj.shape[0]

    def prelude(q):
        with trace.stage("route", q.device):
            scan_d, seed_ids = scan_seeds(q, l1_tab, l1_members, n1,
                                          min(seeds, ef))
            qp = project_rows(q, basis, dp)
            if refine_r:
                # the refined beam ranks in exact bf16 space — so do the
                # seeds
                sd = scan_d
            else:
                # the pure-projected beam ranks in projected space — ditto
                sv = proj[seed_ids.clamp(0, n_pad - 1)].float()
                sd = 1.0 - torch.bmm(sv, qp.float()[:, :, None])[:, :, 0]
            out = (qp, q.to(torch.bfloat16),
                   *init_beam(seed_ids, ef, None, sd))
        trace.mark("beam", q.device)
        return out

    def make_step(qp, qn):
        return inline_step(qp, inline_tab, adj0, ef, min(max(1, expand), ef),
                           refine_r, qn, vecs_nav)

    def tail(q, beam_d, beam_i):
        # the projected ranking is noisier than bf16 full-dim navigation:
        # exact-rescore the WHOLE ef-wide beam, then take top_k
        with trace.stage("rescore", q.device):
            rd, ri = rescore_cosine(q, vecs_f32, beam_i, ef)
            return rd[:, :top_k], ri[:, :top_k]

    qp, qn, *state = graphs.run(site, "prelude", prelude, queries)
    with trace.span("beam"):
        beam_d, beam_i = loop_beam(site, "beam", state, make_step, (qp, qn),
                                   steps_cap or max(4 * ef, 64))
    return graphs.run(site, "tail", tail, queries, beam_d, beam_i)
