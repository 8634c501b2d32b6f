"""Top-k selection and the fused distance+top-k corpus scan as plain
torch ops (counterpart of ``vers_tpu.ops.topk``).

``fused_scan_topk`` is the plain version of kernel A
(``ops/cuda_topk.py``): it streams the corpus through the distance
matmul in chunks and carries a running (Q, k) best set, so the full
(Q, N) distance matrix is never materialized; its ``precision`` rounds
the products as the TPU's settings do (``product_operands``).
``topk_values_plain`` is kernel C's plain version.
``split_scan_topk_plain`` (kernel A's split design) and ``tf32_split``
(its operand split) serve the tests only. ``ordered_value_keys`` and
``topk_values_stream_plain`` (kernel C's key and its
threshold-and-buffer walk) serve the tests likewise.
``approx_scan_topk`` is the flat index's ``engine="approx"``.
``repeats_earlier`` is the id-dedup mask of the graph beam and the
binned merge.
"""

from __future__ import annotations

import torch

from vers_tpu_torch.ops.distance import pairwise_distance, pairwise_dot


def topk_smallest(dist: torch.Tensor, k: int):
    """Smallest-k along the last axis. Returns (values, indices int64),
    ascending by distance; ties go to the lowest index, matching the
    reference's stable sorts. ``torch.topk`` promises no tie order, so
    k == 1 is an argmin (first minimum) and larger k a stable sort."""
    if k == 1:
        idx = torch.argmin(dist, dim=-1, keepdim=True)
        return torch.gather(dist, -1, idx), idx
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def repeats_earlier(ids: torch.Tensor) -> torch.Tensor:
    """(Q, m) bool: True where the same id stands at a lower column of
    its row (the JAX package's ``ncol < nrow`` mask), by a stable sort
    instead of the (Q, m, m) comparison."""
    s, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.zeros_like(rep).scatter_(1, order, rep)


PRECISIONS = ("highest", "high", "default")


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Values rounded to bf16 (to nearest, ties to even), held in f32."""
    return t.float().to(torch.bfloat16).float()


def product_operands(queries: torch.Tensor, corpus: torch.Tensor,
                     precision: str = "highest"):
    """(a, b), f32, such that the f32 product ``a @ b.T`` is kernel A's
    ``q . x`` at ``precision``, the TPU's meaning of the setting:
    "highest" the f32 operands as given (a bf16 corpus widened);
    "default" both rounded to bf16, one product; "high" the bf16_3x
    split ``v = hi + lo`` (hi = bf16(v), lo = bf16(v - hi)) with
    ``hi.hi + hi.lo + lo.hi`` as one product over three times the
    features. Every product of two bf16 values is exact in f32."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    q, x = queries.float(), corpus.float()
    if precision == "highest":
        return q, x
    qh, xh = bf16_round(q), bf16_round(x)
    if precision == "default":
        return qh, xh
    ql, xl = bf16_round(q - qh), bf16_round(x - xh)
    return torch.cat([qh, qh, ql], dim=1), torch.cat([xh, xl, xh], dim=1)


def scan_distance(queries: torch.Tensor, x: torch.Tensor, metric: str,
                  precision: str = "highest") -> torch.Tensor:
    """Kernel A's distances of a corpus chunk at ``precision``: the
    precision rounds only ``q . x``; |q|^2 and |x|^2 are f32 sums of the
    operands as given (``pallas_topk._kernel``)."""
    if precision == "highest":
        return pairwise_distance(queries, x, metric)
    a, b = product_operands(queries, x, precision)
    dot = pairwise_dot(a, b)
    if metric == "cosine":
        return 1.0 - dot
    if metric != "sq_euclidean":
        raise ValueError(f"unknown metric {metric!r}")
    qf, xf = queries.float(), x.float()
    qq = torch.sum(qf * qf, dim=1, keepdim=True)
    xx = torch.sum(xf * xf, dim=1)
    return torch.clamp_min(qq + xx[None, :] - 2.0 * dot, 0.0)


def fused_scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
    precision: str = "highest",
):
    """Exact top-k nearest corpus rows for each query, O(Q*k + chunk)
    memory.

    Args:
      queries: (Q, d) f32
      corpus: (N_pad, d) f32 or bf16 — rows >= n_valid are padding and
        are ignored.
      n_valid: number of live corpus rows.
      k: neighbours per query.
      metric: "sq_euclidean" | "cosine".
      chunk_size: corpus rows per scan step.
      precision: "highest" | "high" | "default", as ``scan_distance``.

    Returns:
      (dists (Q, k) f32, indices (Q, k) int32), ascending by distance.
      If k > n_valid the tail is (+inf, -1).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    n_pad = corpus.shape[0]
    q_n = queries.shape[0]
    dev = queries.device
    chunk = max(1, min(chunk_size, n_pad))
    best_d = torch.full((q_n, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((q_n, k), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, n_pad, chunk):
        x = corpus[c0 : c0 + chunk]
        rows = torch.arange(c0, c0 + x.shape[0], dtype=torch.int32, device=dev)
        dist = scan_distance(queries, x, metric, precision)
        dist = torch.where(rows[None, :] < n_valid, dist, float("inf"))
        cand_d = torch.cat([best_d, dist], dim=1)
        cand_i = torch.cat([best_i, rows[None, :].expand(q_n, -1)], dim=1)
        best_d, sel = topk_smallest(cand_d, k)
        best_i = torch.gather(cand_i, 1, sel)
        best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


def topk_values_plain(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Kernel C's plain version: the k smallest of each row of ``vals``
    (Q, W) f32 with the matching entries of ``ids`` (Q, W) int32, as
    (vals (Q, k) ascending, ids (Q, k)). Equal values keep column order
    (a stable sort); ids are -1 where the value is inf; k > W pads with
    (+inf, -1)."""
    kk = min(k, vals.shape[1])
    out_d, sel = topk_smallest(vals, kk)
    out_i = torch.gather(ids, 1, sel)
    out_i = torch.where(torch.isfinite(out_d), out_i, -1)
    if kk < k:
        out_d = torch.nn.functional.pad(out_d, (0, k - kk), value=float("inf"))
        out_i = torch.nn.functional.pad(out_i, (0, k - kk), value=-1)
    return out_d, out_i


def ordered_value_keys(vals: torch.Tensor) -> torch.Tensor:
    """Kernel C's sort key as a torch function: int64 keys (Q, W) whose
    ascending order is a stable sort of each row by value. The high word
    is the value's bits mapped to an unsigned integer that rises with the
    float (negative floats: all bits flipped; others: the sign bit set),
    with -0.0 keyed as +0.0 since the two compare equal; the low word is
    the column. The kernel packs (high << 32) | column into 64 unsigned
    bits; int64 is signed, so here the shift is 31 (columns are below
    2^31) and every key stays non-negative, in the same order."""
    v = vals.to(torch.float32).contiguous()
    bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(v == 0, torch.zeros_like(bits), bits)
    neg = (bits >> 31) == 1
    high = torch.where(neg, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    col = torch.arange(v.shape[-1], dtype=torch.int64, device=v.device)
    return (high << 31) | col


def topk_values_stream_plain(vals: torch.Tensor, ids: torch.Tensor, k: int,
                             cap: int, step: int = 128):
    """Kernel C's walk in plain Python, for the tests: each row streams
    in steps of ``step`` columns held four to a lane (lane j: columns
    4 j .. 4 j + 3), one ballot per component; an entry whose key is
    below the key of the row's current k-th entry is appended to a
    buffer of ``cap`` keys, and a full buffer is sorted and cut to its k
    smallest, which sets the new k-th key. Same result as
    ``topk_values_plain``."""
    q_n, w = vals.shape
    keys = ordered_value_keys(vals).tolist()
    rows = vals.tolist()
    inf = float("inf")
    out_d = torch.full((q_n, k), inf, dtype=torch.float32)
    out_i = torch.full((q_n, k), -1, dtype=torch.int32)
    for r in range(q_n):
        buf, thr_key = [], None

        def passing(cols):
            return [c for c in cols if rows[r][c] < inf
                    and (thr_key is None or keys[r][c] < thr_key)]

        for c0 in range(0, w, step):
            for j in range(4):
                cols = range(c0 + j, min(c0 + step, w), 4)
                new = passing(cols)
                if len(buf) + len(new) > cap:
                    buf = sorted(buf)[:k]
                    thr_key = buf[k - 1] if len(buf) == k else None
                    new = passing(cols)
                buf += [keys[r][c] for c in new]
                assert len(buf) <= cap
        for t, key in enumerate(sorted(buf)[:k]):
            c = key & 0x7FFFFFFF
            out_d[r, t] = vals[r, c]
            out_i[r, t] = ids[r, c] if torch.isfinite(vals[r, c]) else -1
    return out_d.to(vals.device), out_i.to(vals.device)


def split_scan_topk_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    split_rows: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 16384,
):
    """Kernel A's two-pass design in plain torch, for the tests: the
    corpus rows [0, N) cut into contiguous splits of ``split_rows``,
    ``fused_scan_topk`` over each (rows >= n_valid ignored), then
    ``topk_values_plain`` over the (Q, S * k) table of the splits' best
    sets laid out in ascending row order. Same result as
    ``fused_scan_topk``, ties included."""
    n_rows = corpus.shape[0]
    n_valid = max(0, min(int(n_valid), n_rows))
    vals, ids = [], []
    for r0 in range(0, max(n_rows, 1), split_rows):
        r1 = min(r0 + split_rows, n_rows)
        d, i = fused_scan_topk(queries, corpus[r0:r1], max(0, n_valid - r0), k,
                               metric=metric, chunk_size=chunk_size)
        vals.append(d)
        ids.append(torch.where(i >= 0, i + r0, i))
    return topk_values_plain(torch.cat(vals, dim=1), torch.cat(ids, dim=1), k)


def tf32_split(x: torch.Tensor):
    """Kernel A's 3xTF32 operand split, emulated: (hi, lo) f32 as the
    tensor core reads them. hi is x rounded to tf32 (10 mantissa bits)
    to nearest, ties away from zero, as PTX's ``cvt.rna.tf32.f32``; lo is
    x - hi (exact) truncated to tf32. For the tests; finite inputs only."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(torch.int64)
    # sign-magnitude: adding half an ulp to the bits rounds the magnitude
    hi = ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)
    lo = (x - hi).view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def approx_scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = 32768,
):
    """The flat ``engine="approx"`` scan: top-k per corpus chunk, then
    one top-k over the collected k-per-chunk candidates. Same arguments
    and return convention as ``fused_scan_topk``.

    The JAX package takes each chunk's k with ``lax.approx_min_k`` (the
    TPU's PartialReduce, recall ~0.99) on bf16 products. No such op
    exists here: each chunk's top-k is exact (``torch.topk``), in
    float32 with TF32 off, which is what ``approx_min_k`` computes on
    the CPU. Equal distances come out lowest row first, except that a
    tie at a chunk's k-th place may keep any of the tied rows. The
    squared query norm is left out of the scan (it does not change a
    query's ranking) and added back at the end, as in the JAX package.
    """
    if metric not in ("sq_euclidean", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    n_pad = corpus.shape[0]
    chunk = max(1, min(chunk_size, n_pad))
    cand_d, cand_i = [], []
    for c0 in range(0, n_pad, chunk):
        x = corpus[c0 : c0 + chunk].float()  # a bf16 corpus widened
        # in place on the (Q, chunk) product: one buffer of that size
        dist = pairwise_dot(queries, x)
        if metric == "cosine":
            dist.neg_().add_(1.0)
        else:
            dist.mul_(-2.0).add_(torch.sum(x * x, dim=1)[None, :])
        if n_valid < c0 + x.shape[0]:
            dist[:, max(0, n_valid - c0):] = float("inf")
        bd, sel = torch.topk(dist, min(k, x.shape[0]), dim=1, largest=False)
        cand_d.append(bd)
        cand_i.append(sel.to(torch.int32) + c0)
        del dist
    cand_d = torch.cat(cand_d, dim=1)
    cand_i = torch.cat(cand_i, dim=1)
    # row order first, so that the stable sort below puts ties lowest row
    # first whatever order torch.topk left them in
    order = torch.argsort(cand_i, dim=1, stable=True)
    cand_d = torch.gather(cand_d, 1, order)
    cand_i = torch.gather(cand_i, 1, order)
    kk = min(k, cand_d.shape[1])
    fin_d, sel = topk_smallest(cand_d, kk)
    fin_i = torch.gather(cand_i, 1, sel)
    fin_i = torch.where(torch.isfinite(fin_d), fin_i, -1)
    if kk < k:
        fin_d = torch.nn.functional.pad(fin_d, (0, k - kk), value=float("inf"))
        fin_i = torch.nn.functional.pad(fin_i, (0, k - kk), value=-1)
    if metric != "cosine":
        qq = torch.sum(queries * queries, dim=1, keepdim=True)
        fin_d = torch.clamp_min(fin_d + qq, 0.0)
        fin_d = torch.where(fin_i >= 0, fin_d, float("inf"))
    return fin_d, fin_i
