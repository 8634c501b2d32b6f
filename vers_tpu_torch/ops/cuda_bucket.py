"""The flat ``engine="bucket"`` search: kernel D, the bucket-min scan,
hand-written in CUDA C++ for Hopper (``csrc/bucket_scan.cu``), then
kernel C (``cuda_topk.topk_values``) over its table, then an optional
exact f32 rescore (counterpart of ``vers_tpu.ops.pallas_bucket``).

Kernel D replaces ``vers_tpu/ops/pallas_bucket.py:bucket_scan_topk``.
What bounds it on the H100 and how the design answers that is in the
source note at the top of the ``.cu`` file. Its plain version is
``bucket_table_plain`` below.

The bucket rule defines the results and is the JAX package's: corpus
row r falls in bucket (r // span, r % 128), span = chunk * superchunk
from ``bucket_geometry``, and table column (r // span) * 128 + r % 128
keeps the bucket's smallest distance, the lowest row on ties. Queries
and corpus are rounded to bf16 and products summed in f32; qq comes from
the rounded queries and xx from the corpus as given (f32, or a bf16
store widened). A query loses a true
neighbour only where two of them share a bucket.

Dispatch, by the input tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.

The kernel reads the corpus rounded to bf16 with its feature axis padded
(``prepare_bucket_corpus``) and the rows' |x|^2. A caller that searches
one corpus many times (``FlatIndex``) prepares them once and passes them
in; otherwise the wrapper prepares them on every call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vers_tpu_torch.core import LANE, round_up
from vers_tpu_torch.ops import _build
from vers_tpu_torch.ops.cuda_topk import (
    CORPUS_DTYPES,
    check_query_corpus,
    topk_values,
)
from vers_tpu_torch.ops.distance import _check_f32_matmul, pairwise_dot
from vers_tpu_torch.ops.topk import topk_smallest
from vers_tpu_torch.utils.parity import max_abs_diff

DEFAULT_CHUNK = 2048
TARGET_BUCKETS = 8192
# corpus rows per step of the plain version (a memory bound, not a rule)
PLAIN_ROWS = 2048

# Launches of the CUDA kernel (one per successful launch).
LAUNCHES = 0

_METRICS = ("sq_euclidean", "cosine")

# Kernel D's tiles and shared-memory layout (csrc/bucket_scan.cu).
QUERY_TILE = 128     # queries per block
SLICE_FEATURES = 64  # bf16 features per staged slice (one 128-byte row)
RING_MAX, RING_MIN = 8, 6  # ring slots: as many as fit, >= RING_MIN resident
_SLICE = 128 * SLICE_FEATURES * 2  # a corpus or query slice
_ORD16_GROUPS = 65536  # groups per superchunk that 16-bit ordinals cover
# shared memory a block may opt into on the H100
H100_BLOCK_SMEM = 232448


def bucket_d_pad(d: int) -> int:
    """The kernel's feature width: d rounded up to whole k16 steps."""
    return round_up(d, 16)


def kernel_d_geometry(q_n: int, n_rows: int, d: int, span: int,
                      max_smem: int = H100_BLOCK_SMEM) -> dict:
    """How ``vers_bucket_scan`` launches kernel D: the padded width and
    its 64-feature slices; whether the query tile stays resident in
    shared memory beside at least RING_MIN ring slots (else each slot
    carries the query slice too); the ring's slots, as many as fit up to
    RING_MAX; whether a superchunk has more groups than 16-bit ordinals
    cover; the grid (query tiles, superchunks) and the shared memory
    per block."""
    d_pad = bucket_d_pad(d)
    nk = -(-d_pad // SLICE_FEATURES)

    def smem(resident, ns):
        slot = _SLICE * (1 if resident else 2)
        return ((nk * _SLICE if resident else 0) + ns * slot + 2 * 128 * 4
                + (2 * RING_MAX + 2 * 2 + 1) * 8 + 1024)

    resident = smem(True, RING_MIN) <= max_smem
    ns = RING_MAX
    while ns > 2 and smem(resident, ns) > max_smem:
        ns -= 1
    return dict(d_pad=d_pad, slices=nk, resident=resident, ring=ns,
                wide=span // LANE > _ORD16_GROUPS,
                grid=(-(-q_n // QUERY_TILE), -(-n_rows // span)),
                smem_bytes=smem(resident, ns))


class BucketCorpus(NamedTuple):
    """Kernel D's corpus: rows rounded to bf16 and zero-padded to
    ``bucket_d_pad(d)`` features, and |x|^2 of the rows as given (a
    bf16 corpus widened to f32)."""
    rows: torch.Tensor
    sq_norms: torch.Tensor


def prepare_bucket_corpus(corpus: torch.Tensor) -> BucketCorpus:
    """The bf16 corpus and |x|^2 that ``cuda_bucket_table`` reads. A
    contiguous bf16 corpus whose width is already whole k16 steps is
    its own padded corpus (no copy); any other is copied, rounded and
    padded (a bf16 store at d = 300 pads each 600-byte row to 608)."""
    d = corpus.shape[1]
    if (corpus.dtype == torch.bfloat16 and bucket_d_pad(d) == d
            and corpus.is_contiguous()):
        rows = corpus
    else:
        rows = torch.nn.functional.pad(corpus.to(torch.bfloat16),
                                       (0, bucket_d_pad(d) - d)).contiguous()
    xf = corpus.float()
    return BucketCorpus(rows, torch.sum(xf * xf, dim=1))


def bucket_geometry(n_rows: int, chunk_size: int = DEFAULT_CHUNK,
                    target_buckets: int = TARGET_BUCKETS):
    """(chunk, superchunk, n_super) for a corpus of ``n_rows`` rows, as
    ``pallas_bucket.bucket_scan_topk`` derives them: superchunks of
    ``chunk * superchunk`` rows keep the table near ``target_buckets``
    columns (n_super * 128). ``n_rows`` is the corpus tensor's row count
    (a store's capacity), so the buckets move when the capacity does."""
    if chunk_size % LANE:
        raise ValueError(f"chunk_size must be a multiple of {LANE}, "
                         f"got {chunk_size}")
    chunk = max(LANE, min(chunk_size, round_up(n_rows, LANE)))
    n_chunks = -(-n_rows // chunk)
    superchunk = max(1, (n_chunks * LANE) // max(target_buckets, LANE))
    n_super = -(-n_rows // (chunk * superchunk))
    return chunk, superchunk, n_super


def _rounded(t: torch.Tensor) -> torch.Tensor:
    """bf16-rounded values (round to nearest even), held in f32."""
    return t.to(torch.bfloat16).float()


def bucket_table_plain(queries: torch.Tensor, corpus: torch.Tensor,
                       n_valid: int, span: int, metric: str = "sq_euclidean"):
    """Kernel D's plain version: the (Q, n_super * 128) table of bucket
    minima (f32) and their rows (int32; -1 for a bucket with no valid
    row), n_super = ceil(N / span). Products of the bf16-rounded inputs
    are taken in f32 (TF32 off); a bf16 matmul would round the sums."""
    q_n = queries.shape[0]
    n_rows = corpus.shape[0]
    dev = queries.device
    n_super = -(-n_rows // span)
    q = _rounded(queries)
    qq = torch.sum(q * q, dim=1, keepdim=True)
    xf = corpus.float()
    xx = torch.sum(xf * xf, dim=1)
    lane = torch.arange(LANE, dtype=torch.int32, device=dev)
    out_d = torch.full((q_n, n_super * LANE), float("inf"), device=dev)
    out_i = torch.full((q_n, n_super * LANE), -1, dtype=torch.int32,
                       device=dev)
    step = max(LANE, PLAIN_ROWS // LANE * LANE)
    for sc in range(n_super):
        m = torch.full((q_n, LANE), float("inf"), device=dev)
        w = torch.full((q_n, LANE), -1, dtype=torch.int32, device=dev)
        lo, hi = sc * span, min((sc + 1) * span, n_rows, max(n_valid, 0))
        for c0 in range(lo, hi, step):
            c1 = min(c0 + step, hi)
            dot = pairwise_dot(q, _rounded(corpus[c0:c1]))
            if metric == "cosine":
                dist = 1.0 - dot
            else:
                dist = torch.clamp_min(qq + xx[None, c0:c1] - 2.0 * dot, 0.0)
            pad = (-(c1 - c0)) % LANE
            if pad:
                dist = torch.nn.functional.pad(dist, (0, pad),
                                               value=float("inf"))
            # first minimum over the groups: the lowest row of the step
            g_min, g = torch.min(dist.view(q_n, -1, LANE), dim=1)
            win = g_min < m
            m = torch.where(win, g_min, m)
            w = torch.where(win, c0 + g.to(torch.int32) * LANE + lane, w)
        out_d[:, sc * LANE : (sc + 1) * LANE] = m
        out_i[:, sc * LANE : (sc + 1) * LANE] = w
    return out_d, out_i


def _check_inputs(queries: torch.Tensor, corpus: torch.Tensor,
                  span: int) -> None:
    check_query_corpus(queries, corpus, CORPUS_DTYPES)
    if span <= 0 or span % LANE:
        raise ValueError(f"span must be a positive multiple of {LANE}, "
                         f"got {span}")
    if -(-corpus.shape[0] // span) > 65535:
        raise ValueError("more than 65535 superchunks: raise the span")


def _check_prepared(prepared: BucketCorpus, corpus: torch.Tensor) -> None:
    rows, sq = prepared
    n_rows, d = corpus.shape
    want = (n_rows, bucket_d_pad(d))
    if rows.dtype != torch.bfloat16 or tuple(rows.shape) != want:
        raise ValueError(f"prepared rows must be bf16 {want}, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if sq.dtype != torch.float32 or tuple(sq.shape) != (n_rows,):
        raise ValueError(f"prepared |x|^2 must be f32 ({n_rows},), got "
                         f"{sq.dtype} {tuple(sq.shape)}")
    for t in (rows, sq):
        if t.device != corpus.device or not t.is_contiguous():
            raise ValueError(f"prepared tensors must be contiguous on "
                             f"{corpus.device}")


def cuda_bucket_table(queries: torch.Tensor, corpus: torch.Tensor,
                      n_valid: int, span: int, metric: str = "sq_euclidean",
                      prepared: BucketCorpus | None = None):
    """Stage 1 of the bucket search, as ``bucket_table_plain``. CUDA
    tensors launch kernel D; CPU tensors take the plain version. The
    wrapper rounds the queries to bf16 with the feature axis zero-padded
    to ``bucket_d_pad(d)`` and computes qq; ``prepared`` (from
    ``prepare_bucket_corpus(corpus)``) saves preparing the corpus, with
    the same result."""
    global LAUNCHES
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if not queries.is_cuda and not corpus.is_cuda:
        return bucket_table_plain(queries, corpus, n_valid, span, metric)
    _check_inputs(queries, corpus, span)
    if prepared is None:
        prepared = prepare_bucket_corpus(corpus)
    else:
        _check_prepared(prepared, corpus)
    q_n, d = queries.shape
    n_rows = corpus.shape[0]
    n_super = -(-n_rows // span)
    n_valid = max(0, min(int(n_valid), n_rows))
    d_pad = bucket_d_pad(d)
    qb = torch.nn.functional.pad(queries.to(torch.bfloat16), (0, d_pad - d))
    qf = qb.float()
    qq = torch.sum(qf * qf, dim=1)
    dev = queries.device
    out_d = torch.full((q_n, n_super * LANE), float("inf"),
                       dtype=torch.float32, device=dev)
    out_i = torch.full((q_n, n_super * LANE), -1, dtype=torch.int32,
                       device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.vers_bucket_scan(
            qb.data_ptr(), prepared.rows.data_ptr(), qq.data_ptr(),
            prepared.sq_norms.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            q_n, n_rows, d_pad, n_valid, span, n_super,
            int(metric == "cosine"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "vers_bucket_scan")
    LAUNCHES += 1
    return out_d, out_i


def bucket_scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    n_valid: int,
    k: int,
    metric: str = "sq_euclidean",
    chunk_size: int = DEFAULT_CHUNK,
    shortlist: int = 32,
    target_buckets: int = TARGET_BUCKETS,
    rescore: bool = False,
    prepared: BucketCorpus | None = None,
):
    """Approximate top-k through the bucket table: (dists (Q, k) f32
    ascending, rows (Q, k) int32; (+inf, -1) padding), as
    ``vers_tpu.ops.pallas_bucket.bucket_scan_topk``.

    ``rescore=False``: the k best buckets, with their bf16-product
    distances. ``rescore=True``: a shortlist of max(k, min(shortlist,
    W)) buckets is rescored exactly in f32 (TF32 off) from the corpus
    as given (a bf16 store's rows widened to f32, as the JAX package
    rescores against its store) and the best k of it kept.
    ``prepared``: the corpus as ``prepare_bucket_corpus`` gives it, for
    kernel D."""
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    chunk, superchunk, _ = bucket_geometry(corpus.shape[0], chunk_size,
                                           target_buckets)
    bd, bi = cuda_bucket_table(queries, corpus, n_valid, chunk * superchunk,
                               metric, prepared=prepared)
    s = max(k, min(shortlist, bd.shape[1])) if rescore else k
    sd, cand = topk_values(bd, bi, s)
    if not rescore:
        return sd, cand

    safe = torch.clamp(cand, 0, corpus.shape[0] - 1).long()
    v = corpus[safe].float()  # (Q, s, d)
    qf = queries.float()
    _check_f32_matmul(qf)
    dots = torch.bmm(v, qf[:, :, None])[:, :, 0]
    if metric == "cosine":
        exact = 1.0 - dots
    else:
        qq = torch.sum(qf * qf, dim=1, keepdim=True)
        vv = torch.sum(v * v, dim=2)
        exact = torch.clamp_min(qq + vv - 2.0 * dots, 0.0)
    exact = torch.where(cand >= 0, exact, float("inf"))
    fd, fsel = topk_smallest(exact, k)
    fi = torch.gather(cand, 1, fsel)
    fi = torch.where(torch.isfinite(fd), fi, -1)
    return fd, fi


def compare_bucket_tables(got, want, queries: torch.Tensor,
                          corpus: torch.Tensor, n_valid: int, span: int,
                          metric: str = "sq_euclidean", atol: float = 1e-4):
    """Hold a bucket table ``got`` (dists, rows) against ``want`` (the
    plain version's) and raise AssertionError unless: the distances
    agree within ``atol`` (inf where the other is inf); every row lies
    below ``n_valid`` and in its column's bucket; and where the rows
    differ, the plain arithmetic puts ``got``'s row within ``atol`` of
    ``want``'s distance (a near-tie). Returns (max |d distance|, number
    of near-tie entries)."""
    gd, gi = got
    wd, wi = want
    if gd.shape != wd.shape or gi.shape != wi.shape:
        raise AssertionError(f"shapes {tuple(gd.shape)} vs {tuple(wd.shape)}")
    err = max_abs_diff(gd, wd)
    if not err <= atol:
        raise AssertionError(f"max |d distance| {err} > {atol}")
    if not torch.equal(gi >= 0, torch.isfinite(gd)):
        raise AssertionError("rows must be -1 exactly where distances are inf")
    col = torch.arange(gd.shape[1], device=gi.device)[None, :]
    live = gi >= 0
    home = (gi // span == col // LANE) & (gi % LANE == col % LANE)
    if not bool((home & (gi < n_valid))[live].all()):
        raise AssertionError("a row lies outside its bucket or >= n_valid")
    qi, ci = torch.nonzero(gi != wi, as_tuple=True)
    if qi.numel():
        q = _rounded(queries[qi])
        x = corpus[gi[qi, ci].long()].float()
        dot = torch.sum(q * _rounded(x), dim=1)
        if metric == "cosine":
            dist = 1.0 - dot
        else:
            dist = torch.clamp_min(torch.sum(q * q, dim=1)
                                   + torch.sum(x * x, dim=1) - 2.0 * dot, 0.0)
        gap = max_abs_diff(dist, wd[qi, ci])
        if not gap <= atol:
            raise AssertionError(f"rows differ beyond a near-tie ({gap})")
    return err, int(qi.numel())
