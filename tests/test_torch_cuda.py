"""Kernels A, B, C and D on the card against their plain versions, at
small edge shapes (ragged query tiles and corpus chunks, k = 1 and
k = MAX_K, cosine, gated probe ranks, exact ties, superchunks of one and
several chunks, rows past n_valid, all-inf rows), kernel A's corpus
split at small Q over 200k rows (ties across split boundaries, n_valid
mid-split, k = MAX_K, rows of norm ~15, repeat calls bit-identical), and
kernel D at Q in {1, 65, 130, 200} and d in {8, 37, 300, 1000} (n_valid
mid-group and mid-superchunk, single-group superchunks, 32-bit ordinals,
both query-tile layouts, duplicates 128 rows apart, rows of norm ~15,
repeat calls and the prepared corpus bit-identical), kernel C on
adversarial tables (all-equal rows, few distinct values, +-0, rows with
fewer than k finite values) at W in {1, 20, 33, 1001, 8960, 70000} and k
in {1, 10, 32, 128}, and kernel B directly on the scans of small binned
searches (d in {8, 37, 300}, k in {1, 10, 128}, skewed bins, bins larger
than a tile, groups that end inside a tile, a run of more than 512
tiles, cosine, ids on and off, exact ties, repeat calls bit-identical;
every shape under each of its two walks, forced, the split walk and
the run walk bit for bit, each walk's report against its host mirror;
the two walks also at Q = 1, 64 and 1024 over empty lists),
kernel F (the cross-probe merge) against its plain version bit for bit
on adversarial merges (k = 1 to 128, Q off the 8-query block, p = 2 and
263, gated ranks as a suffix and anywhere, -0.0 beside +0.0) and in IVF
searches at nprobe 0 and 2, with no launch in the forest's searches,
and the RP-forest: its build on the card, its search with kernel B
against the plain engine on both sides of the plan limit, the duplicate
mask where a query probes one leaf twice, the descent against the CPU's,
and one launch of kernel B a tree a search, and HNSW: a 20k x 64 wave
build on the card searched there and on the CPU over the same graph
(classic, inline and beam routes; rows may differ only at near-ties of
nav distances, counted), kernel A launched once by a scan-routed search
and held to its plain version on the routing scan, the build from a
CUDA tensor, ``add`` on the card, and bad routing-scan inputs raising;
HNSW's last three options: kernel A's bf16/default cosine route at the
scan-routed build's shapes (k = 100 and k = 1, Q in {16, 256, 4096},
tables of 8, 128 and 41,547 rows, n_valid 0, 1, 99 and the whole
table), a scan-routed and an inline-insertion 20k build on the card
against the CPU's (same layer sizes, recall@10 within 0.01), and the
int8 navigation table on the card against the CPU's (the table bit for
bit, searches up to near-ties, ``add``),
and the multi-device layer: ``make_mesh`` on the card, the sharded flat,
IVF and forest and the partitioned forest and HNSW over four shards of
one card against the single-device indexes (or the same partitioned
index on the CPU) with their launches per shard, the sharded HNSW
against the beam route, and every class over one shard per card where
there are two cards or more; and the searches as CUDA graphs
(``vers_tpu_torch.graphs``): IVF at nprobe 1 and 2 (nprobe 0, the
adaptive depth, runs eagerly and captures nothing), the forest at 1, 4
and auto probes, HNSW scan-routed (classic beam, inline beam, int8) and
beam-routed, and the sharded IVF, forest and HNSW on four shards of one
card, each capturing call and replay equal to the eager search bit for
bit; IVF (nprobe 1, 2 and 0) and forest searches with no host
synchronisation (``set_sync_debug_mode("error")``); eight chained calls
equal to eight drained ones; search, ``add``, search equal to a fresh
index; replays counted as launches; a 64-query IVF search replayed on
kernel B's split walk with no host synchronisation, and a 16384-query
one on the run walk.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips without one. This file imports neither jax nor vers_tpu, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Distances are held to rtol 1e-4 / atol 1e-4 (f32 sums in other orders;
TF32 off); ids tie-aware. Kernel D's table: distances within 1e-4, rows
equal except at near-ties (``compare_bucket_tables``). Kernel C only
selects, so it must equal its plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from vers_tpu_torch.ops import binned, cuda_binned, cuda_bucket, cuda_topk
from vers_tpu_torch.ops.topk import fused_scan_topk, split_scan_topk_plain
from vers_tpu_torch.utils.data import TOPK_TABLE_KINDS as TABLE_KINDS
from vers_tpu_torch.utils.data import adversarial_topk_table
from vers_tpu_torch.utils.parity import assert_topk_match

pytestmark = pytest.mark.gpu

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want):
    assert_topk_match(got[0], got[1], want[0], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("q_n,n,n_valid,d,k", [
    (100, 3000, 2999, 37, 10),
    (64, 512, 512, 16, 1),
    (130, 1000, 900, 300, cuda_topk.MAX_K),
    (7, 200, 5, 8, 9),  # k > n_valid: (+inf, -1) tail
])
def test_distance_topk_kernel_matches_plain(cuda, metric, q_n, n, n_valid, d, k):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    if metric == "cosine":
        x = torch.nn.functional.normalize(x, dim=1)
        q = torch.nn.functional.normalize(q, dim=1)
    before = cuda_topk.launches()
    got = cuda_topk.cuda_distance_topk(q, x, n_valid, k, metric=metric)
    torch.cuda.synchronize()
    assert cuda_topk.launches() == before + 1
    _check(got, fused_scan_topk(q, x, n_valid, k, metric=metric, chunk_size=256))


def test_distance_topk_kernel_tie_order(cuda):
    """Duplicated corpus rows tie exactly; the lower row comes first."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(300, 20)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, base, base])).to(cuda)
    q = torch.from_numpy(base[:50] + 0.01).to(cuda)
    d, i = cuda_topk.cuda_distance_topk(q, x, 900, 6)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    same = d[:, 1:] == d[:, :-1]
    assert same.any()
    assert (i[:, 1:][same] > i[:, :-1][same]).all()
    _check((d, i), fused_scan_topk(q, x, 900, 6))


def _corpus(cuda, n, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x *= scale / np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(cuda), rng


def _count(fn):
    """fn()'s result and the launches of kernels A and C it made."""
    a, c = cuda_topk.launches(), cuda_topk.LAUNCHES_VALUES
    out = fn()
    torch.cuda.synchronize()
    return out, cuda_topk.launches() - a, cuda_topk.LAUNCHES_VALUES - c


@pytest.mark.parametrize("route", ["f32/highest", "bf16/default",
                                   "bf16/highest", "f32/high"])
@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("q_n,k", [(1, 10), (3, 1), (65, 10),
                                   (65, cuda_topk.MAX_K), (257, 100),
                                   (2048, 8)])
def test_distance_topk_split_corpus(cuda, route, metric, q_n, k):
    """Q up to 2048 over 200k x 300 rows: the corpus is split across
    blocks (kernel A, the route's plan), then kernel C takes the final k;
    n_valid ends mid-split; a repeat call is bit-identical."""
    dt, precision = route.split("/")
    x, rng = _corpus(cuda, 200_000, 300, 7)
    q = x[rng.integers(0, 200_000, q_n)] + 0.05 * torch.from_numpy(
        rng.normal(size=(q_n, 300)).astype(np.float32)).to(cuda)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q, dim=1)
    if dt == "bf16":
        x = x.to(torch.bfloat16)
    n_valid = 200_000 - 77
    plan = cuda_topk.plan_for(q, x, n_valid, k, precision)
    assert plan.n_split > 1 and n_valid % plan.split_rows
    got, a, c = _count(lambda: cuda_topk.cuda_distance_topk(
        q, x, n_valid, k, metric=metric, precision=precision))
    assert (a, c) == (1, 1)
    assert (got[1] < n_valid).all()
    _check(got, fused_scan_topk(q, x, n_valid, k, metric=metric,
                                precision=precision))
    again = cuda_topk.cuda_distance_topk(q, x, n_valid, k, metric=metric,
                                         precision=precision)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_distance_topk_split_ties_across_boundaries(cuda):
    """Rows r and r + 100000 are exact duplicates in different splits:
    they tie exactly and the lower row comes first."""
    base, rng = _corpus(cuda, 100_000, 64, 8)
    x = torch.cat([base, base]).contiguous()
    q = base[:40] + 0.01
    got, a, c = _count(lambda: cuda_topk.cuda_distance_topk(q, x, 200_000, 6))
    assert (a, c) == (1, 1)
    d, i = got[0].cpu().numpy(), got[1].cpu().numpy()
    same = d[:, 1:] == d[:, :-1]
    assert same.any()
    assert (i[:, 1:][same] > i[:, :-1][same]).all()
    _check(got, fused_scan_topk(q, x, 200_000, 6))


def test_distance_topk_splits_past_n_valid(cuda):
    """Explicit splits, the last ones wholly past n_valid: their columns
    hold (+inf, -1); kernel C over the table equals the plain split."""
    x, rng = _corpus(cuda, 4096, 40, 9)
    q = torch.from_numpy(rng.normal(size=(70, 40)).astype(np.float32)).to(cuda)
    vals, ids, n_split = cuda_topk.split_pass(q, x, 1000, 5, n_split=8,
                                              split_rows=512)
    assert n_split == 8 and vals.shape == (70, 40)
    assert torch.isinf(vals[:, 10:]).all() and (ids[:, 10:] == -1).all()
    got = cuda_topk.cuda_topk_values(vals, ids, 5)
    _check(got, split_scan_topk_plain(q, x, 1000, 5, 512))


def test_distance_topk_unnormalized_rows(cuda):
    """Rows of norm ~15: |q|^2 + |x|^2 - 2 q.x cancels ~eps |x|^2, so
    the tolerance scales with |x|^2 = 225."""
    x, rng = _corpus(cuda, 200_000, 300, 10, scale=15.0)
    q = x[:33] + torch.from_numpy(rng.normal(size=(33, 300)).astype(np.float32)).to(cuda)
    got = cuda_topk.cuda_distance_topk(q, x, 200_000, 10)
    want = fused_scan_topk(q, x, 200_000, 10)
    assert_topk_match(got[0], got[1], want[0], want[1], rtol=0.0, atol=1e-4 * 225)


@pytest.mark.parametrize("d,k", [(1000, cuda_topk.MAX_K), (301, 10)])
def test_distance_topk_wide_rows(cuda, d, k):
    """d = 1000 with k = 128 leaves no room for the resident query tile
    (queries read through L1); d = 301 takes the 4-byte staging copies."""
    x, rng = _corpus(cuda, 20_000, d, 11)
    q = torch.from_numpy(rng.normal(size=(100, d)).astype(np.float32)).to(cuda)
    q = torch.nn.functional.normalize(q, dim=1)
    got = cuda_topk.cuda_distance_topk(q, x, 19_999, k)
    _check(got, fused_scan_topk(q, x, 19_999, k))


ROUTES = [(dtype, precision) for dtype in (torch.float32, torch.bfloat16)
          for precision in ("highest", "high", "default")]


@pytest.mark.parametrize("dtype,precision", ROUTES)
@pytest.mark.parametrize("q_n,n,n_valid,d,k,metric,layout", [
    # odd d: a bf16 corpus by 2-byte loads, f32 by 4-byte cp.async
    (100, 3000, 2999, 37, 10, "sq_euclidean", ""),
    # k = 128 at d = 300: "highest" on a bf16 corpus splits in registers
    (130, 1000, 900, 300, cuda_topk.MAX_K, "cosine", ""),
    (70, 5000, 5000, 64, 8, "cosine", ""),  # 16-byte rows: TMA in order
    (200, 4000, 3999, 300, 10, "sq_euclidean", ""),  # bf16: even/odd TMA
    (7, 200, 5, 8, 9, "sq_euclidean", ""),  # k > n_valid: (+inf, -1) tail
    (1, 3001, 3001, 300, 1, "cosine", ""),  # odd row count, its last row
    (63, 2600, 2600, 16, 100, "sq_euclidean", ""),
    (64, 5000, 4321, 512, 10, "cosine", ""),  # a 64-query tile exactly
    (65, 9000, 9000, 7, 8, "sq_euclidean", ""),  # the 128-query tile
    (127, 6000, 6000, 300, cuda_topk.MAX_K, "sq_euclidean", ""),
    (128, 6000, 5999, 512, 1, "sq_euclidean", ""),
    (129, 6000, 6000, 37, 100, "cosine", ""),
    (255, 7000, 7000, 300, 10, "cosine", "ties"),  # rows r, r + n / 2 equal
    (257, 20_000, 19_999, 16, 10, "sq_euclidean", "ties"),
    (2048, 20_001, 20_001, 300, 8, "sq_euclidean", ""),
    (129, 6001, 6001, 300, 10, "cosine", "offset"),  # bf16 rows off 16 bytes
])
def test_distance_topk_routes_match_plain(cuda, dtype, precision, q_n, n,
                                          n_valid, d, k, metric, layout):
    """Each of kernel A's six routes (corpus f32 or bf16, precision
    highest, high or default) against the plain version at the same
    setting: exact products summed in f32 on both sides. The shapes walk
    what the plans branch on: query tiles of 64 and 128 and their ragged
    edges, k from 1 to MAX_K, d odd, 16-byte, 8-byte and 4-byte aligned
    rows (TMA in row order, as even and odd rows, or cp.async), an odd
    row count, a base 8 bytes off 16, and exact ties across tiles, query
    tiles and splits."""
    rng = np.random.default_rng(12)
    n_all = n + (layout == "offset")
    x = torch.from_numpy(rng.normal(size=(n_all, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    if metric == "cosine":
        x = torch.nn.functional.normalize(x, dim=1)
        q = torch.nn.functional.normalize(q, dim=1)
    if layout == "ties":
        x[n // 2: n // 2 * 2] = x[: n // 2]
    x = x.to(dtype)[n_all - n:]
    route = cuda_topk.route_name(dtype, precision)
    before = cuda_topk.LAUNCHES_BY_ROUTE.get(route, 0)
    got = cuda_topk.cuda_distance_topk(q, x, n_valid, k, metric=metric,
                                       precision=precision)
    torch.cuda.synchronize()
    assert cuda_topk.LAUNCHES_BY_ROUTE[route] == before + 1
    want = fused_scan_topk(q, x, n_valid, k, metric=metric, chunk_size=256,
                           precision=precision)
    _check(got, want)
    if precision == "default" and d == 300:  # the products really round
        exact = fused_scan_topk(q, x, n_valid, k, metric=metric,
                                precision="highest")
        near = float((got[0] - want[0]).abs().max())
        far = float((got[0] - exact[0]).abs().max())
        assert far > 10 * near, (near, far)


@pytest.mark.parametrize("route", [f"{'bf16' if dt == torch.bfloat16 else 'f32'}/{p}"
                                   for dt, p in ROUTES])
@pytest.mark.parametrize("d,k", [(7, 1), (16, 8), (37, cuda_topk.MAX_K),
                                 (300, 10), (300, 100), (512, cuda_topk.MAX_K)])
def test_distance_topk_plan_matches_the_card(cuda, route, d, k):
    """The host's plan (``kernel_plan``, from its shared-memory
    arithmetic) is what the built kernel lays out (``make_layout`` /
    ``make_layout_b``), and the card runs its block: no more blocks an SM
    than the shared memory allows."""
    props = torch.cuda.get_device_properties(cuda)
    for q_n in (1, 2048):
        plan = cuda_topk.kernel_plan(route, q_n, 100_000, d, k,
                                     props.multi_processor_count,
                                     props.shared_memory_per_block_optin)
        smem, blocks = cuda_topk.card_plan(plan, d, k)
        assert smem == plan.smem_bytes, (route, d, k, q_n)
        assert 1 <= blocks <= plan.blocks_per_sm, (route, d, k, q_n)


# Rows whose every value is hi + lo + r, three bf16 parts: hi = bf16(v),
# lo = bf16(v - hi) = SEP_LO > 0, r = v - hi - lo = SEP_R > 0. Then each
# setting's q . x differs from its neighbour's by a sum of same-signed
# terms over d: "high" drops lo_q lo_x and r_q hi_x of "highest"; over a
# bf16 corpus (lo_x = 0) it drops r_q hi_x; "default" drops lo_q hi_x.
# The corpus's hi lie in [1.4, 1.6); the query's come in pairs (a, -a)
# of adjacent features, so q . x and its partial sums stay small (|d| <
# 8): the tensor cores' f32 accumulation, which rounds toward zero, then
# stays well inside SEP_ATOL of the plain version, while the settings lie
# ~3e-3 apart at d = 300 (~7.5e-3 for "high" against "highest" over the
# f32 corpus).
SEP_LO, SEP_R = 1.9375 * 2.0**-9, 1.875 * 2.0**-18
SEP_ATOL = 1e-4  # kernel vs plain at one setting on these rows


def _three_part_rows(rng, n, d, paired):
    if paired:
        a = rng.uniform(1.01, 1.99, size=(n, d // 2))
        a *= rng.choice([-1.0, 1.0], size=a.shape)
        hi = np.stack([a, -a], axis=2).reshape(n, d)
    else:
        hi = rng.uniform(1.4, 1.6, size=(n, d))
    hi = torch.from_numpy(hi.astype(np.float32)).to(torch.bfloat16).float()
    return hi + SEP_LO + SEP_R


@pytest.mark.parametrize("dtype,precision", ROUTES)
def test_distance_topk_routes_are_distinct(cuda, dtype, precision):
    """Each route is held to its own plain version at rtol 0, and each
    neighbouring setting's plain result is further from the kernel's,
    at every rank, than ten times that gap: a kernel that ran "high" as
    "highest" (or the reverse), or a bf16 corpus at "highest" with two
    query parts, fails."""
    rng = np.random.default_rng(16)
    x = _three_part_rows(rng, 4000, 300, paired=False)
    q = _three_part_rows(rng, 200, 300, paired=True)
    xh = x.to(torch.bfloat16).float()
    assert bool(((x - xh).to(torch.bfloat16).float() == SEP_LO).all())
    assert bool((x - xh - SEP_LO == SEP_R).all())
    x, q = x.to(cuda).to(dtype), q.to(cuda)
    got = cuda_topk.cuda_distance_topk(q, x, 3999, 10, metric="cosine",
                                       precision=precision)
    plain = {p: fused_scan_topk(q, x, 3999, 10, metric="cosine",
                                precision=p)
             for p in ("highest", "high", "default")}
    want = plain.pop(precision)
    assert_topk_match(got[0], got[1], want[0], want[1], rtol=0.0,
                      atol=SEP_ATOL)
    near = float((got[0] - want[0]).abs().max())
    for other, res in plain.items():
        far = float((got[0] - res[0]).abs().min())
        assert far > 10 * near and far > 2 * SEP_ATOL, (other, near, far)


@pytest.mark.parametrize("dtype,precision", ROUTES[1:])
def test_distance_topk_routes_split_corpus(cuda, dtype, precision):
    """The routes over 200k x 300 rows at small Q: split across blocks,
    kernel C over the splits, ties across split boundaries to the lower
    row (rows r and r + 100000 are equal), repeat calls bit-identical."""
    base, rng = _corpus(cuda, 100_000, 300, 13)
    x = torch.cat([base, base]).to(dtype).contiguous()
    q = base[rng.integers(0, 100_000, 65)] + 0.05 * torch.from_numpy(
        rng.normal(size=(65, 300)).astype(np.float32)).to(cuda)
    n_valid = 200_000 - 77
    got, a, c = _count(lambda: cuda_topk.cuda_distance_topk(
        q, x, n_valid, 10, precision=precision))
    assert (a, c) == (1, 1)
    d, i = got[0].cpu().numpy(), got[1].cpu().numpy()
    same = d[:, 1:] == d[:, :-1]
    assert same.any()
    assert (i[:, 1:][same] > i[:, :-1][same]).all()
    _check(got, fused_scan_topk(q, x, n_valid, 10, precision=precision))
    again = cuda_topk.cuda_distance_topk(q, x, n_valid, 10, precision=precision)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_distance_topk_bf16_unaligned_rows(cuda):
    """A bf16 corpus view starting one row in (d = 300: rows 8-byte
    aligned, the base not 16) takes the 4-byte copies and agrees."""
    x, rng = _corpus(cuda, 3001, 300, 14)
    xb = x.to(torch.bfloat16)[1:]
    q = torch.from_numpy(rng.normal(size=(80, 300)).astype(np.float32)).to(cuda)
    got = cuda_topk.cuda_distance_topk(q, xb, 3000, 10)
    _check(got, fused_scan_topk(q, xb, 3000, 10))


def test_kernel_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((256, 8), device=cuda)
    with pytest.raises(TypeError):
        cuda_topk.cuda_distance_topk(x.double(), x.double(), 256, 4)
    with pytest.raises(ValueError):
        cuda_topk.cuda_distance_topk(x.cpu(), x, 256, 4)
    with pytest.raises(TypeError):  # queries are f32 on every route
        cuda_topk.cuda_distance_topk(x.bfloat16(), x.bfloat16(), 256, 4)
    with pytest.raises(ValueError):
        cuda_topk.cuda_distance_topk(x, x, 256, 4, precision="fastest")
    with pytest.raises(ValueError):
        cuda_topk.cuda_distance_topk(x, x, 256, cuda_topk.MAX_K + 1)


def _layout(n, d, k, skew, dev, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = ((rng.random(n) ** 3 * k).astype(np.int64) if skew
            else rng.integers(0, k, n))
    return binned.make_layout(x, bins, k, device=dev), rng


@pytest.mark.parametrize("kernel_ids", [False, True])
@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("n,d,k,q_n,nprobe,skew,q_blk", [
    (3000, 32, 16, 200, 1, False, 64),
    (3000, 32, 16, 500, 3, True, 128),
    (997, 16, 7, 33, 2, True, 64),
    (5000, 300, 40, 700, 8, True, 128),
])
def test_binned_search_kernel_matches_plain(cuda, kernel_ids, metric, n, d, k,
                                            q_n, nprobe, skew, q_blk):
    layout, rng = _layout(n, d, k, skew, cuda)
    cents = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q, dim=1)
    kw = dict(top_k=10, metric=metric, q_blk=q_blk, r_blk=256, chunk=128,
              kernel_ids=kernel_ids)
    before = cuda_binned.LAUNCHES
    got = binned.binned_topk_kernel(q, cents, nprobe, layout, **kw)
    torch.cuda.synchronize()
    assert cuda_binned.LAUNCHES == before + 1
    _check(got, binned.binned_topk_kernel(q, cents, nprobe, layout, plain=True,
                                          **kw))


def test_binned_search_gated_ranks(cuda):
    """Sentinel (gated) probe ranks contribute nothing on the kernel."""
    layout, rng = _layout(3000, 32, 16, False, cuda)
    q = torch.from_numpy(rng.normal(size=(192, 32)).astype(np.float32)).to(cuda)
    near = torch.from_numpy(rng.integers(0, 16, (192, 1))).to(cuda)
    gated = torch.cat([near, torch.full_like(near, 16)], dim=1)
    mixed = gated.clone()
    mixed[1::2, 1] = (near[1::2, 0] + 3) % 16
    kw = dict(top_k=8, q_blk=64, r_blk=256, chunk=128)
    one = binned.binned_topk_kernel(q, None, 1, layout, probes=near, **kw)
    _check(binned.binned_topk_kernel(q, None, 2, layout, probes=gated, **kw), one)
    _check(binned.binned_topk_kernel(q, None, 2, layout, probes=mixed, **kw),
           binned.binned_topk_kernel(q, None, 2, layout, probes=mixed,
                                     plain=True, **kw))


def _merge_inputs(q_n, p, k, suffix, seed=0):
    """``rank_merge_inputs`` as CPU tensors, with num_bins."""
    from vers_tpu_torch.utils.data import rank_merge_inputs

    *arrays, num_bins = rank_merge_inputs(q_n, p, k, seed=seed, suffix=suffix)
    return [torch.from_numpy(a) for a in arrays], num_bins


@pytest.mark.parametrize("kernel_ids", [False, True])
@pytest.mark.parametrize("k", [1, 10, 32, 100, cuda_topk.MAX_K])
@pytest.mark.parametrize("q_n,p,suffix", [
    (37, 2, False), (1, 2, True),      # Q off the 8-query block; one query
    (70, 263, True), (13, 263, False),  # the adaptive depth: gated suffix,
])                                       # gated ranks anywhere
def test_rank_merge_kernel_matches_plain(cuda, kernel_ids, k, q_n, p, suffix):
    """Kernel F against ``rank_merge_plain`` bit for bit: ties within a
    row and across ranks, -0.0 beside +0.0, rows with fewer than k
    finite entries, empty lists, gated ranks whose rows would win if
    read, a query with every rank live and one with none; a repeat call
    bit-identical; the probe table a slice of wider rows. The plain
    merge runs on the CPU (the rule's own order)."""
    cpu, num_bins = _merge_inputs(q_n, p, k, suffix, seed=k)
    dev = [t.to(cuda) for t in cpu]
    # probe rows apart, as the probe stage's slice of a wider sort
    dev[3] = torch.cat([dev[3], dev[3][:, :3]], dim=1)[:, :p]
    before = cuda_binned.LAUNCHES_MERGE
    got = cuda_binned.cuda_rank_merge(*dev, num_bins, k, kernel_ids)
    torch.cuda.synchronize()
    assert cuda_binned.LAUNCHES_MERGE == before + 1
    assert got[0].is_cuda and got[1].dtype == torch.int32
    want = cuda_binned.rank_merge_plain(*cpu, num_bins, k, kernel_ids)
    _bitwise((got[0].cpu(), got[1].cpu()), want)
    again = cuda_binned.cuda_rank_merge(*dev, num_bins, k, kernel_ids)
    _bitwise(again, got)


def test_rank_merge_kernel_rejects_bad_inputs(cuda):
    (res_d, res_i, inv, probes, s2o), num_bins = _merge_inputs(9, 3, 10, True)
    args = [t.to(cuda) for t in (res_d, res_i, inv, probes, s2o)]
    merge = cuda_binned.cuda_rank_merge
    with pytest.raises(TypeError):
        merge(args[0], args[1], args[2], args[3].int(), args[4], num_bins, 10)
    with pytest.raises(ValueError, match="CUDA"):
        merge(args[0], args[1], inv, *args[3:], num_bins, 10)
    with pytest.raises(ValueError, match="top_k"):
        merge(*args, num_bins, cuda_topk.MAX_K + 1)
    with pytest.raises(ValueError, match="rows"):
        merge(args[0][:, :5].contiguous(), args[1][:, :5].contiguous(),
              *args[2:], num_bins, 10)
    with pytest.raises(ValueError, match="inv"):
        merge(args[0], args[1], args[2][:-1], *args[3:], num_bins, 10)
    with pytest.raises(ValueError, match="contiguous"):
        merge(args[0], args[1], args[2], args[3].T.contiguous().T, args[4],
              num_bins, 10)


def test_ivf_search_merges_on_kernel_f(cuda, monkeypatch):
    """IVF searches at nprobe 0 (the adaptive depth, several ranks on an
    index of short and empty lists) and 2 merge with one launch of
    kernel F each, equal bit for bit to the same searches with the plain
    merge in its place."""
    import vers_tpu_torch as vt
    from vers_tpu_torch import graphs

    x, q = _clustered()
    ivf = vt.IVFFlatIndex.build_index(400, 2, 10, x, device=cuda)
    layout = ivf._ensure_layout()
    assert binned.adaptive_probe_depth(layout["sizes_host"], 10) > 1
    qd = torch.from_numpy(q).to(cuda)
    with graphs.disabled():
        for nprobe in (0, 2):
            before = cuda_binned.LAUNCHES_MERGE
            got = ivf.search_batch_device(qd, 10, nprobe)
            torch.cuda.synchronize()
            assert cuda_binned.LAUNCHES_MERGE == before + 1
            with monkeypatch.context() as m:
                m.setattr(binned, "cuda_rank_merge",
                          lambda *a: cuda_binned.rank_merge_plain(*a))
                want = ivf.search_batch_device(qd, 10, nprobe)
            assert cuda_binned.LAUNCHES_MERGE == before + 1
            _bitwise(got, want)
            assert (got[1] >= 0).any()
        before = cuda_binned.LAUNCHES_MERGE
        ivf.search_batch_device(qd, 10, 1)  # one rank: no merge
        assert cuda_binned.LAUNCHES_MERGE == before


def test_forest_search_leaves_kernel_f_alone(cuda):
    """The forest's trees overlap: its scans keep the dedup merge, and
    kernel F's counter does not move over its searches."""
    idx, _, q = _forest_on(cuda, 20_000, 48, 40, trees=2)
    qd = torch.from_numpy(q).to(cuda)
    before = (cuda_binned.LAUNCHES, cuda_binned.LAUNCHES_MERGE)
    for probes in (None, 1, 3):
        idx.search_batch_device(qd, 10, probes)
    torch.cuda.synchronize()
    assert cuda_binned.LAUNCHES > before[0]
    assert cuda_binned.LAUNCHES_MERGE == before[1]


def _clustered(seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, 24)).astype(np.float32) * 3
    x = centers[rng.integers(0, 20, 4000)] + rng.normal(size=(4000, 24)).astype(
        np.float32)
    q = x[:100] + 0.1 * rng.normal(size=(100, 24)).astype(np.float32)
    # unit rows, as the real workload: the |q|^2 + |x|^2 - 2 q.x form
    # loses ~eps * |x|^2 to cancellation, so unnormalized rows of norm
    # ~15 would need a looser tolerance than the kernel comparison's
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def test_ivf_index_on_cuda_matches_cpu(cuda):
    import vers_tpu_torch as vt

    x, q = _clustered()
    cpu = vt.IVFFlatIndex.build_index(32, 2, 10, x, device="cpu")
    gpu = vt.IVFFlatIndex.from_numpy(32, cpu._values, cpu._centroids,
                                     cpu._assignments, cpu._ids, device=cuda)
    for nprobe in (0, 1, 3):
        a = gpu.search_batch(q, 10, nprobe=nprobe)
        b = cpu.search_batch(q, 10, nprobe=nprobe)
        _check((a.distances, a.ids), (b.distances, b.ids))
    flat_g = vt.FlatIndex(x, device=cuda).search_batch(q, 10)
    flat_c = vt.FlatIndex(x, device="cpu").search_batch(q, 10)
    _check((flat_g.distances, flat_g.ids), (flat_c.distances, flat_c.ids))


def test_ivf_plain_engine_matches_auto(cuda):
    """engine='auto' launches kernel B; engine='xla' runs its plain
    version on the same card tensors; the two agree."""
    import vers_tpu_torch as vt

    x, q = _clustered()
    auto = vt.IVFFlatIndex.build_index(32, 2, 10, x, device=cuda)
    auto._materialize_host()
    plain = vt.IVFFlatIndex.from_numpy(
        32, auto._values, auto._centroids, auto._assignments, auto._ids,
        config=vt.IVFFlatConfig(num_clusters=32, engine="xla"), device=cuda)
    before = cuda_binned.LAUNCHES
    a = auto.search_batch(q, 10, nprobe=2)
    assert cuda_binned.LAUNCHES == before + 1
    b = plain.search_batch(q, 10, nprobe=2)
    assert cuda_binned.LAUNCHES == before + 1
    _check((a.distances, a.ids), (b.distances, b.ids))


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("q_n,n,n_valid,d,span", [
    (100, 3000, 2999, 37, 1024),   # 3 superchunks, the last one short
    (7, 512, 300, 16, 512),        # one superchunk, rows past n_valid
    (130, 5000, 5000, 300, 128),   # one row per bucket, 40 superchunks
    (65, 4096, 4000, 8, 2048),     # 16 groups per superchunk
    (64, 300, 0, 24, 128),         # nothing valid: (+inf, -1) everywhere
])
def test_bucket_table_kernel_matches_plain(cuda, metric, q_n, n, n_valid, d,
                                           span):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    x = torch.nn.functional.normalize(x, dim=1)
    q = torch.nn.functional.normalize(q, dim=1)
    before = cuda_bucket.LAUNCHES
    got = cuda_bucket.cuda_bucket_table(q, x, n_valid, span, metric)
    torch.cuda.synchronize()
    assert cuda_bucket.LAUNCHES == before + 1
    assert got[0].shape == (q_n, -(-n // span) * 128)
    want = cuda_bucket.bucket_table_plain(q, x, n_valid, span, metric)
    cuda_bucket.compare_bucket_tables(got, want, q, x, n_valid, span, metric)
    if n_valid == 0:
        assert torch.isinf(got[0]).all() and (got[1] == -1).all()


def _bucket_check(q, x, n_valid, span, metric="sq_euclidean", atol=1e-4):
    """Kernel D against its plain version; a repeat call and the
    prepared-corpus path bit-identical to the first call."""
    before = cuda_bucket.LAUNCHES
    got = cuda_bucket.cuda_bucket_table(q, x, n_valid, span, metric)
    again = cuda_bucket.cuda_bucket_table(q, x, n_valid, span, metric)
    prep = cuda_bucket.prepare_bucket_corpus(x)
    third = cuda_bucket.cuda_bucket_table(q, x, n_valid, span, metric,
                                          prepared=prep)
    torch.cuda.synchronize()
    assert cuda_bucket.LAUNCHES == before + 3
    for other in (again, third):
        assert torch.equal(got[0], other[0]) and torch.equal(got[1], other[1])
    want = cuda_bucket.bucket_table_plain(q, x, n_valid, span, metric)
    cuda_bucket.compare_bucket_tables(got, want, q, x, n_valid, span, metric,
                                      atol=atol)
    return got


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("q_n,d,n,n_valid,span", [
    (1, 8, 3000, 2999, 1024),
    (65, 37, 5000, 4037, 2048),      # n_valid mid-group, mid-superchunk
    (130, 300, 20000, 19950, 14336),  # the smoke's span
    (200, 1000, 4096, 3000, 512),    # queries streamed with the rows
    (130, 300, 4096, 4096, 128),     # superchunks of a single group
    (200, 300, 700, 700, 128 * 65537),  # 32-bit ordinals
])
def test_bucket_kernel_d_shapes(cuda, metric, q_n, d, n, n_valid, span):
    """Query counts off the 128-query tile, widths off the 64-feature
    slice, both query-tile layouts, both ordinal widths."""
    x, rng = _corpus(cuda, n, d, 12)
    q = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda), dim=1)
    _bucket_check(q, x, n_valid, span, metric)


def test_bucket_kernel_d_duplicates_lower_row_wins(cuda):
    """Rows r and r + 128 are exact duplicates in one bucket (same
    superchunk, same lane): they tie exactly and the lower row wins."""
    base, rng = _corpus(cuda, 128, 300, 13)
    x = torch.cat([base] * 8).contiguous()  # 1024 rows, one superchunk
    q = base[rng.integers(0, 128, 70)] + 0.02
    d, i = _bucket_check(q, x, 1024, 1024)
    assert ((i >= 0) & (i < 128)).all()
    assert torch.equal(i[0], torch.arange(128, dtype=torch.int32, device=cuda))


def test_bucket_kernel_d_unnormalized_rows(cuda):
    """Rows of norm ~15: qq + xx - 2 q.x cancels ~eps |x|^2, so the
    tolerance scales with |x|^2 = 225."""
    x, rng = _corpus(cuda, 30000, 300, 14, scale=15.0)
    q = x[:70] + torch.from_numpy(rng.normal(size=(70, 300)).astype(
        np.float32)).to(cuda)
    _bucket_check(q, x, 30000, 2048, atol=1e-4 * 225)


def test_flat_bucket_engine_add_drops_prepared_corpus(cuda):
    import vers_tpu_torch as vt

    x, q = _clustered()
    idx = vt.FlatIndex(x, config=vt.FlatConfig(engine="bucket"))
    assert idx.device == torch.device("cuda", 0)
    idx.search_batch(q, 10)
    prep = idx.bucket_corpus()
    v = q[3] * np.float32(1.001)
    idx.add(v, 777)
    assert idx._bucket_corpus is None
    assert idx.search_batch(v[None, :], 1).ids[0, 0] == 777
    assert idx.bucket_corpus() is not prep


@pytest.mark.parametrize("d", [64, 300])
@pytest.mark.parametrize("engine,rescore", [("exact", False),
                                            ("bucket", False),
                                            ("bucket", True)])
def test_flat_bf16_store_on_cuda_matches_cpu(cuda, d, engine, rescore):
    """``FlatIndex(dtype="bfloat16")`` on the card (kernel A's bf16
    route; kernels D and C over the store, itself kernel D's corpus at d
    = 64, a padded copy at d = 300) against the same index on the CPU."""
    import vers_tpu_torch as vt

    x, rng = _corpus(cuda, 5000, d, 15)
    x = x.cpu().numpy()
    q = x[rng.integers(0, 5000, 70)] + 0.05 * rng.normal(
        size=(70, d)).astype(np.float32)
    cfg = vt.FlatConfig(dtype="bfloat16", engine=engine,
                        bucket_rescore=rescore)
    card = vt.FlatIndex(x, config=cfg)
    before = dict(cuda_topk.LAUNCHES_BY_ROUTE)
    got = card.search_batch(q, 10)
    if engine == "exact":
        assert (cuda_topk.LAUNCHES_BY_ROUTE["bf16/highest"]
                == before.get("bf16/highest", 0) + 1)
    else:
        prep = card.bucket_corpus()
        store = card._store.data
        assert (prep.rows.data_ptr() == store.data_ptr()) == (d % 16 == 0)
    want = vt.FlatIndex(x, config=cfg, device="cpu").search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))


def test_bucket_table_kernel_tie_order(cuda):
    """Duplicated rows in one bucket tie exactly; the lower row wins."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(256, 20)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, base])).to(cuda)
    q = torch.from_numpy(base[:50] + 0.01).to(cuda)
    d, i = cuda_bucket.cuda_bucket_table(q, x, 512, 512)
    assert ((i >= 0) & (i < 256)).all()
    cuda_bucket.compare_bucket_tables(
        (d, i), cuda_bucket.bucket_table_plain(q, x, 512, 512), q, x, 512, 512)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("q_n,w,k", [
    (37, 700, 1),
    (64, 33, 8),
    (5, 8960, cuda_topk.MAX_K),
    (130, 1000, 10),
    (3, 100, cuda_topk.MAX_K),  # k > W: (+inf, -1) tail
])
def test_topk_values_kernel_matches_plain(cuda, kind, q_n, w, k):
    rng = np.random.default_rng(6)
    if kind == "ties":  # few distinct values: the lowest column wins
        vals = rng.integers(0, 5, size=(q_n, w)).astype(np.float32)
    else:
        vals = rng.normal(size=(q_n, w)).astype(np.float32)
    vals[0, w // 2:] = np.inf
    vals[1, :] = np.inf
    ids = rng.integers(0, 1 << 30, size=(q_n, w)).astype(np.int32)
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    before = cuda_topk.LAUNCHES_VALUES
    got = cuda_topk.cuda_topk_values(v, i, k)
    torch.cuda.synchronize()
    assert cuda_topk.LAUNCHES_VALUES == before + 1
    want = cuda_topk.topk_values_plain(v, i, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _table(kind, q_n, w, seed=0):
    """Tables that stress kernel C's order: (vals (q_n, w) f32, ids)."""
    return tuple(torch.from_numpy(t)
                 for t in adversarial_topk_table(kind, q_n, w, seed))


@pytest.mark.parametrize("kind", TABLE_KINDS)
@pytest.mark.parametrize("k", [1, 10, 32, cuda_topk.MAX_K])
@pytest.mark.parametrize("q_n,w", [(70, 1), (70, 20), (70, 33), (37, 8960),
                                   (9, 70000), (33, 1001)])
def test_topk_values_kernel_adversarial_tables(cuda, kind, k, q_n, w):
    """Kernel C on every route (rows of at most 32 entries, 16-byte loads,
    4-byte loads at W = 33 and 1001), bit-identical to its plain version
    and to itself on a repeat call."""
    vals, ids = (t.to(cuda) for t in _table(kind, q_n, w, seed=w + k))
    before = cuda_topk.LAUNCHES_VALUES
    got = cuda_topk.cuda_topk_values(vals, ids, k)
    again = cuda_topk.cuda_topk_values(vals, ids, k)
    torch.cuda.synchronize()
    assert cuda_topk.LAUNCHES_VALUES == before + 2
    want = cuda_topk.topk_values_plain(vals, ids, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_topk_values_kernel_unaligned_view(cuda):
    """A table whose rows are 16-byte multiples but whose base is not
    takes the 4-byte loads."""
    vals, ids = (t.to(cuda) for t in _table("few", 5, 401))
    v, i = vals.reshape(-1)[1:2001].reshape(5, 400), ids[:, :400].contiguous()
    assert v.is_contiguous() and v.data_ptr() % 16
    got = cuda_topk.cuda_topk_values(v, i, 10)
    want = cuda_topk.topk_values_plain(v, i, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _captured_scan(fn):
    """The packed-scan arguments of the one scan fn() makes."""
    with binned.captured_scans() as calls:
        fn()
    (args, kw), = calls
    return args, kw


def test_packed_scan_kernel_constants(cuda):
    """The host mirror of kernel B's walk keeps the kernel's tile sizes
    and plan limit."""
    assert cuda_binned.kernel_constants() == dict(
        QUERY_TILE=cuda_binned.QUERY_TILE, TILE_ROWS=cuda_binned.TILE_ROWS,
        PLAN_MAX=cuda_binned.PLAN_MAX)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("kernel_ids", [False, True])
@pytest.mark.parametrize("n,d,bins,q_n,nprobe,skew,top_k,metric,tiles", [
    (3000, 8, 16, 200, 1, True, 1, "sq_euclidean", dict(q_blk=64, r_blk=256, chunk=128)),
    (6000, 37, 12, 300, 2, True, 10, "sq_euclidean", dict()),  # cp.async rows
    (5000, 300, 40, 700, 3, True, cuda_topk.MAX_K, "sq_euclidean",
     dict(q_blk=128, r_blk=256, chunk=128)),  # query tile not resident
    (5000, 300, 40, 300, 2, False, 10, "cosine", dict()),
    (2000, 16, 40, 130, 2, False, 10, "sq_euclidean",
     dict(q_blk=64, r_blk=192, chunk=64)),  # groups end inside a tile
    (140_000, 8, 2, 70, 1, False, 10, "sq_euclidean", dict()),  # > 512 tiles a run
])
def test_packed_scan_kernel_matches_plain(cuda, split, kernel_ids, n, d, bins,
                                          q_n, nprobe, skew, top_k, metric,
                                          tiles):
    """Kernel B, forced to one walk (``split``: the split walk, else the
    run walk), on the arguments the binned search hands it, against
    ``packed_scan_plain``; a repeat call bit-identical; equal bit for bit
    to the other walk and to the walk ``split_walk`` picks; the blocks
    that work and the live tiles each walks, as the kernel reports them,
    equal to the host mirror of that walk (``packed_scan_units``), block
    by block."""
    layout, rng = _layout(n, d, bins, skew, cuda)
    cents = torch.from_numpy(rng.normal(size=(bins, d)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q, dim=1)
        for key in ("corpus_sorted",):
            layout[key] = torch.nn.functional.normalize(layout[key], dim=1)
    args, kw = _captured_scan(lambda: binned.binned_topk_kernel(
        q, cents, nprobe, layout, top_k=top_k, metric=metric,
        kernel_ids=kernel_ids, **tiles))
    cuda_binned.check_work_items(args[2], args[3], args[0].shape[0], kw["q_blk"],
                                 args[4].shape[0], kw["chunk"] * kw["r_chunks"])
    before = (cuda_binned.LAUNCHES, cuda_binned.LAUNCHES_SPLIT)
    walk = cuda_binned.cuda_packed_scan_walk(*args, **kw, split=split)
    again = cuda_binned.cuda_packed_scan_walk(*args, **kw, split=split)
    other = cuda_binned.cuda_packed_scan_walk(*args, **kw, split=not split)
    got = cuda_binned.cuda_packed_scan(*args, **kw)
    torch.cuda.synchronize()
    picked = cuda_binned.walk_splits(args[0], kw["q_blk"])
    assert (cuda_binned.LAUNCHES - before[0],
            cuda_binned.LAUNCHES_SPLIT - before[1]) == (4, 1 + split + picked)
    _bitwise(again[:2], walk[:2])
    assert torch.equal(again[2], walk[2])
    _bitwise(other[:2], walk[:2])
    _bitwise(got, walk[:2])
    atol = 1e-4 * max(1.0, float((args[6].max())))  # scales with |x|^2
    want = cuda_binned.packed_scan_plain(*args, **kw)
    assert_topk_match(walk[0], walk[1], want[0], want[1], rtol=1e-4, atol=atol)
    units = cuda_binned.packed_scan_units(
        args[1], args[2], args[3], args[5], kw["q_blk"],
        kw["chunk"] * kw["r_chunks"], split)
    want_walk = cuda_binned.units_walked(units, args[2].shape[0], kw["q_blk"])
    assert np.array_equal(walk[2].cpu().numpy(), want_walk)
    assert (want_walk >= 0).any()
    if n == 140_000:
        assert want_walk.max() > 512


@pytest.mark.parametrize("q_n", [1, 64, 1024])
def test_packed_scan_split_walk_equals_run_walk(cuda, q_n):
    """The split walk and the run walk, forced on the same captured scan
    of an IVF search (nprobe 2, a layout with three empty lists, some
    probed): bit for bit, each walk's report equal to its host mirror
    block by block, ``split_walk`` picking the split walk at these
    shapes and ``LAUNCHES_SPLIT`` counting the split launches."""
    rng = np.random.default_rng(q_n)
    n, d, bins = 20_000, 64, 64
    x = rng.normal(size=(n, d)).astype(np.float32)
    assign = rng.integers(0, bins, n)
    assign[np.isin(assign, [5, 6, 40])] = 7
    layout = binned.make_layout(x, assign, bins, device=cuda)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32)).to(cuda)
    probes = torch.from_numpy(rng.integers(0, bins, (q_n, 2))).to(cuda)
    probes[::5, 1] = 6  # an empty list
    args, kw = _captured_scan(lambda: binned.binned_topk_kernel(
        q, None, 2, layout, top_k=10, probes=probes))
    assert cuda_binned.walk_splits(args[0], kw["q_blk"])
    before = (cuda_binned.LAUNCHES, cuda_binned.LAUNCHES_SPLIT)
    split = cuda_binned.cuda_packed_scan_walk(*args, **kw, split=True)
    run = cuda_binned.cuda_packed_scan_walk(*args, **kw, split=False)
    auto = cuda_binned.cuda_packed_scan(*args, **kw)
    torch.cuda.synchronize()
    assert (cuda_binned.LAUNCHES - before[0],
            cuda_binned.LAUNCHES_SPLIT - before[1]) == (3, 2)
    _bitwise(split[:2], run[:2])
    _bitwise(auto, split[:2])
    r_blk = kw["chunk"] * kw["r_chunks"]
    for walk, flag in ((split, True), (run, False)):
        units = cuda_binned.packed_scan_units(args[1], args[2], args[3], args[5],
                                              kw["q_blk"], r_blk, flag)
        assert np.array_equal(walk[2].cpu().numpy(), cuda_binned.units_walked(
            units, args[2].shape[0], kw["q_blk"]))
    want = cuda_binned.packed_scan_plain(*args, **kw)
    assert_topk_match(split[0], split[1], want[0], want[1], rtol=1e-4,
                      atol=1e-4 * max(1.0, float(args[6].max())))


def test_packed_scan_kernel_ties_lower_padded_row(cuda):
    """Every bin's rows are copies of its first two: distances tie
    exactly and the lower padded row wins, whatever the ids."""
    layout, rng = _layout(3000, 32, 16, True, cuda)
    q = torch.from_numpy(rng.normal(size=(200, 32)).astype(np.float32)).to(cuda)
    cents = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32)).to(cuda)
    args, kw = _captured_scan(lambda: binned.binned_topk_kernel(
        q, cents, 2, layout, top_k=8, q_blk=64, r_blk=256, chunk=128))
    args = list(args)
    corpus, rbin = args[4].clone(), args[5].reshape(-1)
    for b in range(16):
        rows = torch.nonzero(rbin == b).reshape(-1)
        if rows.numel():
            corpus[rows] = corpus[rows[torch.arange(rows.numel(), device=cuda) % 2]]
    args[4], args[6] = corpus, (corpus * corpus).sum(dim=1)[None, :]
    kw["ids_padded"] = (kw["ids_padded"].max() - kw["ids_padded"]).contiguous()
    got = cuda_binned.cuda_packed_scan(*args, **kw)
    want = cuda_binned.packed_scan_plain(*args, **kw)
    assert (want[0][:, 1:] == want[0][:, :-1]).any()
    _check(got, want)
    kw["ids_padded"] = None  # padded positions: ties ascend
    d, i = cuda_binned.cuda_packed_scan(*args, **kw)
    same = (d[:, 1:] == d[:, :-1]) & torch.isfinite(d[:, 1:])
    assert same.any() and (i[:, 1:][same] > i[:, :-1][same]).all()


def test_bucket_and_values_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((256, 8), device=cuda)
    with pytest.raises(TypeError):
        cuda_bucket.cuda_bucket_table(x.double(), x.double(), 256, 256)
    with pytest.raises(ValueError):
        cuda_bucket.cuda_bucket_table(x.cpu(), x, 256, 256)
    with pytest.raises(ValueError):
        cuda_bucket.cuda_bucket_table(x, x, 256, 100)  # span off the lanes
    with pytest.raises(ValueError):
        cuda_bucket.cuda_bucket_table(x, x[:, :4].contiguous(), 256, 256)
    with pytest.raises(ValueError):
        cuda_bucket.cuda_bucket_table(x.t(), x, 256, 256)
    v = torch.zeros((4, 50), device=cuda)
    i = torch.zeros((4, 50), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cuda_topk.cuda_topk_values(v, i.long(), 4)
    with pytest.raises(ValueError):
        cuda_topk.cuda_topk_values(v, i[:2], 4)
    with pytest.raises(ValueError):
        cuda_topk.cuda_topk_values(v, i, cuda_topk.MAX_K + 1)
    with pytest.raises(ValueError):
        cuda_topk.cuda_topk_values(v.t(), i.t(), 4)


@pytest.mark.parametrize("engine,rescore", [("bucket", False), ("bucket", True),
                                            ("approx", False)])
def test_flat_engines_on_cuda_match_cpu(cuda, engine, rescore):
    import vers_tpu_torch as vt

    x, q = _clustered()
    cfg = vt.FlatConfig(engine=engine, bucket_rescore=rescore)
    before = (cuda_bucket.LAUNCHES, cuda_topk.LAUNCHES_VALUES)
    a = vt.FlatIndex(x, config=cfg, device=cuda).search_batch(q, 10)
    launched = (cuda_bucket.LAUNCHES, cuda_topk.LAUNCHES_VALUES) != before
    assert launched == (engine == "bucket")
    b = vt.FlatIndex(x, config=cfg, device="cpu").search_batch(q, 10)
    _check((a.distances, a.ids), (b.distances, b.ids))


# -- the RP-forest on the card: kernel B's second caller ---------------

def _forest_on(cuda, n, d, max_size, trees=2, seed=3):
    import vers_tpu_torch as vt

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d)).astype(np.float32)
    x = centers[rng.integers(0, 64, n)] + 0.5 * rng.normal(size=(n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    idx = vt.ANNIndex.build_index(trees, max_size, x, np.arange(n), device=cuda)
    assert idx.device.type == "cuda"
    for tree in idx._trees:  # the build on the card: every row in one leaf,
        # leaves under max_size unless frozen at the bottom level
        sizes = np.array([len(m) for m in tree.members])
        assert sizes.sum() == n and sizes.min() > 0
        bottom = tree.bucket[-1]
        assert set(np.flatnonzero(sizes >= max_size)) <= set(bottom[bottom >= 0])
    q = x[rng.integers(0, n, 2048)] + 0.05 * rng.normal(size=(2048, d))
    return idx, x, q.astype(np.float32)


def _forest_search(idx, q, top_k, n_probes, q_blk, r_blk, plain):
    """``forest_search_shared`` on the index's tables at chosen tile
    sizes; returns the result and the plan units of one launch (its work
    items times its 64-row parts)."""
    from vers_tpu_torch.ops import binned
    from vers_tpu_torch.ops.forest_shared import forest_search_shared

    sh = idx._ensure_shared(r_blk)
    with binned.captured_scans() as calls:
        out = forest_search_shared(
            q, sh["coeffs"], sh["consts"], sh["cbase"], sh["splits"],
            sh["buckets"], sh["offsets"], sh["sizes_dev"], sh["corpus_pad"],
            sh["xx"], sh["src"], sh["rbin"], sh["g_first"], n_probes=n_probes,
            num_bins=sh["num_bins"], top_k=top_k, q_blk=q_blk, r_blk=r_blk,
            chunk=r_blk, plain=plain)
    n_items = calls[0][0][2].shape[0]
    return out, n_items * -(-q_blk // cuda_binned.QUERY_TILE)


@pytest.mark.parametrize("n,n_probes,q_blk,over", [
    (60_000, 1, 64, False), (60_000, 4, 128, False),
    (250_000, 1, 128, True), (450_000, 4, 64, True)])
def test_forest_kernel_engine_matches_plain_around_plan_max(cuda, n, n_probes,
                                                            q_blk, over):
    """Groups of 128 rows give a mid-size forest as many work items as
    1M rows have at r_blk 1024: under PLAN_MAX units the plan kernels
    order the blocks, over it they run in list order."""
    idx, _, q = _forest_on(cuda, n, 32, 100)
    qd = torch.from_numpy(q).to(cuda)
    before = cuda_binned.LAUNCHES
    got, units = _forest_search(idx, qd, 10, n_probes, q_blk, 128, plain=False)
    torch.cuda.synchronize()
    assert cuda_binned.LAUNCHES == before + 2  # one a tree
    assert (units > cuda_binned.PLAN_MAX) == over, units
    want, _ = _forest_search(idx, qd, 10, n_probes, q_blk, 128, plain=True)
    assert cuda_binned.LAUNCHES == before + 2
    _check(got, want)
    again, _ = _forest_search(idx, qd, 10, n_probes, q_blk, 128, plain=False)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_forest_dedup_with_a_probe_table_that_repeats_a_leaf(cuda):
    """Leaves one or two levels down: late flip ranks change nothing, so
    a query probes one leaf twice, and the trees overlap; the merge must
    drop the repeats (IVF never asks for this)."""
    import dataclasses

    from vers_tpu_torch.ops import rpforest

    idx, x, q = _forest_on(cuda, 3000, 16, 1000, trees=3)
    qd = torch.from_numpy(q[:500]).to(cuda)
    before = cuda_binned.LAUNCHES
    got = idx.search_batch(qd, 20, probes_per_tree=4)
    assert cuda_binned.LAUNCHES == before + 3
    sh = idx._shared
    probes = rpforest.descend_forest_flat(
        qd, sh["coeffs"], sh["consts"], sh["cbase"], sh["splits"],
        sh["buckets"], sh["offsets"], n_probes=4).reshape(500, 3, 4)
    ranked = probes.sort(dim=2).values
    assert bool((ranked[:, :, 1:] == ranked[:, :, :-1]).any())
    live = np.sort(np.where(got.ids >= 0, got.ids, -np.arange(1, 21)), axis=1)
    assert (live[:, 1:] != live[:, :-1]).all()  # no id twice in a row
    idx.config = dataclasses.replace(idx.config, engine="xla")
    want = idx.search_batch(qd, 20, probes_per_tree=4)
    assert cuda_binned.LAUNCHES == before + 3
    _check((got.distances, got.ids), (want.distances, want.ids))
    # every probed leaf's rows were candidates: the result is the exact
    # top-k over their union
    pr = probes.cpu().numpy()
    off = sh["offsets"].cpu().numpy()
    for r in range(0, 500, 50):
        rows = set()
        for t, tree in enumerate(idx._trees):
            for b in pr[r, t]:
                rows.update(tree.members[int(b - off[t])])
        rows = np.array(sorted(rows))
        d2 = ((x[rows] - q[r][None, :]) ** 2).sum(axis=1)
        np.testing.assert_allclose(np.sort(d2)[:20], got.distances[r],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_probes", [1, 4, 8])
def test_forest_descent_on_cuda_matches_cpu(cuda, n_probes):
    """The side of a plane is a sign: leaves are equal wherever every
    |projection| on the path exceeds 1e-4 and no two margins are that
    close; the rest are counted."""
    from vers_tpu_torch.ops import rpforest

    idx, _, q = _forest_on(cuda, 60_000, 300, 100)
    tables = [torch.from_numpy(a) for a in idx._flat_descent_tables()]
    off = torch.from_numpy(np.concatenate(
        [[0], np.cumsum([t.num_buckets for t in idx._trees])[:-1]]).astype(np.int32))
    qc = torch.from_numpy(q)
    want = rpforest.descend_forest_flat(qc, *tables, off, n_probes=n_probes)
    got = rpforest.descend_forest_flat(
        qc.to(cuda), *(t.to(cuda) for t in tables), off.to(cuda),
        n_probes=n_probes).cpu()
    _, margins = rpforest._descend_once_flat(
        qc, *tables, torch.arange(2), None, want_margins=True)
    m = np.sort(margins.numpy(), axis=2)
    with np.errstate(invalid="ignore"):
        gaps = np.where(np.isfinite(m[:, :, 1:]), m[:, :, 1:] - m[:, :, :-1],
                        np.inf)
    unsure = ((m[:, :, 0] < 1e-4) | (gaps.min(axis=2) < 1e-4)).T
    differs = (got != want).reshape(len(q), 2, n_probes).any(dim=2).numpy()
    assert not (differs & ~unsure).any()
    assert differs.sum() <= 8, int(differs.sum())


@pytest.mark.parametrize("probes", [None, 1, 3])
def test_forest_search_launches_kernel_b_once_a_tree(cuda, probes):
    import vers_tpu_torch as vt

    idx, x, q = _forest_on(cuda, 20_000, 48, 40, trees=5)
    before = cuda_binned.LAUNCHES
    got = idx.search_batch(q, 10, probes)
    assert cuda_binned.LAUNCHES == before + 5
    dists, ext = idx.search_batch_device(torch.from_numpy(q).to(cuda), 10, probes)
    assert cuda_binned.LAUNCHES == before + 10
    assert ext.is_cuda and ext.dtype == torch.int32
    np.testing.assert_array_equal(ext.cpu().numpy(), got.ids)
    cpu = vt.ANNIndex.from_numpy(idx.max_node_size, idx._trees, idx._values,
                                 idx._ids, device="cpu")
    want = cpu.search_batch(q, 10, probes)
    assert cuda_binned.LAUNCHES == before + 10  # CPU tensors: the plain version
    _check((got.distances, got.ids), (want.distances, want.ids))
    large = idx.search_batch(q[:64], cuda_topk.MAX_K + 2, 2)  # counted plain route
    assert cuda_binned.LAUNCHES == before + 10
    assert large.ids.shape == (64, cuda_topk.MAX_K + 2)


# -- HNSW: the device build and the searches on the card ----------------


@pytest.fixture(scope="module")
def hnsw_card():
    """One wave build of 20k x 64 clustered unit rows on the card
    (wave_cap auto = 1024), and 256 queries near corpus rows (recall@10
    0.985 at ef = 32 on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from vers_tpu_torch.index.hnsw import HNSWIndex
    from vers_tpu_torch.utils.data import synthetic_gaussian

    x, q = synthetic_gaussian(20_000, 64, n_clusters=64, n_queries=256, seed=8,
                              normalized=True, query_noise=0.5)
    idx = HNSWIndex.build_index_batched(4, 64, 32, 16, x, device="cuda")
    return x, q, idx


def _hnsw_pair(hnsw_card, **cfg):
    """The card index under ``cfg`` and a CPU index over the same graph
    (and the same PCA basis when the inline table is on)."""
    from vers_tpu_torch.config import HNSWConfig
    from vers_tpu_torch.index.hnsw import HNSWIndex

    x, q, built = hnsw_card
    config = HNSWConfig(num_layers=4, ef_construction=64, ef_search=32,
                        num_neighbours=16, **cfg)
    card = HNSWIndex.from_numpy(x, built._pending_graph, 64, 32, 4, 16,
                                config=config, device="cuda")
    basis = None
    if cfg.get("nav_inline_dp"):
        basis = card._ensure_device_cache()["inline"]["basis"].cpu().numpy()
    cpu = HNSWIndex.from_numpy(x, built._pending_graph, 64, 32, 4, 16,
                               config=config, basis=basis, device="cpu")
    return card, cpu


@pytest.mark.parametrize("cfg", [{}, dict(nav_inline_dp=32),
                                 dict(route_mode="beam")])
def test_hnsw_search_on_cuda_matches_cpu(hnsw_card, cfg):
    x, q, _ = hnsw_card
    card, cpu = _hnsw_pair(hnsw_card, **cfg)
    got = card.search_batch(q, 10)
    want = cpu.search_batch(q, 10)
    assert (card._device_cache["inline"] is not None) == ("nav_inline_dp" in cfg)
    # bf16 products are exact on both sides; the f32 sums run in other
    # orders, so a row may differ only at a near-tie of nav distances
    xn = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    qn = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    near_ties = 0
    for r in np.flatnonzero((got.ids != want.ids).any(axis=1)):
        a, b = set(got.ids[r].tolist()), set(want.ids[r].tolist())
        if a == b:
            continue
        near_ties += 1
        d = np.sort(1.0 - xn[sorted(a | b)] @ qn[r])
        assert np.diff(d).min() < 1e-5, r
    assert near_ties <= 0.02 * q.shape[0], near_ties
    same = (got.ids == want.ids).all(axis=1)
    assert np.allclose(got.distances[same], want.distances[same], rtol=0.0,
                       atol=1e-5)
    d, i = card.search_batch_device(torch.from_numpy(q).cuda(), 10)
    assert i.is_cuda and i.dtype == torch.int32
    assert np.array_equal(i.cpu().numpy(), got.ids)


def test_hnsw_scan_route_launches_kernel_a(hnsw_card):
    x, q, idx = hnsw_card
    from vers_tpu_torch.ops import beam
    from vers_tpu_torch.utils.harness import recall_at_k

    before = cuda_topk.launches()
    res = idx.search_batch(q, 10)
    torch.cuda.synchronize()
    assert cuda_topk.launches() == before + 1
    truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
    assert recall_at_k(res.ids, truth) > 0.95
    # the scan's kernel result against its plain version on the card
    cache = idx._ensure_device_cache()
    qd = torch.from_numpy(q).cuda()
    got = beam.route_scan(qd, cache["l1_tab"], cache["n1"], 8)
    q_scan = qd.to(torch.bfloat16).float()
    want = fused_scan_topk(q_scan, cache["l1_tab"], cache["n1"], 8,
                           metric="cosine")
    assert_topk_match(got[0], got[1], want[0], want[1], rtol=0.0, atol=1e-5)
    card, _ = _hnsw_pair(hnsw_card, route_mode="beam")
    before = cuda_topk.launches()
    card.search_batch(q[:8], 10)
    assert cuda_topk.launches() == before  # no scan on the beam route


def test_hnsw_build_index_device_on_cuda_tensor(hnsw_card):
    from vers_tpu_torch.index.hnsw import HNSWIndex

    x, q, idx = hnsw_card
    corpus = torch.zeros((20_096, 64), device="cuda")
    corpus[:20_000] = torch.from_numpy(x).cuda()
    h = HNSWIndex.build_index_device(4, 64, 32, 16, corpus, n_valid=20_000)
    assert h.device.type == "cuda"
    for (m1, a1, d1), (m2, a2, d2) in zip(h._pending_graph, idx._pending_graph):
        assert np.array_equal(m1, m2) and np.array_equal(a1, a2)
        assert np.array_equal(d1, d2)
    assert np.array_equal(h.search_batch(q, 10).ids, idx.search_batch(q, 10).ids)
    assert h._device_cache["vecs"] is h._corpus_dev


def test_hnsw_add_on_cuda(hnsw_card):
    from vers_tpu_torch.index.hnsw import HNSWIndex

    x, q, built = hnsw_card
    h = HNSWIndex.from_numpy(x, built._pending_graph, 64, 32, 4, 16,
                             device="cuda")
    h.search_batch(q[:4], 10)
    for k in range(3):
        h.add(q[k], 20_000 + k)
        assert h._last_add_patch is not None  # the device fast path
    res = h.search_batch(q[:3], 1)
    assert list(res.ids[:, 0]) == [20_000, 20_001, 20_002]


def test_hnsw_route_scan_raises_on_bad_input(hnsw_card):
    import dataclasses

    from vers_tpu_torch.ops import beam

    x, q, idx = hnsw_card
    cache = idx._ensure_device_cache()
    qd = torch.from_numpy(q).cuda()
    with pytest.raises(TypeError):  # f64 table: no fallback to the plain scan
        beam.route_scan(qd, cache["l1_tab"].double(), cache["n1"], 8)
    with pytest.raises(ValueError):  # non-contiguous table
        beam.route_scan(qd, cache["l1_tab"].t().contiguous().t(), cache["n1"], 8)
    with pytest.raises(ValueError):  # k past kernel A's 128
        beam.route_scan(qd, cache["l1_tab"], cache["n1"], 129)
    old = idx.config
    idx.config = dataclasses.replace(old, route_seeds=200)
    idx.ef_search = 256  # seeds = min(route_seeds, ef) = 200 > 128
    try:
        with pytest.raises(ValueError):
            idx.search_batch(q[:4], 10)
    finally:
        idx.config, idx.ef_search = old, 32
    before = cuda_topk.launches()
    idx.search_batch(q[:4], 10)
    assert cuda_topk.launches() == before + 1


# -- HNSW's options: the scan-routed build, the inline build, int8 ------


@pytest.mark.parametrize("k", [100, 1])
@pytest.mark.parametrize("q_n", [16, 256, 4096])
@pytest.mark.parametrize("rows", [8, 128, 41_547])
@pytest.mark.parametrize("n_valid", [0, 1, 99, None])
def test_distance_topk_build_scan_shapes(cuda, k, q_n, rows, n_valid):
    """Kernel A's bf16/default cosine route at the shapes of the
    scan-routed build (``ops/hnsw_build.scan_members``): bf16 member
    tables of unit rows, bf16-valued queries, the built prefix growing
    from nothing (None: the whole table); (+inf, -1) past it."""
    rng = np.random.default_rng(rows + q_n)
    d = 300

    def unit(n):
        v = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        return torch.nn.functional.normalize(v, dim=1).to(torch.bfloat16).to(cuda)

    tab, q = unit(rows), unit(q_n).float()
    n = rows if n_valid is None else n_valid
    before = cuda_topk.LAUNCHES_BY_ROUTE.get("bf16/default", 0)
    got = cuda_topk.cuda_distance_topk(q, tab, n, k, metric="cosine",
                                       precision="default")
    again = cuda_topk.cuda_distance_topk(q, tab, n, k, metric="cosine",
                                         precision="default")
    torch.cuda.synchronize()
    assert cuda_topk.LAUNCHES_BY_ROUTE["bf16/default"] == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = fused_scan_topk(q, tab, n, k, metric="cosine", precision="default")
    assert_topk_match(got[0], got[1], want[0], want[1], rtol=0.0, atol=1e-4)
    live = min(n, rows, k)
    assert (got[1][:, :live] >= 0).all() and (got[1][:, live:] == -1).all()
    assert torch.isinf(got[0][:, live:]).all()


def _hnsw_option_builds(hnsw_card, **kw):
    """The option's 20k build on the card and on the CPU, and the recall
    of each over the fixture's queries."""
    from vers_tpu_torch.index.hnsw import HNSWIndex
    from vers_tpu_torch.utils.harness import recall_at_k

    x, q, _ = hnsw_card
    truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
    out = []
    for device in ("cuda", "cpu"):
        h = HNSWIndex.build_index_batched(4, 64, 32, 16, x, device=device, **kw)
        out.append((h, recall_at_k(h.search_batch(q, 10).ids, truth)))
    return out


def test_hnsw_route_scan_build_on_cuda(hnsw_card):
    before = cuda_topk.LAUNCHES_BY_ROUTE.get("bf16/default", 0)
    plain = cuda_topk.LARGE_K_PLAIN
    (card, rec_card), (cpu, rec_cpu) = _hnsw_option_builds(hnsw_card,
                                                           route_scan=True)
    # the build's scans ran on kernel A (k = 64 and the seeds' k = 1),
    # then one routing scan by the search
    assert cuda_topk.LAUNCHES_BY_ROUTE["bf16/default"] > before + 20
    assert cuda_topk.LARGE_K_PLAIN == plain
    assert card.get_num_nodes_in_layers() == cpu.get_num_nodes_in_layers()
    assert card.get_num_nodes_in_layers() == \
        hnsw_card[2].get_num_nodes_in_layers()
    assert abs(rec_card - rec_cpu) <= 0.01, (rec_card, rec_cpu)
    assert rec_card > 0.95


def test_hnsw_inline_build_on_cuda(hnsw_card):
    (card, rec_card), (cpu, rec_cpu) = _hnsw_option_builds(
        hnsw_card, insert_inline=True)
    assert card.build_seconds["inline_table_bytes"] == 20_001 * 49 * 32 * 2
    assert card.get_num_nodes_in_layers() == cpu.get_num_nodes_in_layers()
    assert abs(rec_card - rec_cpu) <= 0.01, (rec_card, rec_cpu)
    assert rec_card > 0.95


def test_hnsw_int8_on_cuda_matches_cpu(hnsw_card):
    import dataclasses

    x, q, _ = hnsw_card
    card, cpu = _hnsw_pair(hnsw_card, nav_dtype="int8", nav_inline_dp=None)
    kc, cc = card._ensure_device_cache(), cpu._ensure_device_cache()
    assert kc["vecs_nav"].dtype == torch.int8
    assert torch.equal(kc["vecs_nav"].cpu(), cc["vecs_nav"])
    assert torch.equal(kc["nav_scales"].cpu(), cc["nav_scales"])
    for route in ("scan", "beam"):
        for h in (card, cpu):
            h.config = dataclasses.replace(h.config, route_mode=route)
        got, want = card.search_batch(q, 10), cpu.search_batch(q, 10)
        v = cc["vecs_nav"].double().numpy()
        sc = cc["nav_scales"].double().numpy()
        qn = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
        near_ties = 0
        for r in np.flatnonzero((got.ids != want.ids).any(axis=1)):
            a, b = set(got.ids[r].tolist()), set(want.ids[r].tolist())
            if a == b:
                continue
            near_ties += 1
            ids = sorted(a | b)
            d = np.sort(1.0 - (v[ids] @ qn[r]) * sc[ids])
            assert np.diff(d).min() < 1e-5, (route, r)
        assert near_ties <= 0.02 * q.shape[0], near_ties
        same = (got.ids == want.ids).all(axis=1)
        assert np.allclose(got.distances[same], want.distances[same],
                           rtol=0.0, atol=1e-5)
    # add on the card's int8 cache: the row and its scale as on the CPU
    for h in (card, cpu):
        h.add(q[5], 20_000)
        assert h._last_add_patch is not None
    assert torch.equal(card._device_cache["vecs_nav"][20_000].cpu(),
                       cpu._device_cache["vecs_nav"][20_000])
    assert torch.equal(card._device_cache["nav_scales"][20_000].cpu(),
                       cpu._device_cache["nav_scales"][20_000])
    assert card.search_batch(q[5:6], 1).ids[0, 0] == 20_000


# -- the multi-device layer: four shards on one card ----------------------


def _mesh4(cuda):
    from vers_tpu_torch.parallel import make_mesh

    return make_mesh(4, device="cuda:0")


def test_make_mesh_on_the_card(cuda):
    from vers_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count()))
    four = make_mesh(4, device="cuda:0")
    assert four.devices == (torch.device("cuda", 0),) * 4
    assert make_mesh(1).devices == (torch.device("cuda", 0),)


def _unit_clusters(n, d, q_n, seed):
    from vers_tpu_torch.utils.data import synthetic_gaussian

    return synthetic_gaussian(n, d, n_clusters=64, n_queries=q_n, seed=seed,
                              normalized=True, query_noise=0.5)


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_sharded_flat_on_cuda_matches_single(cuda, metric):
    import vers_tpu_torch as vt

    x, q = _unit_clusters(30_001, 64, 300, 1)
    mesh = _mesh4(cuda)
    sharded = vt.ShardedFlatIndex(x, ids=np.arange(30_001) + 7, mesh=mesh,
                                  metric=metric)
    assert all(p.is_cuda for p in sharded._data)
    single = vt.FlatIndex(x, ids=np.arange(30_001) + 7,
                          config=vt.FlatConfig(metric=metric), device="cuda")
    before = cuda_topk.launches()
    got = sharded.search_batch(q, 10)
    assert cuda_topk.launches() == before + 4  # kernel A once a shard
    want = single.search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))
    d, ids = sharded.search_batch_device(torch.from_numpy(q).cuda(), 10)
    assert ids.is_cuda and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.cpu().numpy(), got.ids)
    sharded.add(q[0], 99)  # in place into a shard's headroom
    assert sharded.search_batch(q[:1], 1).ids[0, 0] == 99


def test_sharded_ivf_on_cuda_matches_single(cuda):
    import vers_tpu_torch as vt

    x, q = _unit_clusters(40_000, 64, 512, 2)
    single = vt.IVFFlatIndex.build_index(64, 1, 5, x, device="cuda")
    counts = [10_000] * 4
    offs = np.cumsum([0] + counts)
    sharded = vt.ShardedIVFFlatIndex(
        64, single._centroids, [x[offs[s]:offs[s + 1]] for s in range(4)],
        [np.arange(offs[s], offs[s + 1]) for s in range(4)], mesh=_mesh4(cuda))
    # the shards bin their rows as the JAX package's numpy difference form
    # does, bit for bit; the single index, which bins by the matmul form,
    # is rebuilt on those bins, so that both scan the same clusters
    bins = np.concatenate([sharded._assign(s) for s in range(4)])
    c = single._centroids
    want_bins = np.argmin(np.stack([((x - c[j][None, :]) ** 2).sum(-1)
                                    for j in range(64)], axis=1), axis=1)
    np.testing.assert_array_equal(bins, want_bins)
    members = [np.flatnonzero(bins == j).tolist() for j in range(64)]
    single = vt.IVFFlatIndex(64, x, c, bins, members, device="cuda")
    for nprobe in (1, 2, 5):
        before = cuda_binned.LAUNCHES
        got = sharded.search_batch(q, 10, nprobe=nprobe)
        assert cuda_binned.LAUNCHES == before + 4  # kernel B once a shard
        want = single.search_batch(q, 10, nprobe=nprobe)
        _check((got.distances, got.ids), (want.distances, want.ids))


@pytest.mark.parametrize("d", [7, 37, 300])
def test_difference_form_bins_on_cuda_match_numpy(cuda, d):
    from vers_tpu_torch.parallel.ivf import assign_difference_form

    v, c = _near_tie_rows(d)
    got = assign_difference_form(torch.from_numpy(v).cuda(),
                                 torch.from_numpy(c).cuda(), chunk_elems=4096)
    want = np.argmin(((v[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _near_tie_rows(d, seed=0):
    """Rows within float32 rounding of the midpoint of two close
    centroids, and some far rows: the two distance forms bin many of
    the near rows apart."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((6, d)).astype(np.float32)
    c[1] = c[0] + 1e-3 * rng.standard_normal(d).astype(np.float32)
    v = ((c[0] + c[1]) / 2 + 1e-5 * rng.standard_normal((400, d)))
    far = 3 * rng.standard_normal((100, d))
    return np.concatenate([v, far]).astype(np.float32), c


def test_sharded_ivf_build_on_cuda(cuda):
    import vers_tpu_torch as vt

    x, q = _unit_clusters(20_000, 32, 256, 3)
    idx = vt.ShardedIVFFlatIndex.build_index(32, 2, 5, x, mesh=_mesh4(cuda))
    assert idx._centroids.shape == (32, 32)
    truth = vt.FlatIndex(x, device="cuda").search_batch(q, 10).ids
    assert vt.recall_at_k(idx.search_batch(q, 10, nprobe=4).ids, truth) > 0.9


@pytest.mark.parametrize("probes", [None, 1, 3])
def test_sharded_forest_on_cuda_matches_single(cuda, probes):
    import vers_tpu_torch as vt

    idx, x, q = _forest_on(cuda, 20_000, 48, 40, trees=5)
    sharded = vt.ShardedANNIndex(idx, mesh=_mesh4(cuda))
    before = cuda_binned.LAUNCHES
    got = sharded.search_batch(q, 10, probes)
    assert cuda_binned.LAUNCHES == before + 4 * 5  # a shard and tree each
    want = idx.search_batch(q, 10, probes)
    _check((got.distances, got.ids), (want.distances, want.ids))


def test_partitioned_forest_on_cuda_matches_cpu(cuda):
    import vers_tpu_torch as vt
    from vers_tpu_torch.parallel import make_mesh

    x, q = _unit_clusters(20_000, 48, 256, 4)
    card = vt.PartitionedANNIndex.build_index(4, 40, x, mesh=_mesh4(cuda))
    assert all(s.device.type == "cuda" for s in card.shards)
    cpu = vt.PartitionedANNIndex(
        [vt.ANNIndex.from_numpy(40, s._trees, s._values, s._ids, device="cpu")
         for s in card.shards], gids=card.gids, mesh=make_mesh(4, device="cpu"))
    before = cuda_binned.LAUNCHES
    got = card.search_batch(q, 10, probes_per_tree=2)
    assert cuda_binned.LAUNCHES == before + 4 * 4
    want = cpu.search_batch(q, 10, probes_per_tree=2)
    _check((got.distances, got.ids), (want.distances, want.ids))


def test_partitioned_hnsw_on_cuda_matches_cpu(cuda):
    import vers_tpu_torch as vt
    from vers_tpu_torch.parallel import make_mesh

    x, q = _unit_clusters(4_000, 32, 128, 5)
    card = vt.PartitionedHNSWIndex.build_index(3, 32, 32, 8, x,
                                               mesh=_mesh4(cuda), batched=False)
    cpu = vt.PartitionedHNSWIndex.build_index(3, 32, 32, 8, x,
                                              mesh=make_mesh(4, device="cpu"),
                                              batched=False)
    before = cuda_topk.launches()
    got = card.search_batch(q, 10)
    assert cuda_topk.launches() == before + 4  # a routing scan a shard
    want = cpu.search_batch(q, 10)
    # as the single-device HNSW test: rows may differ only at near-ties
    # of bf16 nav distances
    xn = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    qn = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    for r in np.flatnonzero((got.ids != want.ids).any(axis=1)):
        a, b = set(got.ids[r].tolist()), set(want.ids[r].tolist())
        if a != b:
            d = np.sort(1.0 - xn[sorted(a | b)] @ qn[r])
            assert np.diff(d).min() < 1e-5, r
    same = (got.ids == want.ids).all(axis=1)
    assert same.mean() >= 0.98
    assert np.allclose(got.distances[same], want.distances[same], rtol=0.0,
                       atol=1e-5)


def test_sharded_hnsw_on_cuda_matches_beam_route(hnsw_card):
    import vers_tpu_torch as vt
    from vers_tpu_torch.parallel import make_mesh

    x, q, _ = hnsw_card
    card, _ = _hnsw_pair(hnsw_card, route_mode="beam")
    sharded = vt.ShardedHNSWIndex(card, mesh=make_mesh(4, device="cuda:0"))
    got = sharded.search_batch(q, 10)
    want = card.search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))


# about 0.1 s of spinning on an H100's clock
SLEEP_CYCLES = 200_000_000


def test_map_shards_gives_each_shard_its_stream(cuda):
    """On a 4-shard mesh of one card each body runs on a stream of its
    own, under its card, on a thread of its own (shard 0's the
    caller's)."""
    import threading

    from vers_tpu_torch.parallel.mesh import map_shards

    mesh = _mesh4(cuda)
    caller = torch.cuda.current_stream().cuda_stream
    out = map_shards(mesh, lambda s, dev: (
        torch.cuda.current_stream().cuda_stream, torch.cuda.current_device(),
        threading.get_ident()))
    streams = [o[0] for o in out]
    assert len(set(streams)) == 4 and caller not in streams
    assert streams == [mesh.stream(s).cuda_stream for s in range(4)]
    assert [o[1] for o in out] == [0] * 4
    assert len({o[2] for o in out}) == 4
    assert out[0][2] == threading.get_ident()
    assert torch.cuda.current_stream().cuda_stream == caller


def test_sharded_search_waits_for_the_caller_and_every_shard(
        cuda, monkeypatch):
    """The queries are written on the caller's stream behind a sleep,
    and shard 0's scan starts behind another sleep on its own stream: a
    shard that did not wait for the caller would scan unwritten queries,
    and a merge that did not wait for shard 0 would read its unwritten
    (+inf, -1) part. The result equals the single-device twin's."""
    import vers_tpu_torch as vt
    from vers_tpu_torch.parallel import search as search_mod
    from vers_tpu_torch.parallel.mesh import current_shard

    x, q = _unit_clusters(30_001, 64, 300, 7)
    sharded = vt.ShardedFlatIndex(x, mesh=_mesh4(cuda))
    want = vt.FlatIndex(x, device="cuda").search_batch(q, 10)
    real = search_mod.distance_topk

    def late(*args, **kw):
        if current_shard() == 0:
            torch.cuda._sleep(SLEEP_CYCLES)  # on shard 0's stream
        return real(*args, **kw)

    monkeypatch.setattr(search_mod, "distance_topk", late)
    qd = torch.from_numpy(q).cuda()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):  # the caller on a stream of its own
        # a first search on other queries fills every stream's memory
        # pool (a cudaMalloc would synchronise the card and hide a missing
        # wait) and leaves blocks that hold no right answer
        sharded.search_batch(qd.flip(0) * 1.0, 10)
        torch.cuda._sleep(SLEEP_CYCLES)
        late_q = qd * 1.0  # written after the sleep
        got = sharded.search_batch(late_q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))


def test_a_shard_that_raises_on_the_card_makes_the_search_raise(
        cuda, monkeypatch):
    import vers_tpu_torch as vt
    from vers_tpu_torch.parallel import search as search_mod
    from vers_tpu_torch.parallel.mesh import current_shard

    x, q = _unit_clusters(5_000, 32, 64, 8)
    sharded = vt.ShardedFlatIndex(x, mesh=_mesh4(cuda))
    real = search_mod.distance_topk
    merged = []

    def scan(*args, **kw):
        if current_shard() == 2:
            raise RuntimeError("shard 2's scan")
        return real(*args, **kw)

    monkeypatch.setattr(search_mod, "distance_topk", scan)
    monkeypatch.setattr(search_mod, "merge_topk", lambda *a: merged.append(a))
    with pytest.raises(RuntimeError, match="shard 2's scan"):
        sharded.search_batch(q, 10)
    assert merged == []


def test_parallel_across_cards(cuda):
    """Every class on a mesh of one shard per card (``make_mesh()``),
    the shards' bodies at once, the replicated indexes copied from cuda:0
    to the other cards, equal to the single-device search (the sharded
    HNSW with the bf16 and the int8 navigation table), or to the same
    class on a mesh of as many shards on cuda:0 (a sharded Lloyd step,
    to rounding; the partitioned HNSW). Needs two cards or more."""
    import dataclasses

    import vers_tpu_torch as vt
    from vers_tpu_torch.parallel import make_mesh, shard_rows, sharded_lloyd_step

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two CUDA devices or more")
    mesh = make_mesh()
    assert mesh.size == cards and len(set(mesh.devices)) == cards
    x, q = _unit_clusters(20_000, 48, 256, 6)
    got = vt.ShardedFlatIndex(x, mesh=mesh).search_batch(q, 10)
    want = vt.FlatIndex(x, device="cuda:0").search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))

    single = vt.IVFFlatIndex.build_index(32, 1, 5, x, device="cuda:0")
    blocks = np.array_split(np.arange(len(x)), cards)
    sivf = vt.ShardedIVFFlatIndex(32, single._centroids,
                                  [x[b] for b in blocks], blocks, mesh=mesh)
    got, want = sivf.search_batch(q, 10, nprobe=2), single.search_batch(q, 10, 2)
    _check((got.distances, got.ids), (want.distances, want.ids))
    built = vt.ShardedIVFFlatIndex.build_index(32, 1, 5, x, mesh=mesh)
    truth = vt.FlatIndex(x, device="cuda:0").search_batch(q, 10).ids
    assert vt.recall_at_k(built.search_batch(q, 10, nprobe=4).ids, truth) > 0.9
    # one Lloyd step from the same centroids, the psum across cards against
    # the same shards on cuda:0: equal up to the order of index_add_'s
    # atomics within a shard
    one_card = make_mesh(cards, device="cuda:0")
    init = torch.from_numpy(x[:32].copy())
    steps = [sharded_lloyd_step(*shard_rows(x, m), init, m) for m in
             (mesh, one_card)]
    assert steps[0][0].device == torch.device("cuda", 0)
    torch.testing.assert_close(steps[0][0], steps[1][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(steps[0][1], steps[1][1], rtol=1e-5, atol=0.0)

    forest = vt.ANNIndex.build_index(4, 40, x, np.arange(len(x)),
                                     device="cuda:0")
    got = vt.ShardedANNIndex(forest, mesh=mesh).search_batch(q, 10)
    want = forest.search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))

    h = vt.HNSWIndex.build_index(3, 32, 32, 8, x[:3000], device="cuda:0")
    h.config = dataclasses.replace(h.config, route_mode="beam")
    got = vt.ShardedHNSWIndex(h, mesh=mesh).search_batch(q, 10)
    want = h.search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))
    h.config = dataclasses.replace(h.config, nav_dtype="int8",
                                   nav_inline_dp=None)
    h._device_cache = None
    got = vt.ShardedHNSWIndex(h, mesh=mesh).search_batch(q, 10)
    want = h.search_batch(q, 10)
    assert h._device_cache["vecs_nav"].dtype == torch.int8
    _check((got.distances, got.ids), (want.distances, want.ids))

    pa = vt.PartitionedANNIndex.build_index(4, 40, x, mesh=mesh)
    assert [s.device for s in pa.shards] == list(mesh.devices)
    cpu = vt.PartitionedANNIndex(
        [vt.ANNIndex.from_numpy(40, s._trees, s._values, s._ids, device="cpu")
         for s in pa.shards], gids=pa.gids, mesh=make_mesh(cards, device="cpu"))
    got, want = pa.search_batch(q, 10), cpu.search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))

    ph = vt.PartitionedHNSWIndex.build_index(3, 32, 32, 8, x[:4000], mesh=mesh,
                                             batched=False)
    assert [c.device for c in ph._ensure_device_cache()["vecs"]] == list(
        mesh.devices)
    res = ph.search_batch(x[:64], 5)
    assert (res.ids[:, 0] == np.arange(64)).all()
    twin = vt.PartitionedHNSWIndex.build_index(3, 32, 32, 8, x[:4000],
                                               mesh=one_card, batched=False)
    got, want = ph.search_batch(q, 10), twin.search_batch(q, 10)
    _check((got.distances, got.ids), (want.distances, want.ids))


# -- the searches as CUDA graphs (``vers_tpu_torch.graphs``) -----------------


def _bitwise(got, want):
    """Ids equal, distances equal bit for bit."""
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def _first_replay_eager(search):
    """A search's capturing call (its second: the first runs eagerly;
    the answer is the capture's warm-up), a replay, and the same search
    eagerly (``graphs.disabled``)."""
    from vers_tpu_torch import graphs

    search()
    first, replay = search(), search()
    with graphs.disabled():
        eager = search()
    return first, replay, eager


@pytest.fixture(scope="module")
def graph_indexes():
    """An IVF index of 4000 x 24 unit rows (32 clusters) and a forest of
    five trees over 20k x 48 unit rows, each with its queries on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import vers_tpu_torch as vt

    cuda = torch.device("cuda")
    x, q = _clustered()
    ivf = vt.IVFFlatIndex.build_index(32, 2, 10, x, device=cuda)
    forest, fx, fq = _forest_on(cuda, 20_000, 48, 40, trees=5)
    return dict(ivf=ivf, x=x, qd=torch.from_numpy(q).to(cuda), forest=forest,
                fx=fx, fqd=torch.from_numpy(fq).to(cuda))


GRAPH_SEARCHES = [("ivf", 1), ("ivf", 2), ("ivf", 0), ("forest", 1),
                  ("forest", 4), ("forest", None)]


def _graph_search(ix, kind, setting):
    if kind == "ivf":
        return lambda q=ix["qd"]: ix["ivf"].search_batch_device(q, 10, setting)
    return lambda q=ix["fqd"]: ix["forest"].search_batch_device(q, 10, setting)


@pytest.mark.parametrize("kind,setting", GRAPH_SEARCHES)
def test_graph_replay_equals_eager(graph_indexes, kind, setting):
    cache = graph_indexes[kind]._graphs
    sites = len(cache.sites())
    first, replay, eager = _first_replay_eager(
        _graph_search(graph_indexes, kind, setting))
    _bitwise(first, eager)
    _bitwise(replay, eager)
    if kind == "ivf" and setting == 0:
        assert len(cache.sites()) == sites  # the adaptive depth: eager
    else:
        assert cache.sites()


@pytest.mark.parametrize("kind,setting", GRAPH_SEARCHES)
def test_graph_searches_read_nothing_on_the_host(graph_indexes, kind, setting):
    """After a configuration's capture (its second call), its searches
    enqueue with no host synchronisation (IVF: every nprobe, the
    adaptive depth eagerly; the forest: every probe setting)."""
    search = _graph_search(graph_indexes, kind, setting)
    want = search()
    search()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [search() for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g in got:
        _bitwise(g, want)


@pytest.mark.parametrize("kind,setting", [("ivf", 2), ("forest", 1)])
def test_chained_graph_searches_equal_separate_ones(graph_indexes, kind,
                                                    setting):
    """Eight calls chained with one drain at the end (``docs/SERVING.md``'s
    pipelined model) equal the same eight calls each drained."""
    ix = graph_indexes
    q = ix["qd"] if kind == "ivf" else ix["fqd"]
    batches = [torch.roll(q, 7 * i, 0) * 1.0 for i in range(8)]
    search = _graph_search(ix, kind, setting)
    chained = [search(b) for b in batches]
    torch.cuda.synchronize()
    for b, c in zip(batches, chained):
        one = search(b)
        torch.cuda.synchronize()
        _bitwise(c, one)
    assert len({c[0].data_ptr() for c in chained}) == 8


def test_graph_replays_count_their_launches(graph_indexes, hnsw_card):
    """Kernel B once a search (IVF) or a tree (the forest), kernel A once
    a search (HNSW's routing scan): on the capturing call (its warm-up)
    and on every replay."""
    ix = graph_indexes
    qd = ix["qd"][:64]
    for search, counter, per in (
            (lambda: ix["ivf"].search_batch_device(qd, 10, 3),
             lambda: cuda_binned.LAUNCHES, 1),
            (lambda: ix["forest"].search_batch_device(ix["fqd"][:64], 10, 2),
             lambda: cuda_binned.LAUNCHES, 5),
            (lambda: hnsw_card[2].search_batch_device(
                torch.from_numpy(hnsw_card[1][:64]).cuda(), 10),
             cuda_topk.launches, 1)):
        for _ in range(4):
            before = counter()
            search()
            assert counter() == before + per
    site = ix["ivf"]._graphs.sites()[-1]
    (g,) = site.graphs.values()
    # 64 queries: the split walk (``cuda_binned.split_walk``); three
    # probe ranks: kernel F merges them
    assert [(key, n) for _, key, n in g.launches] == [
        ("LAUNCHES", 1), ("LAUNCHES_SPLIT", 1), ("LAUNCHES_MERGE", 1)]


def test_small_graph_search_takes_the_split_walk(graph_indexes):
    """A 64-query IVF search at nprobe 2 (an online-retrieval batch)
    takes kernel B's split walk, counted on every replay, and replays
    with no host synchronisation, equal to its eager run bit for bit; a
    16384-query search keeps the run walk."""
    ivf = graph_indexes["ivf"]
    q = graph_indexes["qd"][:64].contiguous()
    search = lambda: ivf.search_batch_device(q, 10, 2)  # noqa: E731
    want = search()  # eager; the second call captures
    search()
    torch.cuda.synchronize()
    before = cuda_binned.LAUNCHES_SPLIT
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [search() for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_binned.LAUNCHES_SPLIT == before + 3
    for g in got:
        _bitwise(g, want)
    big = torch.nn.functional.normalize(
        torch.randn((16384, q.shape[1]), device=q.device), dim=1)
    before = (cuda_binned.LAUNCHES, cuda_binned.LAUNCHES_SPLIT)
    ivf.search_batch_device(big, 10, 2)
    torch.cuda.synchronize()
    assert (cuda_binned.LAUNCHES - before[0],
            cuda_binned.LAUNCHES_SPLIT - before[1]) == (1, 0)


@pytest.mark.parametrize("cfg", [{}, dict(nav_inline_dp=32),
                                 dict(nav_dtype="int8", nav_inline_dp=None),
                                 dict(route_mode="beam")])
def test_hnsw_graph_replay_equals_eager(hnsw_card, cfg):
    """The scan-routed search with the classic beam, the inline beam and
    the int8 table, and the beam route: replays equal the eager search."""
    x, q, _ = hnsw_card
    card, _ = _hnsw_pair(hnsw_card, **cfg)
    qd = torch.from_numpy(q).cuda()
    first, replay, eager = _first_replay_eager(
        lambda: card.search_batch_device(qd, 10))
    _bitwise(first, eager)
    _bitwise(replay, eager)
    assert (card._device_cache["inline"] is not None) == (
        cfg.get("nav_inline_dp") == 32)
    assert card._graphs.sites()


def test_graph_search_after_add_equals_a_fresh_index(graph_indexes):
    """Search, add, search: the graphs of the old state are dropped, and
    the result equals a fresh index's eager search over the same rows."""
    import vers_tpu_torch as vt
    from vers_tpu_torch import graphs

    ix = graph_indexes

    def search(idx, q, k=10):  # IVF at nprobe 2: 0 runs eagerly
        if isinstance(idx, vt.IVFFlatIndex):
            return idx.search_batch_device(q, k, 2)
        return idx.search_batch_device(q, k)

    ivf = vt.IVFFlatIndex.from_numpy(
        32, ix["ivf"]._values, ix["ivf"]._centroids, ix["ivf"]._assignments,
        ix["ivf"]._ids, device="cuda")
    forest = vt.ANNIndex.from_numpy(40, ix["forest"]._trees,
                                    ix["forest"]._values, ix["forest"]._ids,
                                    device="cuda")
    for idx, q, new in ((ivf, ix["qd"], ix["x"][3] * 1.001),
                        (forest, ix["fqd"], ix["fx"][3] * 1.001)):
        for _ in range(3):
            search(idx, q)
        assert idx._graphs.sites()
        n = len(idx._values)
        idx.add(new, n)
        assert not idx._graphs.sites()
        for _ in range(3):  # the new state's first call, capture, replay
            got = search(idx, q)
        if isinstance(idx, vt.IVFFlatIndex):
            fresh = vt.IVFFlatIndex.from_numpy(
                32, idx._values, idx._centroids, idx._assignments, idx._ids,
                device="cuda")
        else:
            fresh = vt.ANNIndex.from_numpy(40, idx._trees, idx._values,
                                           idx._ids, device="cuda")
        with graphs.disabled():
            want = search(fresh, q)
            own = search(idx, q)
        _bitwise(got, own)
        _check(got, want)
        found = search(idx, torch.from_numpy(new[None]).cuda(), 1)
        assert int(found[1][0, 0]) == n


@pytest.mark.parametrize("kind", ["ivf", "forest", "hnsw"])
def test_sharded_graphs_on_one_card_equal_eager_and_the_twin(
        graph_indexes, hnsw_card, kind):
    """Four shards on one card, each replaying its own graphs on its
    stream: equal to the same search eagerly, bit for bit, and to the
    single-device twin."""
    import vers_tpu_torch as vt

    ix = graph_indexes
    mesh = _mesh4(torch.device("cuda"))
    if kind == "ivf":
        single = ix["ivf"]
        blocks = np.array_split(np.arange(len(ix["x"])), 4)
        sharded = vt.ShardedIVFFlatIndex(32, single._centroids,
                                         [ix["x"][b] for b in blocks], blocks,
                                         mesh=mesh)
        q = ix["qd"]
        search = lambda: sharded.search_batch(q, 10, nprobe=2)  # noqa: E731
        # the twin over the shards' own bins (numpy's difference form)
        bins = np.concatenate([sharded._assign(s) for s in range(4)])
        members = [np.flatnonzero(bins == j).tolist() for j in range(32)]
        twin = vt.IVFFlatIndex(32, ix["x"], single._centroids, bins, members,
                               device="cuda").search_batch(q, 10, nprobe=2)
    elif kind == "forest":
        sharded = vt.ShardedANNIndex(ix["forest"], mesh=mesh)
        q = ix["fqd"]
        search = lambda: sharded.search_batch(q, 10, 1)  # noqa: E731
        twin = ix["forest"].search_batch(q, 10, 1)
    else:
        card, _ = _hnsw_pair(hnsw_card, route_mode="beam")
        sharded = vt.ShardedHNSWIndex(card, mesh=mesh)
        q = torch.from_numpy(hnsw_card[1]).cuda()
        search = lambda: sharded.search_batch(q, 10)  # noqa: E731
        twin = card.search_batch(q, 10)
    first, replay, eager = _first_replay_eager(search)
    for got in (first, replay):
        np.testing.assert_array_equal(got.ids, eager.ids)
        np.testing.assert_array_equal(got.distances.view(np.int32),
                                      eager.distances.view(np.int32))
    assert all(g.sites() for g in sharded._graphs)
    _check((replay.distances, replay.ids), (twin.distances, twin.ids))


def test_two_threads_search_one_index_at_once(graph_indexes):
    """Two host threads replay one IVF index's graph at once, each on its
    own stream with its own queries: each gets the eager answer to its
    own queries (a cache's load, replay and take are one thread's at a
    time)."""
    import threading

    from vers_tpu_torch import graphs

    ivf = graph_indexes["ivf"]
    qs = [graph_indexes["qd"], torch.roll(graph_indexes["qd"], 11, 0) * 1.0]
    with graphs.disabled():
        want = [ivf.search_batch_device(q, 10, 2) for q in qs]
    for _ in range(2):  # the first call and the capture
        ivf.search_batch_device(qs[0], 10, 2)
    got = [[], []]

    def worker(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for _ in range(50):
                got[i].append(ivf.search_batch_device(qs[i], 10, 2))
        stream.synchronize()

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in (0, 1):
        assert len(got[i]) == 50
        for g in got[i]:
            _bitwise(g, want[i])
