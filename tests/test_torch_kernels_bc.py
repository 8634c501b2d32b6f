"""Host-side pieces of kernels B and C of vers_tpu_torch, on the CPU.

Kernel C (values top-k): its sort key as a torch function, its
threshold-and-buffer walk in plain Python and its plain version, on
adversarial tables (all-equal rows, duplicates across lane and step
boundaries, +-0, rows with fewer than k finite values, W < k, W = 1,
k = 1 and 128), against each other and against the JAX Pallas kernel in
interpret mode. Kernel C only selects: every comparison is exact.

Kernel B (packed scan): the host mirror of its two walks (units, live
tiles, issued and useful products) and the plain walk over live tiles
alone, against ``packed_scan_plain`` and the JAX Pallas kernel in
interpret mode, on the inputs tests/test_torch_binned.py builds and on a
search layout with empty lists. Ids are compared tie-aware,
distances to rtol 1e-4 / atol 1e-5 (f32 matmuls of other shapes sum in
other orders); the split walk equals the run walk bit for bit. The rule
that picks the walk, ``split_walk``, at the benchmark's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_binned import _jax_statics, _scan_inputs
from vers_tpu.ops import pallas_binned as jpb
from vers_tpu.ops.pallas_topk import pallas_topk_values
from vers_tpu_torch.core import round_up
from vers_tpu_torch.ops import binned as tb
from vers_tpu_torch.ops import cuda_binned as tpb
from vers_tpu_torch.ops import cuda_topk
from vers_tpu_torch.ops.topk import (
    ordered_value_keys,
    topk_values_plain,
    topk_values_stream_plain,
)
from vers_tpu_torch.utils.data import TOPK_TABLE_KINDS as KINDS
from vers_tpu_torch.utils.data import adversarial_topk_table
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)


def _table(kind, q_n, w, seed=0):
    return tuple(torch.from_numpy(t)
                 for t in adversarial_topk_table(kind, q_n, w, seed))


SHAPES = [(6, 700, 1), (5, 33, 8), (4, 1000, 32), (3, 100, 128), (4, 1, 1),
          (5, 20, 10), (2, 1500, 128), (4, 999, 10)]


@pytest.mark.parametrize("kind", KINDS)
def test_ordered_value_keys_sort_like_a_stable_sort(kind):
    vals, _ = _table(kind, 7, 600)
    order = torch.argsort(ordered_value_keys(vals), dim=1)
    want = torch.sort(vals, dim=1, stable=True)[1]
    assert torch.equal(order, want)


def test_ordered_value_keys_zero_and_infinity():
    vals = torch.tensor([[0.0, -0.0, float("inf"), -float("inf"), -1e-45,
                          1e-45, 3.4e38, -3.4e38]])
    keys = ordered_value_keys(vals)[0]
    assert (keys >= 0).all()
    high = keys >> 31
    assert high[0] == high[1]  # -0.0 keyed as +0.0: the column decides
    assert keys[0] < keys[1]
    want = [3, 7, 4, 0, 1, 5, 6, 2]  # -inf, -max, -denorm, 0, -0, denorm, max, inf
    assert torch.argsort(keys).tolist() == want


@pytest.mark.parametrize("k", [1, 10, 32, 100, 128])
def test_values_buffer_keys(k):
    cap = cuda_topk.values_buffer_keys(k)
    assert cap & (cap - 1) == 0 and cap >= max(64, k + 32, 4 * k)
    assert cap < 2 * max(64, k + 32, 4 * k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q_n,w,k", SHAPES)
def test_topk_values_stream_walk_matches_plain(kind, q_n, w, k):
    """The kernel's walk (one threshold per row, candidate buffer, prune
    when full) selects exactly what the stable sort selects."""
    vals, ids = _table(kind, q_n, w, seed=k)
    want = topk_values_plain(vals, ids, k)
    got = topk_values_stream_plain(vals, ids, k, cuda_topk.values_buffer_keys(k))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the smallest buffer the kernel accepts prunes most often
    tight = topk_values_stream_plain(vals, ids, k, k + 32)
    assert torch.equal(tight[0], want[0]) and torch.equal(tight[1], want[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("w,k", [(700, 1), (33, 8), (1000, 32), (100, 128),
                                 (1, 1), (20, 10)])
def test_topk_values_plain_matches_pallas_on_adversarial_tables(kind, w, k):
    vals, ids = _table(kind, 16, w, seed=w)
    wd, wi = pallas_topk_values(jnp.asarray(vals.numpy()),
                                jnp.asarray(ids.numpy()), k, query_tile=8,
                                chunk_size=128, interpret=True)
    gd, gi = cuda_topk.topk_values(vals, ids, k)
    if kind == "sparse":  # -inf: both give the value; the port's id is -1
        assert gi[0, 0] == -1 and gd[0, 0] == -float("inf")
        gd, gi, wd, wi = gd[1:], gi[1:], np.asarray(wd)[1:], np.asarray(wi)[1:]
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_topk_values_plain_tie_rule_on_equal_rows():
    vals, ids = _table("equal", 3, 300)
    d, i = topk_values_plain(vals, ids, 128)
    assert torch.equal(i, ids[:, :128]) and (d == 0.25).all()


# -- kernel B ----------------------------------------------------------

SCANS = [(3000, 32, 16, 200, 1, False), (3000, 32, 16, 500, 3, True),
         (997, 16, 7, 33, 2, True)]
# small batches, where the split walk engages, and a layout with two
# empty lists, its ranks spread over all bins
SMALL_SCANS = [(3000, 32, 16, q_n, p, True) for q_n in (1, 7, 64)
               for p in (1, 2)] + [(3000, 32, 16, 200, 2, True),
                                   (2500, 16, 14, 64, 2, "forest"),
                                   (2500, 16, 14, 200, 3, "forest")]


def _walks(shapes, split_only=()):
    """(shape, split) cases: the run walk under the shape's own id, the
    split walk's ending in ``-split``."""
    def name(shape):
        return "-".join(str(v) for v in shape)
    return ([pytest.param(*s, False, id=name(s)) for s in shapes]
            + [pytest.param(*s, True, id=name(s) + "-split")
               for s in list(shapes) + list(split_only)])


def _tensors(arrays):
    return {a: torch.from_numpy(v) for a, v in arrays.items()}


def _forest_inputs(n, d, k, q_n, p, q_blk):
    """Kernel-B inputs as ``_fused_core`` builds them over a layout in
    which two bins are empty lists, every rank probing any bin. Same
    form as ``_scan_inputs``."""
    rng = np.random.default_rng(q_n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    bins = (rng.random(n) ** 2 * k).astype(np.int64)
    bins[np.isin(bins, [2, k - 3])] = 4
    layout = tb.make_layout(x, bins, k)
    r_blk = round_up(layout["max_bin"], 128)
    padded = tpb.padded_group_layout(layout, r_blk)
    q = torch.from_numpy(rng.normal(size=(q_n, d)).astype(np.float32))
    probes = torch.from_numpy(rng.integers(0, k, (q_n, p)))
    with tb.captured_scans() as calls:
        tb._fused_core(
            q, probes, padded["corpus"], padded["rbin"], padded["xx"],
            padded["s2o"], padded["g_first"], num_bins=k, nprobe=p, top_k=10,
            q_blk=q_blk, r_blk=r_blk, chunk=128, metric="sq_euclidean",
            probes_given=True, kernel_ids=True)
    (args, kw), = calls
    names = ("q_stack", "qbin_stack", "qb", "gb", "corpus_padded",
             "rbin_padded", "xx_padded")
    arrays = {a: v.numpy().copy() for a, v in zip(names, args)}
    arrays["ids_padded"] = kw.pop("ids_padded").numpy().copy()
    kw.pop("metric")
    assert (np.asarray(layout["sizes_host"]) == 0).sum() == 2
    return arrays, kw, arrays["qbin_stack"].reshape(-1), k


def _inputs(n, d, k, q_n, p, skew, q_blk=64):
    if skew == "forest":
        return _forest_inputs(n, d, k, q_n, p, q_blk)
    return _scan_inputs(n, d, k, q_n, p, skew, q_blk=q_blk)


def test_split_walk_rule():
    """The split walk where the run walk's units, one for each 64-row
    part of each query block, are fewer than the SMs; the run walk from
    exactly as many on, as at the benchmark's bulk and adaptive shapes
    (stacked rows: pairs padded to blocks, plus the scratch block)."""
    assert tpb.split_walk(128, 128, 132)
    assert tpb.split_walk(3 * 128, 128, 132)  # 64 queries at nprobe 2
    assert tpb.split_walk(17 * 128, 128, 132)  # 1024 queries at nprobe 2
    assert not tpb.split_walk(2 * 16384 + 128, 128, 132)  # wiki bulk
    assert not tpb.split_walk(2 * 10112 + 128, 128, 132)  # SIFT bulk
    assert not tpb.split_walk(263 * 16384 + 128, 128, 132)  # adaptive
    assert not tpb.split_walk(16384 + 128, 128, 132)  # a forest's tree
    assert tpb.split_walk(65 * 128, 128, 132)  # 130 units
    assert not tpb.split_walk(66 * 128, 128, 132)  # 132 units: the edge
    assert not tpb.split_walk(67 * 128, 128, 132)
    assert tpb.split_walk(131 * 64, 64, 132)  # one part a block
    assert not tpb.split_walk(132 * 64, 64, 132)


@pytest.mark.parametrize("q_blk", [64, 128])
@pytest.mark.parametrize("n,d,k,q_n,p,skew,split",
                         _walks(SCANS, SMALL_SCANS[-3:]))
def test_packed_scan_units_cover_every_needed_row(n, d, k, q_n, p, skew, q_blk,
                                                  split):
    """Every corpus row that shares a bin with a query row a unit writes
    lies in one of the unit's live tiles, tiles come in item and row
    order, and each stacked row is written by one unit at most: every
    live row in the run walk, every row whose bin holds corpus rows in
    the split walk, whose units walk one item and write the rows of
    their part inside their group's bin range."""
    arrays, statics, qbin, num_bins = _inputs(n, d, k, q_n, p, skew,
                                              q_blk=q_blk)
    r_blk = statics["chunk"] * statics["r_chunks"]
    rbin = arrays["rbin_padded"].reshape(-1)
    units = tpb.packed_scan_units(arrays["qbin_stack"], arrays["qb"],
                                  arrays["gb"], rbin, q_blk, r_blk, split)
    seen = np.zeros(qbin.shape[0], bool)
    for row0, nq, tiles, (w, end) in units:
        part0 = row0 - row0 % q_blk % tpb.QUERY_TILE
        assert 1 <= nq and row0 + nq <= part0 + tpb.QUERY_TILE
        assert end == w + 1 if split else row0 == part0
        assert not seen[row0 : row0 + nq].any()
        seen[row0 : row0 + nq] = True
        assert (arrays["qb"][w:end] == row0 // q_blk).all()
        groups = arrays["gb"][w:end]
        if split:  # the rows lie in the group's bin range
            own = rbin[groups[0] * r_blk : (groups[0] + 1) * r_blk]
            own = own[own >= 0]
            assert own.min() <= qbin[row0 : row0 + nq].min()
            assert qbin[row0 : row0 + nq].max() <= own.max()
        # item order, then row order: group ordinals never fall back, and
        # rows ascend within a group (a group may recur in a long run)
        where = [list(groups).index(t // r_blk) for t in tiles]
        assert where == sorted(where)
        assert all(a < b for a, b, i, j in zip(tiles, tiles[1:], where,
                                               where[1:]) if i == j)
        covered = np.zeros(rbin.shape[0], bool)
        for t in tiles:
            covered[t : t + min(tpb.TILE_ROWS, r_blk - t % r_blk)] = True
        bins = qbin[row0 : row0 + nq]
        for g in groups:
            rows = np.arange(g * r_blk, (g + 1) * r_blk)
            needed = np.isin(rbin[rows], bins[bins >= 0])
            assert covered[rows[needed]].all()
    live = (qbin >= 0) & (qbin < num_bins)
    if split:
        live &= np.isin(qbin, rbin[rbin >= 0])
    assert seen[live].all()


@pytest.mark.parametrize("n,d,k,q_n,p,skew", SCANS)
def test_packed_scan_work_counts(n, d, k, q_n, p, skew):
    arrays, statics, qbin, num_bins = _scan_inputs(n, d, k, q_n, p, skew)
    r_blk = statics["chunk"] * statics["r_chunks"]
    work = tpb.packed_scan_work(arrays["qbin_stack"], arrays["qb"],
                                arrays["gb"], arrays["rbin_padded"],
                                statics["q_blk"], r_blk)
    # the useful products: every live stacked row against its bin's rows
    sizes = np.bincount(arrays["rbin_padded"][arrays["rbin_padded"] >= 0],
                        minlength=num_bins + 1)
    live = qbin[(qbin >= 0) & (qbin < num_bins)]
    assert work["useful_products"] == int(sizes[live].sum())
    assert work["issued_products"] == 64 * 128 * work["live_tiles"]
    assert work["issued_products"] >= work["useful_products"] > 0
    assert 0.0 <= work["masked_share"] < 1.0
    assert work["grid"] == [arrays["qb"].shape[0], 1]
    assert 0 < work["working_blocks"] <= arrays["q_stack"].shape[0] // 64


@pytest.mark.parametrize("q_blk", [64, 128])
@pytest.mark.parametrize("n,d,k,q_n,p,skew,split", _walks(SCANS))
def test_units_walked_table(n, d, k, q_n, p, skew, q_blk, split):
    """The mirror's units in the shape the kernel reports its walk: one
    count per (work item, 64-row part), -1 where the block returns. The
    split walk does the same useful products in as many live tiles or
    fewer, over more blocks."""
    arrays, statics, _, _ = _scan_inputs(n, d, k, q_n, p, skew, q_blk=q_blk)
    r_blk = statics["chunk"] * statics["r_chunks"]
    qb = arrays["qb"]
    units = tpb.packed_scan_units(arrays["qbin_stack"], qb, arrays["gb"],
                                  arrays["rbin_padded"], q_blk, r_blk, split)
    walked = tpb.units_walked(units, qb.shape[0], q_blk)
    assert walked.shape == (qb.shape[0], q_blk // 64)
    assert int((walked >= 0).sum()) == len(units)
    work = tpb.packed_scan_work(arrays["qbin_stack"], qb, arrays["gb"],
                                arrays["rbin_padded"], q_blk, r_blk, split)
    assert int(walked[walked >= 0].sum()) == work["live_tiles"]
    assert walked.max() == work["max_tiles_per_block"]
    run = tpb.packed_scan_work(arrays["qbin_stack"], qb, arrays["gb"],
                               arrays["rbin_padded"], q_blk, r_blk)
    later = np.flatnonzero(qb[1:] == qb[:-1]) + 1  # not a run's first item
    if split:
        assert work["useful_products"] == run["useful_products"]
        assert work["live_tiles"] <= run["live_tiles"]
        assert work["working_blocks"] >= run["working_blocks"]
    else:
        assert (walked[later] == -1).all()
    # the wrapper's CPU route: the plain result and this table
    t = _tensors(arrays)
    got = tpb.cuda_packed_scan_walk(**t, **statics, split=split)
    want = tpb.packed_scan_plain(**t, **statics)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert np.array_equal(got[2].numpy(), walked)


def test_captured_scans_records_and_restores():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    layout = tb.make_layout(x, rng.integers(0, 5, size=600), 5)
    q = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    cents = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    scan = tb.packed_scan
    with tb.captured_scans() as calls:
        want = tb.binned_topk_kernel(q, cents, 2, layout, top_k=4)
    assert tb.packed_scan is scan
    (args, kw), = calls
    assert "plain" not in kw and kw["top_k"] == 4
    tpb.packed_scan_plain(*args, **kw)  # the arguments the scan takes
    again = tb.binned_topk_kernel(q, cents, 2, layout, top_k=4)
    assert all(torch.equal(a, b) for a, b in zip(want, again))


def _bitwise(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("kernel_ids", [False, True])
@pytest.mark.parametrize("q_blk", [64, 128])
@pytest.mark.parametrize("n,d,k,q_n,p,skew,split",
                         _walks(SCANS + SMALL_SCANS))
def test_packed_scan_tiled_walk_matches_plain(n, d, k, q_n, p, skew, q_blk,
                                              kernel_ids, metric, split):
    """Skipping dead tiles, 64-row parts and ids gathered at the flush
    change nothing: the kernel's walk equals the plain version. The
    split walk (each work item's rows alone) equals the run walk bit for
    bit."""
    arrays, statics, qbin, _ = _inputs(n, d, k, q_n, p, skew, q_blk=q_blk)
    if not kernel_ids:
        arrays.pop("ids_padded")
    t = _tensors(arrays)
    want = tpb.packed_scan_plain(**t, **statics, metric=metric)
    got = tpb.packed_scan_tiled_plain(**t, **statics, metric=metric,
                                      split=split)
    assert_topk_match(got[0], got[1], want[0], want[1])
    dead = torch.from_numpy(qbin < 0)
    assert torch.isinf(got[0][dead]).all() and (got[1][dead] == -1).all()
    if split:
        _bitwise(got, tpb.packed_scan_tiled_plain(**t, **statics,
                                                  metric=metric))


def test_packed_scan_tiled_walk_tie_rule(split=False):
    """Duplicated corpus rows tie exactly: the lower padded row wins, in
    the walk as in the plain version, with ids that do not follow the
    padded order."""
    arrays, statics, _, _ = _scan_inputs(997, 16, 7, 33, 2, True)
    corpus = arrays["corpus_padded"]
    rbin = arrays["rbin_padded"].reshape(-1)
    for b in range(7):  # each bin's rows become copies of its first two
        rows = np.flatnonzero(rbin == b)
        corpus[rows] = corpus[rows[np.arange(rows.size) % 2]]
    arrays["xx_padded"] = (corpus * corpus).sum(axis=1)[None, :]
    arrays["ids_padded"] = arrays["ids_padded"].max() - arrays["ids_padded"]
    t = _tensors(arrays)
    want = tpb.packed_scan_plain(**t, **statics)
    got = tpb.packed_scan_tiled_plain(**t, **statics, split=split)
    assert torch.equal(got[1], want[1])
    assert (want[0][:, 1:] == want[0][:, :-1]).any()


def test_packed_scan_tiled_walk_tie_rule_split():
    """The same ties in the split walk."""
    test_packed_scan_tiled_walk_tie_rule(split=True)


@pytest.mark.parametrize("n,d,k,q_n,p,skew", SCANS[:2])
def test_packed_scan_tiled_walk_matches_pallas_interpret(n, d, k, q_n, p, skew):
    arrays, statics, qbin, num_bins = _scan_inputs(n, d, k, q_n, p, skew)
    jd, ji = jpb.pallas_packed_scan(
        **{a: jnp.asarray(v) for a, v in arrays.items()},
        **_jax_statics(statics, q_n), interpret=True)
    td, ti = tpb.packed_scan_tiled_plain(**_tensors(arrays), **statics)
    live = (qbin >= 0) & (qbin < num_bins)
    assert_topk_match(td.numpy()[live], ti.numpy()[live],
                      np.asarray(jd)[live], np.asarray(ji)[live])


def test_packed_scan_work_on_a_search_layout():
    """The work count on the arguments a real binned search hands to the
    scan: a bin larger than a tile, skewed bins, two probes."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4000, 24)).astype(np.float32)
    bins = (rng.random(4000) ** 3 * 12).astype(np.int64)
    layout = tb.make_layout(x, bins, 12)
    q = torch.from_numpy(rng.normal(size=(300, 24)).astype(np.float32))
    cents = torch.from_numpy(rng.normal(size=(12, 24)).astype(np.float32))
    with tb.captured_scans() as calls:
        tb.binned_topk_kernel(q, cents, 2, layout, top_k=10)
    (args, kw), = calls
    r_blk = kw["chunk"] * kw["r_chunks"]
    work = tpb.packed_scan_work(args[1], args[2], args[3], args[5], kw["q_blk"],
                                r_blk)
    assert work["r_blk"] == r_blk and r_blk >= layout["max_bin"]
    assert work["useful_products"] == int(
        np.bincount(bins, minlength=12)[torch.topk(
            torch.cdist(q, cents), 2, largest=False)[1].numpy()].sum())
    assert 0.0 < work["masked_share"] < 1.0


@pytest.mark.parametrize("fault", ["none", "distance", "repeated", "swapped", "tie"])
def test_assert_topk_match_over_many_rows(fault):
    """Rows equal in place pass without the per-row look; one faulty row
    among many empty ones is still found, and a swap at a tie passes."""
    rng = np.random.default_rng(11)
    d = np.full((5000, 4), np.inf, np.float32)
    i = np.full((5000, 4), -1, np.int32)
    d[::7] = np.sort(rng.random((len(d[::7]), 4)).astype(np.float32), axis=1)
    i[::7] = np.arange(4, dtype=np.int32) + 10
    gd, gi = d.copy(), i.copy()
    if fault == "distance":
        gd[4998, 2] += 0.01
    elif fault == "repeated":
        gi[4998, 1] = gi[4998, 0]
        i[4998, 1] = i[4998, 0]
    elif fault == "swapped":
        gi[4998, [0, 1]] = gi[4998, [1, 0]]
    elif fault == "tie":
        d[4998, 1] = gd[4998, 1] = d[4998, 0]
        gi[4998, [0, 1]] = gi[4998, [1, 0]]
    if fault in ("none", "tie"):
        assert_topk_match(gd, gi, d, i)
    else:
        with pytest.raises(AssertionError, match="row 4998"):
            assert_topk_match(gd, gi, d, i)
