"""The RP-forest's ops in vers_tpu_torch against vers_tpu's on the same
inputs: ``core.deduplicate``, ``ops/rpforest`` (the level-synchronous
build and the descents) and ``ops/forest_shared`` (the host tables, the
deficit gate).

Inputs come from numpy seeds; every port call runs on the CPU. Integer
tables must be equal; hyperplanes agree to 1e-6 (f32 sums in another
order). A descent's leaf depends on the sign of a projection, so leaves
are compared exactly wherever every |projection| on the path exceeds
MARGIN, and the rest are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu import core as jcore
from vers_tpu.index.lsh import ANNIndex as JaxANNIndex
from vers_tpu.ops import forest_shared as jfs
from vers_tpu.ops import rpforest as jrp
from vers_tpu_torch import core as tcore
from vers_tpu_torch.index.lsh import ANNIndex
from vers_tpu_torch.ops import binned, forest_shared as tfs
from vers_tpu_torch.ops import rpforest as trp

torch.set_num_threads(2)

N, D, MAX_SIZE = 2000, 32, 24
MARGIN = 1e-4  # |projection| below this may fall on either side


def _data(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d)).astype(np.float32)
    x = centers[rng.integers(0, 16, n)] + 0.4 * rng.normal(size=(n, d))
    return x.astype(np.float32)


def _pad(x):
    n_pad = tcore.round_up(len(x), 128)
    return np.pad(x, ((0, n_pad - len(x)), (0, 0)))


def _jax_tree(x, seed, max_size=MAX_SIZE):
    """The reference's tree over ``x`` and the per-level permutations
    it drew."""
    xp = _pad(x)
    depth = jrp.depth_bound(len(x), max_size)
    key = jax.random.PRNGKey(seed)
    tables = jrp.build_tree(key, jnp.asarray(xp), len(x), max_size, depth)
    perms = np.stack([
        np.asarray(jax.random.permutation(k, xp.shape[0]))
        for k in jax.random.split(key, depth)
    ])
    return tables, perms, depth


def test_deduplicate_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    x[50:60] = x[5]
    x[200] = x[199]
    x[7, 0] = 0.0
    x[8] = x[7]
    x[8, 0] = -0.0  # equal as floats, different bits: both stay
    ids = np.arange(300) * 3
    want_v, want_i = jcore.deduplicate(x, ids)
    got_v, got_i = tcore.deduplicate(x, ids)
    assert got_v.shape[0] == 300 - 11
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("n,max_size", [(1, 100), (100, 100), (101, 100),
                                        (800, 40), (1_000_000, 100), (5, 2)])
def test_depth_bound_matches_jax(n, max_size):
    assert trp.depth_bound(n, max_size) == jrp.depth_bound(n, max_size)


@pytest.mark.parametrize("r_blk", [64, 128, 1024])
def test_pack_bins_and_shared_tables_match_jax(r_blk):
    rng = np.random.default_rng(2)
    sizes = rng.integers(0, 60, size=200)
    np.testing.assert_array_equal(tfs.pack_bins(sizes, r_blk),
                                  jfs.pack_bins(sizes, r_blk))
    lovs, kts = [], []
    for t in range(3):
        k = 40 + 7 * t
        lov = rng.integers(0, k, size=1500)
        lov[lov == 3] = 4  # an empty leaf
        lovs.append(lov.astype(np.int32))
        kts.append(k)
    want = jfs.shared_tree_tables(lovs, kts, r_blk)
    got = tfs.shared_tree_tables(lovs, kts, r_blk)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_build_tree_with_the_reference_draws_matches_jax(seed):
    x = _data(seed)
    want, perms, depth = _jax_tree(x, seed)
    got = trp.build_tree(None, torch.from_numpy(_pad(x)), len(x), MAX_SIZE,
                         depth, perms=torch.from_numpy(perms))
    assert int(got.num_buckets) == int(want.num_buckets)
    for name in ("split", "bucket", "leaf_of_vec"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.coeff.numpy(), np.asarray(want.coeff),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.const.numpy(), np.asarray(want.const),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,max_size,depth", [(N, MAX_SIZE, None), (900, 16, None),
                                              (600, 8, 3)])
def test_build_tree_with_its_own_generator(n, max_size, depth):
    """Every row lands in one leaf, leaves stay under max_size unless
    frozen at the bottom level, and a corpus row descends to its leaf."""
    x = _data(5, n=n)
    xp = torch.from_numpy(_pad(x))
    depth = depth or trp.depth_bound(n, max_size)
    gen = torch.Generator().manual_seed(11)
    tb = trp.build_tree(gen, xp, n, max_size, depth)
    again = trp.build_tree(torch.Generator().manual_seed(11), xp, n, max_size,
                           depth)
    for a, b in zip(tb, again):  # one seed, one tree
        assert torch.equal(a, b)
    lov = tb.leaf_of_vec.numpy()
    k = int(tb.num_buckets)
    assert (lov[:n] >= 0).all() and (lov[:n] < k).all() and (lov[n:] == -1).all()
    sizes = np.bincount(lov[:n], minlength=k)
    assert sizes.sum() == n and (sizes > 0).all()
    bottom = tb.bucket[-1].numpy()
    frozen = set(bottom[bottom >= 0].tolist())
    over = set(np.flatnonzero(sizes >= max_size).tolist())
    assert over <= frozen
    if depth == 3:
        assert over  # the cut depth really froze oversized nodes
    assert tb.coeff.shape[0] == depth + 1 and (tb.split[-1] == -1).all()
    got = trp.descend(xp[:n], tb.coeff, tb.const, tb.split, tb.bucket).numpy()
    np.testing.assert_array_equal(got, lov[:n])


def _reference_forest(n_trees=3, seed=0, n=N, max_size=MAX_SIZE):
    x = _data(seed, n=n)
    jidx = JaxANNIndex.build_index(n_trees, max_size, x, np.arange(len(x)))
    tidx = ANNIndex.from_numpy(max_size, jidx._trees, jidx._values, jidx._ids,
                               device="cpu")
    rng = np.random.default_rng(seed + 100)
    q = (x[rng.integers(0, len(x), 300)]
         + 0.3 * rng.normal(size=(300, D))).astype(np.float32)
    return x, q, jidx, tidx


@pytest.fixture(scope="module")
def forest():
    return _reference_forest()


def test_descend_matches_jax(forest):
    _, q, jidx, _ = forest
    tree = jidx._trees[0]
    want = np.asarray(jrp.descend(jnp.asarray(q), tree.coeff, tree.const,
                                  tree.split, tree.bucket))
    got = trp.descend(torch.from_numpy(q), *(torch.from_numpy(a) for a in (
        tree.coeff, tree.const, tree.split, tree.bucket))).numpy()
    assert got.dtype == np.int32
    assert (got != want).sum() <= 1  # a sign at |projection| ~ 0
    assert (got >= 0).all()


@pytest.fixture(scope="module")
def shallow_forest():
    """Leaves one or two levels down: most margins are +inf, so late
    flip ranks change nothing and the probe repeats a leaf."""
    return _reference_forest(n=250, max_size=100)


@pytest.mark.parametrize("which,n_probes", [
    ("forest", 1), ("forest", 2), ("forest", 4), ("shallow_forest", 4)])
def test_descend_forest_flat_matches_jax(request, which, n_probes):
    """The batched descent (all trees, then all flipped probes) equals
    the reference's tree-by-tree loop."""
    _, q, jidx, tidx = request.getfixturevalue(which)
    tables = tidx._flat_descent_tables()
    for a, b in zip(tables, jidx._flat_descent_tables()):
        np.testing.assert_array_equal(a, b)
    n_trees = len(jidx._trees)
    offsets = np.concatenate(
        [[0], np.cumsum([t.num_buckets for t in jidx._trees])[:-1]]
    ).astype(np.int32)
    want = np.asarray(jrp.descend_forest_flat(
        jnp.asarray(q), *(jnp.asarray(a) for a in tables),
        jnp.asarray(offsets), n_probes=n_probes))
    tq = torch.from_numpy(q)
    tt = [torch.from_numpy(a) for a in tables]
    got = trp.descend_forest_flat(tq, *tt, torch.from_numpy(offsets),
                                  n_probes=n_probes).numpy()
    assert got.shape == want.shape == (len(q), n_trees * n_probes)
    _, margins = trp._descend_once_flat(
        tq, *tt, torch.arange(n_trees), None, want_margins=True)
    m = np.sort(margins.numpy(), axis=2)  # (T, Q, L), +inf last
    with np.errstate(invalid="ignore"):
        gaps = np.where(np.isfinite(m[:, :, 1:]), m[:, :, 1:] - m[:, :, :-1],
                        np.inf)
    # a (tree, query) is unsure if a projection is near zero or two
    # margins are near each other (the flip order could swap)
    unsure = ((m[:, :, 0] < MARGIN) | (gaps.min(axis=2) < MARGIN)).T  # (Q, T)
    differs = (got != want).reshape(len(q), n_trees, n_probes).any(axis=2)
    assert not (differs & ~unsure).any()
    assert differs.sum() <= 3, int(differs.sum())
    if which == "shallow_forest":  # a probe really repeats a leaf
        cells = got.reshape(len(q), n_trees, n_probes)
        assert (cells[:, :, 1:] == cells[:, :, :-1]).any()


def test_descend_forest_flat_more_probes_than_levels_raises():
    x = _data(0, n=20)
    tidx = ANNIndex.build_index(1, 100, x, np.arange(20), device="cpu")
    tables = [torch.from_numpy(a) for a in tidx._flat_descent_tables()]
    assert tables[3].shape[1] == 2
    with pytest.raises(IndexError):
        trp.descend_forest_flat(torch.from_numpy(x), *tables,
                                torch.zeros(1, dtype=torch.int32), n_probes=4)


@pytest.mark.parametrize("n_probes,deficit_k", [(2, 10), (4, 10), (8, 3)])
def test_deficit_gate_matches_jax(n_probes, deficit_k):
    rng = np.random.default_rng(4)
    num_bins = 50
    sizes = rng.integers(0, 12, size=num_bins).astype(np.int32)
    probes = rng.integers(0, num_bins, size=(70, 3 * n_probes))
    want = np.asarray(jfs._deficit_gate(
        jnp.asarray(probes), jnp.asarray(sizes), num_bins, n_probes, deficit_k))
    got = tfs._deficit_gate(torch.from_numpy(probes), torch.from_numpy(sizes),
                            num_bins, n_probes, deficit_k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == num_bins).any() and (got[:, ::n_probes] != num_bins).all()


def test_captured_scans_copies_the_chosen_trees(forest):
    """The forest scans every tree out of one view buffer; ``only``
    keeps copies of the chosen calls' arguments."""
    _, q, _, tidx = forest
    with binned.captured_scans() as every:
        tidx.search_batch(q, 5, probes_per_tree=2)
    with binned.captured_scans(only=(0, 2)) as chosen:
        tidx.search_batch(q, 5, probes_per_tree=2)
    assert len(every) == 3 and len(chosen) == 2
    # uncopied, the three calls share the view the last tree left
    assert every[0][0][4].data_ptr() == every[2][0][4].data_ptr()
    assert chosen[0][0][4].data_ptr() != chosen[1][0][4].data_ptr()
    assert torch.equal(chosen[1][0][4], every[2][0][4])
    assert not torch.equal(chosen[0][0][4], chosen[1][0][4])
    sh = tidx._shared
    rows = sh["src"][0].long()
    want = torch.where((rows >= 0)[:, None],
                       sh["corpus_pad"][rows.clamp_min(0)], 0.0)
    assert torch.equal(chosen[0][0][4], want)  # padding slots are zero rows
    assert torch.equal(chosen[0][1]["ids_padded"].reshape(-1), sh["src"][0])
