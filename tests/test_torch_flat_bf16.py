"""``FlatIndex(dtype="bfloat16")`` of vers_tpu_torch against vers_tpu's on
the same seeded inputs: the bf16 store (each row rounded once to nearest
even, at construction and in ``add``), the exact, approx and bucket
engines (with and without rescore; the JAX package runs its Pallas
bucket kernel in interpret mode on the CPU), ``add`` past the store's
capacity, and the save/load files, byte-identical both ways.

Distances are held to atol 1e-4 / rtol 1e-5 (f32 sums in another
order); ids tie-aware. The stored rows must equal the JAX store's bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vers_tpu
import vers_tpu_torch
from vers_tpu_torch.core import VectorStore
from vers_tpu_torch.ops.cuda_bucket import prepare_bucket_corpus
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)

ATOL, RTOL = 1e-4, 1e-5


def _data(n, d, q_n, seed, metric):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def _pair(x, **cfg):
    jidx = vers_tpu.FlatIndex(x, config=vers_tpu.FlatConfig(
        dtype="bfloat16", **cfg))
    tidx = vers_tpu_torch.FlatIndex(x, config=vers_tpu_torch.FlatConfig(
        dtype="bfloat16", **cfg), device="cpu")
    return jidx, tidx


def _match(jidx, tidx, q, k):
    want = jidx.search_batch(q, k)
    got = tidx.search_batch(q, k)
    assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                      rtol=RTOL, atol=ATOL)
    return got


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
@pytest.mark.parametrize("engine,rescore", [
    ("exact", False), ("auto", False), ("approx", False),
    ("bucket", False), ("bucket", True),
])
def test_bf16_flat_engines_match_jax(engine, rescore, metric):
    x, q = _data(1500, 24, 37, seed=1, metric=metric)
    jidx, tidx = _pair(x, engine=engine, bucket_rescore=rescore,
                       metric=metric)
    assert tidx._store.data.dtype == torch.bfloat16
    got = _match(jidx, tidx, q, 10)
    assert (got.ids >= 0).all()


def test_bf16_store_rounds_like_jax():
    """Rows rounded to nearest even on the way in, equal to the JAX
    store's bit for bit, also after appends that grow the capacity."""
    x, _ = _data(130, 9, 1, seed=2, metric="sq_euclidean")
    # exact ties of rounding: halfway between two bf16 values
    x[0, :4] = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 2**-130],
                        np.float32)
    js = vers_tpu.core.VectorStore(x, dtype=jnp.bfloat16)
    ts = VectorStore(x, dtype=torch.bfloat16, device="cpu")
    assert ts.capacity == js.capacity == 256
    extra, _ = _data(140, 9, 1, seed=3, metric="sq_euclidean")
    for row in extra:
        assert js.append(row) == ts.append(row)
    assert ts.capacity == js.capacity == 512
    assert ts.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.rows().view(np.uint32),
                                  js.rows().view(np.uint32))
    assert ts.rows()[0, 0] == 1.0 and ts.rows()[0, 1] == 1 + 4 * 2**-8
    with pytest.raises(ValueError):
        VectorStore(x, dtype=torch.float16, device="cpu")


@pytest.mark.parametrize("engine", ["exact", "bucket"])
def test_bf16_add_matches_jax(engine):
    """``add`` rounds the new row; rows added past the capacity (128)
    are found, and the search equals the JAX index's."""
    x, q = _data(120, 16, 12, seed=4, metric="sq_euclidean")
    jidx, tidx = _pair(x, engine=engine, bucket_rescore=engine == "bucket")
    new, _ = _data(20, 16, 1, seed=5, metric="sq_euclidean")
    for i, row in enumerate(new):
        jidx.add(row, 1000 + i)
        tidx.add(row, 1000 + i)
    assert tidx._store.capacity == 256
    got = _match(jidx, tidx, np.concatenate([q, new[:5]]), 5)
    assert list(got.ids[12:, 0]) == [1000, 1001, 1002, 1003, 1004]
    np.testing.assert_array_equal(tidx._store.rows(), jidx._store.rows())


def test_bf16_save_load_byte_identical_both_ways(tmp_path):
    x, q = _data(300, 12, 8, seed=6, metric="sq_euclidean")
    jidx, tidx = _pair(x)
    tidx.add(q[0], 77)
    jidx.add(q[0], 77)
    pt, pj = tmp_path / "t.index", tmp_path / "j.index"
    tidx.save_index(str(pt))
    jidx.save_index(str(pj))
    assert pt.read_bytes() == pj.read_bytes()
    cfg_t = vers_tpu_torch.FlatConfig(dtype="bfloat16")
    cfg_j = vers_tpu.FlatConfig(dtype="bfloat16")
    # the JAX file into the port and back out, and the other way round
    t2 = vers_tpu_torch.FlatIndex.load_index(str(pj), config=cfg_t,
                                             device="cpu")
    j2 = vers_tpu.FlatIndex.load_index(str(pt), config=cfg_j)
    t2.save_index(str(tmp_path / "t2.index"))
    j2.save_index(str(tmp_path / "j2.index"))
    assert (tmp_path / "t2.index").read_bytes() == pj.read_bytes()
    assert (tmp_path / "j2.index").read_bytes() == pt.read_bytes()
    _match(j2, t2, q, 4)


def test_bf16_store_is_half_the_bytes():
    x, _ = _data(256, 300, 1, seed=7, metric="sq_euclidean")
    f32 = vers_tpu_torch.FlatIndex(x, device="cpu")
    bf16 = vers_tpu_torch.FlatIndex(
        x, config=vers_tpu_torch.FlatConfig(dtype="bfloat16"), device="cpu")
    nbytes = lambda t: t.numel() * t.element_size()
    assert 2 * nbytes(bf16._store.data) == nbytes(f32._store.data)
    with pytest.raises(ValueError):
        vers_tpu_torch.FlatIndex(
            x, config=vers_tpu_torch.FlatConfig(dtype="float16"), device="cpu")


@pytest.mark.parametrize("d,copied", [(300, True), (64, False)])
def test_bucket_corpus_of_a_bf16_store(d, copied):
    """Kernel D reads rows padded to whole k16 steps: a bf16 store at
    d = 64 is its own padded corpus (no copy); at d = 300 its 600-byte
    rows are copied to 608. |x|^2 comes from the bf16 rows widened."""
    x, _ = _data(256, d, 1, seed=8, metric="sq_euclidean")
    store = torch.from_numpy(x).to(torch.bfloat16)
    prep = prepare_bucket_corpus(store)
    assert (prep.rows.data_ptr() != store.data_ptr()) == copied
    assert prep.rows.shape == (256, -(-d // 16) * 16)
    assert torch.equal(prep.rows[:, :d], store)
    xf = store.float()
    assert torch.equal(prep.sq_norms, torch.sum(xf * xf, dim=1))
