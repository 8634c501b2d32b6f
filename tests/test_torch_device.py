"""Where vers_tpu_torch's indexes live, and kernel D's host side.

* The default device: with no ``device`` an index goes to the first
  CUDA card (``core.resolve_device``); without a card it raises and
  names ``device="cpu"``, never falling back to the CPU; an explicit
  ``device="cpu"`` runs end to end and agrees with the JAX package.
* The bucket engine's prepared corpus (bf16 rows and |x|^2, made once
  per store state): rounded as the JAX package rounds, dropped by
  ``add``, after which a bucket search sees the new row.
* ``kernel_d_geometry``, the launch shape of kernel D.

Distances are held to atol 1e-4 (f32 sums in other orders), ids
tie-aware.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vers_tpu
import vers_tpu_torch as vt
from vers_tpu_torch.core import VectorStore, resolve_device
from vers_tpu_torch.ops import cuda_bucket
from vers_tpu_torch.utils.data import synthetic_gaussian
from vers_tpu_torch.utils.parity import assert_topk_match

torch.set_num_threads(2)


def _data(n=900, d=24, q_n=20, seed=0):
    return synthetic_gaussian(n, d, n_clusters=8, n_queries=q_n, seed=seed,
                              normalized=True, query_noise=0.5)


def _match(got, want):
    assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                      rtol=0.0, atol=1e-4)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_resolve_device_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def _save_flat(tmp_path, x):
    path = str(tmp_path / "flat.index")
    vt.FlatIndex(x, device="cpu").save_index(path)
    return path


def _save_ivf(tmp_path, x):
    path = str(tmp_path / "ivf.index")
    vt.IVFFlatIndex.build_index(4, 1, 3, x, device="cpu").save_index(path)
    return path


ENTRY_POINTS = {
    "VectorStore": lambda x, tmp: VectorStore(x),
    "FlatIndex": lambda x, tmp: vt.FlatIndex(x),
    "FlatIndex.build_index": lambda x, tmp: vt.FlatIndex.build_index(x),
    "FlatIndex.from_numpy": lambda x, tmp: vt.FlatIndex.from_numpy(
        x, np.arange(len(x))),
    "FlatIndex.load_index": lambda x, tmp: vt.FlatIndex.load_index(
        _save_flat(tmp, x)),
    "IVFFlatIndex.build_index": lambda x, tmp: vt.IVFFlatIndex.build_index(
        4, 1, 3, x),
    "IVFFlatIndex.from_numpy": lambda x, tmp: vt.IVFFlatIndex.from_numpy(
        1, x, x[:1], np.zeros(len(x), np.int64), [list(range(len(x)))]),
    "IVFFlatIndex.load_index": lambda x, tmp: vt.IVFFlatIndex.load_index(
        _save_ivf(tmp, x)),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_without_device_raise_without_a_card(no_card, tmp_path,
                                                          entry):
    x, _ = _data(n=200, d=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[entry](x, tmp_path)


def test_explicit_cpu_runs_end_to_end_and_matches_jax(no_card, tmp_path):
    x, q = _data()
    flat = vt.FlatIndex(x, device="cpu")
    assert flat.device == torch.device("cpu")
    _match(flat.search_batch(q, 10), vers_tpu.FlatIndex(x).search_batch(q, 10))

    jidx = vers_tpu.IVFFlatIndex.build_index(8, 2, 10, x)
    jidx._materialize_host()
    tidx = vt.IVFFlatIndex.from_numpy(8, jidx._values, jidx._centroids,
                                      jidx._assignments, jidx._ids,
                                      device="cpu")
    _match(tidx.search_batch(q, 10, nprobe=3), jidx.search_batch(q, 10, nprobe=3))
    path = str(tmp_path / "t.index")
    tidx.save_index(path)
    loaded = vt.IVFFlatIndex.load_index(path, device="cpu")
    assert loaded.device == torch.device("cpu")
    _match(loaded.search_batch(q, 10, nprobe=3),
           jidx.search_batch(q, 10, nprobe=3))
    built = vt.IVFFlatIndex.build_index(8, 1, 3, x, device="cpu")
    assert built.device == torch.device("cpu")


def test_a_tensor_keeps_its_own_device_when_none_is_named(no_card):
    x, _ = _data(n=200, d=8)
    assert VectorStore(torch.from_numpy(x)).device == torch.device("cpu")
    idx = vt.IVFFlatIndex.build_index(4, 1, 3, torch.from_numpy(x))
    assert idx.device == torch.device("cpu")


@pytest.mark.parametrize("d", [8, 24, 300])
def test_prepared_bucket_corpus_rounds_as_jax(d):
    x, _ = _data(n=300, d=d)
    rows, sq = cuda_bucket.prepare_bucket_corpus(torch.from_numpy(x))
    assert rows.dtype == torch.bfloat16 and rows.is_contiguous()
    assert rows.shape == (300, cuda_bucket.bucket_d_pad(d))
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(rows[:, :d].float().numpy(), want)
    assert not rows[:, d:].any()
    np.testing.assert_allclose(sq.numpy(), np.asarray(jnp.sum(jnp.asarray(x) ** 2,
                                                             axis=1)),
                               rtol=1e-6)


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_add_drops_the_prepared_bucket_corpus(metric):
    """The first add fills the 1024-row store, the second doubles it;
    each drops the prepared corpus, and the bucket search then finds the
    new row, as the JAX index does."""
    x, q = _data(n=1023, d=32, q_n=30)
    cfg = dict(metric=metric, engine="bucket")
    tidx = vt.FlatIndex(x, config=vt.FlatConfig(**cfg), device="cpu")
    jidx = vers_tpu.FlatIndex(x, config=vers_tpu.FlatConfig(**cfg))
    prep = tidx.bucket_corpus()
    assert tidx.bucket_corpus() is prep  # kept while the store is unchanged
    for new_id, v in ((5000, q[0] * np.float32(1.001)),
                      (5001, q[1] * np.float32(1.001))):
        tidx.add(v, new_id)
        jidx.add(v, new_id)
        assert tidx._bucket_corpus is None
        got = tidx.search_batch(q[:2], 10)
        assert new_id in got.ids[new_id - 5000]
        _match(got, jidx.search_batch(q[:2], 10))
        rows, sq = tidx.bucket_corpus()
        assert rows.shape[0] == tidx._store.capacity == sq.shape[0]
        n = tidx._store.count
        np.testing.assert_array_equal(
            rows[n - 1, :32].float().numpy(),
            torch.from_numpy(v).to(torch.bfloat16).float().numpy())
    assert tidx._store.capacity == 2048


def test_prepared_corpus_is_checked():
    x = torch.zeros((256, 20))
    good = cuda_bucket.prepare_bucket_corpus(x)
    cuda_bucket._check_prepared(good, x)
    bad = (good.rows[:, :20].contiguous(), good.sq_norms)
    with pytest.raises(ValueError, match="bf16"):
        cuda_bucket._check_prepared(bad, x)
    with pytest.raises(ValueError, match="f32"):
        cuda_bucket._check_prepared((good.rows, good.sq_norms[:10]), x)


# (Q, n_rows, d, span) -> (d_pad, slices, resident, ring, wide, grid)
GEOMETRY = [
    ((16384, 1_000_064, 300, 14336), (304, 5, True, 8, False, (128, 70))),
    ((1, 512, 8, 512), (16, 1, True, 8, False, (1, 1))),
    ((200, 5000, 37, 1024), (48, 1, True, 8, False, (2, 5))),
    ((130, 4096, 384, 2048), (384, 6, True, 8, False, (2, 2))),
    ((130, 4096, 400, 2048), (400, 7, True, 7, False, (2, 2))),
    ((130, 4096, 512, 2048), (512, 8, True, 6, False, (2, 2))),
    ((130, 4096, 513, 2048), (528, 9, False, 7, False, (2, 2))),
    ((65, 20_000, 1000, 2048), (1008, 16, False, 7, False, (1, 10))),
    ((300, 128 * 65537, 16, 128 * 65537), (16, 1, True, 8, True, (3, 1))),
]


@pytest.mark.parametrize("args,want", GEOMETRY)
def test_kernel_d_geometry(args, want):
    g = cuda_bucket.kernel_d_geometry(*args)
    assert (g["d_pad"], g["slices"], g["resident"], g["ring"], g["wide"],
            g["grid"]) == want
    assert g["smem_bytes"] <= cuda_bucket.H100_BLOCK_SMEM
    # the ring and, when resident, the whole query tile; a slot more
    # would not fit unless the ring is at its most
    tile = g["slices"] * 128 * 64 * 2 if g["resident"] else 0
    slot = 128 * 64 * 2 * (1 if g["resident"] else 2)
    assert g["smem_bytes"] == tile + g["ring"] * slot + 1024 + 21 * 8 + 1024
    assert (g["ring"] == cuda_bucket.RING_MAX
            or g["smem_bytes"] + slot > cuda_bucket.H100_BLOCK_SMEM)


def test_roofline_bounds_at_the_smoke_shapes():
    """The least times the card could take at the smoke's shapes, from
    the published H100 peaks (989 TFLOP/s bf16, 495 TF32, 3.35 TB/s)."""
    from vers_tpu_torch.utils import roofline

    d = roofline.bucket_scan_bound(16384, 1_000_000, 300, 8960)
    assert d["bound_by"] == "operations"
    assert d["bound_ms"] == pytest.approx(2 * 16384 * 1e6 * 300 / 989e12 * 1e3)
    assert d["bound_ms"] == pytest.approx(9.94, abs=0.01)
    a = roofline.distance_topk_bound(16384, 1_000_000, 300, 10)
    assert (a["bound_by"], round(a["bound_ms"], 1)) == ("operations", 59.6)
    for s in (10, 32):
        c = roofline.topk_values_bound(16384, 8960, s)
        assert c["bound_by"] == "bytes" and 0.175 < c["bound_ms"] < 0.178
    # every live row against a 500-row bin, 1000 bins probed once each
    b = roofline.packed_scan_bound(32768, 32896, 32768 * 500, 500_000, 300, 10)
    assert b["ops"] == 3 * 2.0 * 32768 * 500 * 300
    assert b["bytes"] == 4.0 * 32768 * 300 + 1208 * 500_000 + 8.0 * 32896 * 10
    assert b["bound_ms"] == max(b["ops"] / roofline.TF32,
                                b["bytes"] / roofline.HBM) * 1e3
