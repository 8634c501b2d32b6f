"""Index files written by vers_tpu and vers_tpu_torch are byte-identical
and each package loads the other's files."""

import numpy as np
import torch

import vers_tpu
import vers_tpu_torch

torch.set_num_threads(2)


def _ivf_state(seed=0, n=600, d=12, k=5):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, d)).astype(np.float32)
    centroids = rng.normal(size=(k, d)).astype(np.float32)
    assign = np.argmin(
        ((values[:, None, :] - centroids[None]) ** 2).sum(-1), axis=1
    )
    ids = [list(np.nonzero(assign == c)[0]) for c in range(k)]
    return k, values, centroids, assign, ids


def test_ivfflat_files_byte_identical_and_cross_load(tmp_path):
    state = _ivf_state()
    j = vers_tpu.IVFFlatIndex(*state)
    t = vers_tpu_torch.IVFFlatIndex.from_numpy(*state, device="cpu")
    pj, pt = tmp_path / "j.index", tmp_path / "t.index"
    j.save_index(str(pj))
    t.save_index(str(pt))
    assert pj.read_bytes() == pt.read_bytes()

    tj = vers_tpu_torch.IVFFlatIndex.load_index(str(pj),  # dim inferred
                                                device="cpu")
    jt = vers_tpu.IVFFlatIndex.load_index(str(pt), dim=12)
    for a, b in ((tj, j), (jt, t)):
        np.testing.assert_array_equal(a._values, b._values)
        np.testing.assert_array_equal(a._centroids, b._centroids)
        np.testing.assert_array_equal(a._assignments, b._assignments)
        assert a._ids == b._ids
    # and both search the loaded files alike
    q = state[1][:4]
    np.testing.assert_array_equal(tj.search_batch(q, 5, nprobe=5).ids,
                                  jt.search_batch(q, 5, nprobe=5).ids)


def test_ivfflat_file_after_add_byte_identical(tmp_path):
    state = _ivf_state(seed=1)
    j = vers_tpu.IVFFlatIndex(*state)
    t = vers_tpu_torch.IVFFlatIndex.from_numpy(*state, device="cpu")
    v = np.full(12, 0.25, np.float32)
    j.add(v, 7)
    t.add(v, 7)
    j.save_index(str(tmp_path / "j"))
    t.save_index(str(tmp_path / "t"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()


def test_flat_files_byte_identical_and_cross_load(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 9)).astype(np.float32)
    ids = np.arange(300) * 5 + 1
    j = vers_tpu.FlatIndex(x, ids=ids)
    t = vers_tpu_torch.FlatIndex.from_numpy(x, ids, device="cpu")
    j.add(x[0] * 2, 10_000)
    t.add(x[0] * 2, 10_000)
    j.save_index(str(tmp_path / "j"))
    t.save_index(str(tmp_path / "t"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    tj = vers_tpu_torch.FlatIndex.load_index(str(tmp_path / "j"), device="cpu")
    jt = vers_tpu.FlatIndex.load_index(str(tmp_path / "t"))
    np.testing.assert_array_equal(tj.search_batch(x[:3], 4).ids,
                                  jt.search_batch(x[:3], 4).ids)
