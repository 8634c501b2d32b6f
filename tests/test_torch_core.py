"""vers_tpu_torch.core against vers_tpu.core: normalize (eps guard),
hash keys, bitwise equality, query matrices and the growable store."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vers_tpu import core as jc
from vers_tpu_torch import core as tc

torch.set_num_threads(2)


def test_normalize_matches_jax_with_eps_guard():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20, 7)).astype(np.float32)
    x[3] = 0.0
    x[5] = 1e-8  # magnitude below eps: passes through unchanged
    want = np.asarray(jc.normalize(jnp.asarray(x)))
    np.testing.assert_allclose(tc.normalize(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tc.normalize_np(x), jc.normalize_np(x))
    np.testing.assert_array_equal(tc.normalize_np(x)[5], x[5])


def test_hashkey_bitwise_equal_round_up():
    x = np.array([[0.0, -0.0, 1.5]], np.float32)
    np.testing.assert_array_equal(tc.to_hashkey(x), jc.to_hashkey(x))
    a = torch.tensor([0.0, 1.0])
    assert tc.bitwise_equal(a, a.clone())
    assert not tc.bitwise_equal(a, torch.tensor([-0.0, 1.0]))  # bits differ
    assert bool(jc.bitwise_equal(jnp.asarray([0.0, 1.0]),
                                 jnp.asarray([-0.0, 1.0]))) is False
    assert [tc.round_up(v, 128) for v in (1, 128, 129)] == [128, 128, 256]


def test_as_query_matrix():
    q = tc.as_query_matrix([1, 2, 3])
    assert q.shape == (1, 3) and q.dtype == torch.float32
    t = torch.ones((2, 3), dtype=torch.float64)
    assert tc.as_query_matrix(t).dtype == torch.float32


@pytest.mark.parametrize("n", [0, 5, 128])
def test_vector_store_append_grows_like_jax(n):
    rng = np.random.default_rng(n)
    data = rng.normal(size=(n, 4)).astype(np.float32)
    js, ts = jc.VectorStore(data), tc.VectorStore(data)
    for _ in range(130):
        row = rng.normal(size=4).astype(np.float32)
        assert js.append(row) == ts.append(row)
    assert (ts.count, ts.capacity, ts.dim) == (js.count, js.capacity, js.dim)
    np.testing.assert_array_equal(ts.rows(), js.rows())
    np.testing.assert_array_equal(ts.valid().numpy(), np.asarray(js.valid()))
    assert not ts.data[ts.count:].any()


def test_vec_file_loaders_match_jax(tmp_path):
    from vers_tpu.utils import data as jd
    from vers_tpu_torch.utils import data as td

    words, embs = td.synthetic_words_dataset(n_words=60, dim=8, seed=1)
    jw, je = jd.synthetic_words_dataset(n_words=60, dim=8, seed=1)
    assert words == jw
    np.testing.assert_array_equal(embs, je)
    path = str(tmp_path / "w.vec")
    td.write_vec_file(path, words, embs)
    got, want = td.load_wiki_vector(path, dim=8), jd.load_wiki_vector(path, dim=8)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    assert [w for w, _ in got[3]] == [w for w, _ in want[3]] == ["queen"]
    np.testing.assert_array_equal(got[3][0][1], want[3][0][1])
    x, q = td.synthetic_gaussian(300, 6, n_clusters=4, n_queries=9, seed=2,
                                 normalized=True)
    jx, jq = jd.synthetic_gaussian(300, 6, n_clusters=4, n_queries=9, seed=2,
                                   normalized=True)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(q, jq)

