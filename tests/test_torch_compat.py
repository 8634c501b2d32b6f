"""The README's Python API on the port (``vers_tpu_torch.compat``): the
cases of ``tests/test_compat.py``, each index built with
``device="cpu"``, and the README flow held to ``vers_tpu``'s on the same
corpus (the same neighbour words for "king")."""

import numpy as np
import pytest
import torch

import vers_tpu
import vers_tpu_torch
from vers_tpu_torch.utils.data import ROYAL_WORDS

torch.set_num_threads(2)


def test_readme_flow_hnsw():
    embeddings = vers_tpu_torch.load_wiki()  # synthetic fallback corpus
    hnsw = vers_tpu_torch.HNSW(
        ef_construction=40, num_layers=4, ef_search=16, num_neighbours=8,
        batched_build=False, device="cpu",
    )
    # keep it quick: subset with the royal words in front
    sub = vers_tpu_torch.Embeddings(
        embeddings.words[:400], embeddings.vectors[:400]
    )
    hnsw.build_index(sub)
    assert hnsw.index.device == torch.device("cpu")
    results = hnsw.search(sub.get("king"), top_k=10)
    assert len(results) == 10
    words = [w for w, _ in results]
    assert "king" in words
    # royal cluster should dominate the neighbours of "king"
    assert len([w for w in words if w in set(ROYAL_WORDS)]) >= 5
    dists = [d for _, d in results]
    assert dists == sorted(dists)
    # the same corpus and graph parameters in the JAX package
    jemb = vers_tpu.load_wiki()
    assert jemb.words == embeddings.words
    np.testing.assert_array_equal(jemb.vectors, embeddings.vectors)
    jh = vers_tpu.HNSW(ef_construction=40, num_layers=4, ef_search=16,
                       num_neighbours=8, batched_build=False)
    jh.build_index(vers_tpu.Embeddings(jemb.words[:400], jemb.vectors[:400]))
    want = jh.search(jemb.get("king"), top_k=10)
    assert set(words) == {w for w, _ in want}


def test_readme_flow_ivfflat_ndarray():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 16)).astype(np.float32)
    ivf = vers_tpu_torch.IVFFlat(num_clusters=8, num_attempts=1,
                                 max_iterations=5, device="cpu")
    ivf.build_index(x)
    results = ivf.search(x[7], top_k=3)
    assert results[0][0] == 7  # self first; int ids for ndarray input
    assert isinstance(results[0][0], int)
    r = ivf.search_batch(x[:4], 3)
    assert r.ids.shape == (4, 3)


def test_readme_flow_lsh():
    embeddings = vers_tpu_torch.load_wiki()
    sub = vers_tpu_torch.Embeddings(embeddings.words[:300],
                                    embeddings.vectors[:300])
    lsh = vers_tpu_torch.LSH(num_trees=4, max_node_size=32, device="cpu")
    lsh.build_index(sub)
    results = lsh.search(sub.get("queen"), top_k=5)
    assert len(results) == 5
    assert results[0][0] == "queen"


def test_embeddings_mapping():
    e = vers_tpu_torch.Embeddings(["a", "b"], np.eye(2, dtype=np.float32))
    assert "a" in e and "c" not in e
    assert len(e) == 2
    np.testing.assert_array_equal(e.get("b"), [0.0, 1.0])
    assert e.word_of(0) == "a"


def test_search_before_build_raises():
    with pytest.raises(RuntimeError):
        vers_tpu_torch.IVFFlat(device="cpu").search(np.zeros(4, np.float32))


def test_vers_py_module_functions(tmp_path):
    """Parity with the vers_py module functions
    (`vers-py/src/lib.rs:125-186`): load_wiki_vector 4-tuple,
    test_wiki_ivfflat harness, get_sum toy add."""
    from vers_tpu_torch.compat import get_sum, load_wiki_vector
    from vers_tpu_torch.compat import test_wiki_ivfflat as wiki_ivfflat
    from vers_tpu_torch.utils.data import synthetic_words_dataset, write_vec_file

    words, embs = synthetic_words_dataset(n_words=300, dim=32, seed=0)
    path = str(tmp_path / "mini.vec")
    write_vec_file(path, words, embs)

    vectors, w2i, i2w, test_embs = load_wiki_vector(path, dim=32)
    assert "queen" not in w2i and len(test_embs) == 1
    assert abs(float(np.linalg.norm(vectors[0])) - 1.0) < 1e-5

    out = wiki_ivfflat(vectors, w2i, i2w, 8, 1, 5, test_embs, device="cpu")
    assert any(w in set(ROYAL_WORDS) for w, _ in out[:3])

    s = get_sum(np.ones(300, np.float32), np.full(300, 2.0, np.float32))
    assert s.shape == (300,) and float(s[0]) == 3.0


def test_exports_match_vers_tpu():
    """The same 19 names as vers_tpu, plus the six lazy multi-device
    classes."""
    assert sorted(vers_tpu_torch.__all__) == sorted(vers_tpu.__all__)
    assert len(vers_tpu_torch.__all__) == 19
    for name in vers_tpu_torch.__all__:
        assert getattr(vers_tpu_torch, name) is not None
    assert vers_tpu_torch.__version__ == vers_tpu.__version__
    for name in ("ShardedFlatIndex", "ShardedIVFFlatIndex", "ShardedHNSWIndex",
                 "PartitionedHNSWIndex", "ShardedANNIndex",
                 "PartitionedANNIndex"):
        assert getattr(vers_tpu_torch, name).__name__ == name
    with pytest.raises(AttributeError):
        vers_tpu_torch.NoSuchIndex
