"""The port's native host IO (``vers_tpu_torch.native``: the `.vec`
parser and the one-pass HNSW file scanner, built with g++ on first use)
against the Python readers and against ``vers_tpu.native``, on files the
tests write; ``load_vec_file`` and ``HNSWIndex.load_index`` take the
native path where it is available and the Python path otherwise
(``VERS_NATIVE=0``), with the same results. Values are compared exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import vers_tpu.native as jax_native
from vers_tpu_torch import native
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.utils import data

WORDS = ["king", "queen", "naïve", "héllo", "x", "royal"]


def _vec_file(tmp_path, n=6, d=8, header=True, seed=0):
    rng = np.random.default_rng(seed)
    words = (WORDS * (n // len(WORDS) + 1))[:n]
    embs = rng.normal(size=(n, d)).astype(np.float32)
    p = str(tmp_path / "t.vec")
    data.write_vec_file(p, words, embs, header=header)
    return p, words, embs


def test_native_library_builds_here():
    """g++ is on this host: the library builds into vers_tpu_torch/_build
    and the native path is the one that runs."""
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "_build"


@pytest.mark.parametrize("header,max_rows", [(True, None), (False, 3)])
def test_parse_vec_matches_python_and_vers_tpu(tmp_path, monkeypatch, header,
                                               max_rows):
    p, words, embs = _vec_file(tmp_path, n=40, header=header)
    got = native.parse_vec(p, 8, header=header, max_rows=max_rows)
    want = jax_native.parse_vec(p, 8, header=header, max_rows=max_rows)
    py = data.parse_vec_python(p, 8, header=header, max_rows=max_rows)
    # ... and as load_vec_file runs it without the native library
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", True)
    assert not native.available()
    again = data.load_vec_file(p, 8, header=header, max_rows=max_rows)
    assert again[0] == py[0] and np.array_equal(again[1], py[1])
    n = max_rows or 40
    for other in (want, py):
        assert got[0] == other[0] == words[:n]
        np.testing.assert_array_equal(got[1], other[1])
    # the file holds 4 decimals
    np.testing.assert_allclose(got[1], embs[:n], rtol=0, atol=6e-5)


def test_parse_vec_skips_short_lines(tmp_path):
    p = str(tmp_path / "bad.vec")
    with open(p, "w") as fp:
        fp.write("3 4\n")
        fp.write("good 1 2 3 4\n")
        fp.write("short 1 2\n")
        fp.write("\n")
        fp.write("also_good 5 6 7 8\n")
    w, e = native.parse_vec(p, 4)
    assert w == ["good", "also_good"]
    np.testing.assert_array_equal(e, [[1, 2, 3, 4], [5, 6, 7, 8]])


def test_parse_vec_missing_file():
    with pytest.raises(FileNotFoundError):
        native.parse_vec("/nonexistent/nope.vec", 4)


def _small_hnsw(n=80, d=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return HNSWIndex.build_index(4, 16, 8, 4, x, device="cpu"), x


def test_hnsw_scan_matches_vers_tpu(tmp_path):
    idx, _ = _small_hnsw()
    p = str(tmp_path / "h.index")
    idx.save_index(p)
    got, want = native.hnsw_scan(p, 16), jax_native.hnsw_scan(p, 16)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_hnsw_native_load_matches_python(tmp_path):
    idx, x = _small_hnsw()
    p = str(tmp_path / "h.index")
    idx.save_index(p)
    nat = HNSWIndex.load_index(p, dim=16, device="cpu")
    py = HNSWIndex._load_index_python(p, 16, device="cpu")
    assert (nat.ef_construction, nat.ef_search, nat.num_neighbours) == (
        py.ef_construction, py.ef_search, py.num_neighbours)
    assert nat.layer_multiplier == py.layer_multiplier
    assert len(nat.layers) == len(py.layers)
    for ln, lp in zip(nat.layers, py.layers):
        assert set(ln.adjacency) == set(lp.adjacency)
        for nid, b in lp.adjacency.items():
            a = ln.adjacency[nid]
            assert a.neighbours == b.neighbours
            assert sorted(a._heap) == sorted(b._heap)
    assert nat._id_row.keys() == py._id_row.keys()
    for nid in py._id_row:
        np.testing.assert_array_equal(nat._vecs[nat._id_row[nid]],
                                      py._vecs[py._id_row[nid]])
    q = x[:5] + 0.01
    assert nat.search_approximate(q[0], 5) == py.search_approximate(q[0], 5)
    np.testing.assert_array_equal(nat.search_batch(q, 5).ids,
                                  py.search_batch(q, 5).ids)


def test_hnsw_native_truncated_file(tmp_path):
    idx, _ = _small_hnsw(n=30)
    p = str(tmp_path / "h.index")
    idx.save_index(p)
    blob = open(p, "rb").read()
    with open(p, "wb") as fp:
        fp.write(blob[: len(blob) // 2])
    with pytest.raises(EOFError):
        HNSWIndex.load_index(p, dim=16, device="cpu")


def test_vers_native_0_takes_the_python_readers(tmp_path):
    """With VERS_NATIVE=0 nothing is built or loaded and both readers
    give the same results as the native ones."""
    p, words, embs = _vec_file(tmp_path, n=12)
    idx, _ = _small_hnsw(n=40)
    h = str(tmp_path / "h.index")
    idx.save_index(h)
    code = (
        "import numpy as np; from vers_tpu_torch import native; "
        "from vers_tpu_torch.utils.data import load_vec_file; "
        "from vers_tpu_torch.index.hnsw import HNSWIndex; "
        f"w, e = load_vec_file({p!r}, 8); "
        f"i = HNSWIndex.load_index({h!r}, dim=16, device='cpu'); "
        "print(native.available(), w == %r, np.array_equal(e, np.load(%r)), "
        "i.get_num_nodes_in_layers())" % (words, str(tmp_path / "e.npy"))
    )
    np.save(tmp_path / "e.npy", native.parse_vec(p, 8)[1])
    env = dict(os.environ, VERS_NATIVE="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split()[:3] == ["False", "True", "True"], out.stdout
    assert out.stdout.strip().endswith(str(idx.get_num_nodes_in_layers()))
