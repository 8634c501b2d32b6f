"""The port's demo (``vers_tpu_torch.demo``, ``python -m
vers_tpu_torch``) on the CPU at a small size: every index kind runs the
queen smoke harness on a 600-word synthetic `.vec` file and finds royal
words; the flat index's neighbours equal ``vers_tpu``'s harness on the
same file (distances within 1e-4: f32 sums in another order)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vers_tpu.index.flat import FlatIndex as JaxFlatIndex
from vers_tpu.utils.data import load_wiki_vector as jax_load_wiki_vector
from vers_tpu.utils.harness import run_test as jax_run_test
from vers_tpu_torch import demo
from vers_tpu_torch.utils.data import (
    ROYAL_WORDS,
    synthetic_words_dataset,
    write_vec_file,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--num-layers", "4", "--num-neighbours", "8",
         "--ef-construction", "40", "--num-clusters", "8",
         "--num-attempts", "1", "--num-trees", "4", "--max-node-size", "32"]


@pytest.fixture(scope="module")
def vec_file(tmp_path_factory):
    words, embs = synthetic_words_dataset(n_words=600, dim=32, seed=0)
    path = str(tmp_path_factory.mktemp("demo") / "small.vec")
    write_vec_file(path, words, embs)
    return path


@pytest.mark.parametrize("index", ["flat", "ivfflat", "lsh", "hnsw"])
def test_demo_on_the_cpu(vec_file, index, capsys):
    results = demo.main(["--index", index, "--path", vec_file, "--dim", "32",
                         "--device", "cpu", *SMALL])
    out = capsys.readouterr().out
    assert "build:" in out and "on cpu" in out and "stats:" in out
    words = [w for w, _ in results]
    assert len(words) == 10 and words[0] == "queen"
    assert len(set(words) & set(ROYAL_WORDS)) >= 5


def test_demo_flat_equals_vers_tpu(vec_file, tmp_path):
    got = demo.main(["--index", "flat", "--path", vec_file, "--dim", "32",
                     "--device", "cpu"])
    vectors, w2i, i2w, test_embs = jax_load_wiki_vector(vec_file, dim=32)
    want = jax_run_test(JaxFlatIndex.build_index(vectors),
                        str(tmp_path / "flat.index"), vectors, dict(w2i),
                        dict(i2w), test_embs)
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=0, atol=1e-4)


def test_python_dash_m_on_the_cpu(vec_file):
    """``python -m vers_tpu_torch --device cpu`` (the HNSW default, wave
    build) in a process of its own."""
    out = subprocess.run(
        [sys.executable, "-m", "vers_tpu_torch", "--device", "cpu",
         "--batched-build", "--path", vec_file, "--dim", "32", *SMALL],
        capture_output=True, text=True, cwd=ROOT, check=True, timeout=600,
    ).stdout
    assert "0. Word: queen." in out
    assert "'type': 'HNSWIndex'" in out
