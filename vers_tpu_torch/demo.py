"""CLI demo (counterpart of ``vers_tpu.demo``), the rebuild of the
reference's scratch binary (`vers/src/main.rs:54-103`): load wiki
vectors (queen held out), build an index, run the queen smoke harness,
print timing.

Usage:
  python -m vers_tpu_torch --index hnsw --path wiki-news-300d-1M.vec
  python -m vers_tpu_torch --index ivfflat            # synthetic corpus
  python -m vers_tpu_torch --index flat --device cpu  # the plain versions

The index goes to ``--device`` (default: the first CUDA card).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from vers_tpu_torch.core import resolve_device
from vers_tpu_torch.index.flat import FlatIndex
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.index.ivfflat import IVFFlatIndex
from vers_tpu_torch.index.lsh import ANNIndex
from vers_tpu_torch.utils.data import (
    load_wiki_vector,
    synthetic_words_dataset,
    write_vec_file,
)
from vers_tpu_torch.utils.harness import run_test
from vers_tpu_torch.utils.logging import index_stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", choices=["flat", "ivfflat", "lsh", "hnsw"], default="hnsw")
    p.add_argument(
        "--batched-build", action="store_true",
        help="HNSW: wave-parallel construction on the device instead of "
             "the sequential host build",
    )
    p.add_argument("--path", default=None, help=".vec file (synthetic corpus if absent)")
    p.add_argument("--dim", type=int, default=300)
    p.add_argument("--max-rows", type=int, default=None)
    # reference main.rs defaults: hnsw (12, 100, 32, 24)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--ef-construction", type=int, default=100)
    p.add_argument("--ef-search", type=int, default=32)
    p.add_argument("--num-neighbours", type=int, default=24)
    p.add_argument("--num-clusters", type=int, default=20)
    p.add_argument("--num-attempts", type=int, default=3)
    p.add_argument("--max-iterations", type=int, default=10)
    p.add_argument("--num-trees", type=int, default=8)
    p.add_argument("--max-node-size", type=int, default=100)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--device", default=None,
                   help='"cpu", "cuda", "cuda:1", ... (default: the first CUDA card)')
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    tmpdir = tempfile.gettempdir()
    if args.path:
        vectors, w2i, i2w, test_embs = load_wiki_vector(
            args.path, dim=args.dim, max_rows=args.max_rows
        )
    else:
        words, embs = synthetic_words_dataset(n_words=5000, dim=64, seed=0)
        tmp = os.path.join(tmpdir, "vers_tpu_torch_demo.vec")
        write_vec_file(tmp, words, embs)
        vectors, w2i, i2w, test_embs = load_wiki_vector(tmp, dim=64)
    print(f"{len(vectors)} {len(w2i)} {len(i2w)}")

    t0 = time.perf_counter()
    if args.index == "flat":
        index = FlatIndex.build_index(vectors, device=device)
    elif args.index == "ivfflat":
        index = IVFFlatIndex.build_index(
            args.num_clusters, args.num_attempts, args.max_iterations, vectors,
            device=device,
        )
    elif args.index == "lsh":
        index = ANNIndex.build_index(
            args.num_trees, args.max_node_size, vectors,
            np.arange(len(vectors)), device=device,
        )
    else:
        build = (
            HNSWIndex.build_index_batched
            if args.batched_build
            else HNSWIndex.build_index
        )
        index = build(
            args.num_layers,
            args.ef_construction,
            args.ef_search,
            args.num_neighbours,
            vectors,
            device=device,
        )
    print(f"build: {time.perf_counter() - t0:.2f}s on {device}")

    results = run_test(
        index,
        os.path.join(tmpdir, f"vers_tpu_torch_{args.index}.index"),
        vectors,
        dict(w2i),
        dict(i2w),
        test_embs,
        top_k=args.top_k,
    )
    for i, (word, dist) in enumerate(results):
        print(f"{i}. Word: {word}. Distance: {dist}")
    print("stats:", index_stats(index))
    print(f"Time taken to test: {time.perf_counter() - t0:.2f}s")
    return results


if __name__ == "__main__":
    main()
