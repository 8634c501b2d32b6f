#!/usr/bin/env python3
"""Kernel A (exact distance top-k) on one CUDA card, by query count.

On the smoke run's corpus (``synthetic_gaussian`` 1M x 300 from seed 0,
unit rows) and k = 10, for each query count it times with CUDA events,
in turns (plain, kernel, kernel, plain):

  * ``cuda_distance_topk`` as the flat index calls it (corpus split by
    ``split_geometry``, then kernel C over the splits' best sets);
  * the same kernel with the corpus unsplit (one split), to show what
    the split buys;
  * the plain version ``fused_scan_topk``;

and prints one JSON line per query count with the card's name and power
limit. ``--corpus bf16``, ``--precision`` and ``--metric`` pick another
route (the corpus rounded to bf16, the queries too, as HNSW's scans pass
them); ``--splits`` also times the split pass alone at each listed split
count (whole tiles a split: the count run, which may fall under the
one asked, is printed), and kernel C over its best sets. Usage, from the repository root:

    python3 tools/time_kernel_a.py [--n N] [--queries 1,64,2048,16384]
        [--reps R] [--top-k K] [--corpus f32|bf16]
        [--precision highest|high|default] [--metric sq_euclidean|cosine]
        [--splits 1,8,81]

The scan-routed HNSW build's layer-1 scan at 1M rows, for example:
``--n 41547 --queries 256 --top-k 100 --corpus bf16 --precision default
--metric cosine --splits 1,4,16,81``.

Needs one CUDA card; exits 2 without one.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_timing import card_line, cuda_ms  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--queries", default="1,64,2048,16384")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--corpus", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--metric", default="sq_euclidean")
    ap.add_argument("--splits", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from vers_tpu_torch.ops import cuda_topk
    from vers_tpu_torch.ops.topk import fused_scan_topk
    from vers_tpu_torch.utils.data import synthetic_gaussian

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    q_counts = [int(v) for v in args.queries.split(",")]
    x, q = synthetic_gaussian(args.n, args.dim, n_clusters=1024,
                              n_queries=max(q_counts), seed=0, normalized=True,
                              query_noise=0.5)
    dev = torch.device("cuda")
    xd, qd = torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)
    if args.corpus == "bf16":
        xd, qd = xd.to(torch.bfloat16), qd.to(torch.bfloat16).float()
    k = args.top_k
    kw = dict(metric=args.metric, precision=args.precision)
    splits = [int(v) for v in args.splits.split(",") if v]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for qn in q_counts:
        qs = qd[:qn]
        reps = max(1, args.reps if qn < 2048 else args.reps // 2)
        split = lambda: cuda_topk.cuda_distance_topk(qs, xd, args.n, k, **kw)  # noqa: E731
        whole = lambda: cuda_topk.split_pass(  # noqa: E731
            qs, xd, args.n, k, n_split=1,
            split_rows=-(-args.n // cuda_topk.TILE_ROWS) * cuda_topk.TILE_ROWS,
            **kw)
        plain = lambda: fused_scan_topk(qs, xd, args.n, k, **kw)  # noqa: E731
        p0 = cuda_ms(torch, plain, 1)
        ms = cuda_ms(torch, split, reps)
        ms_whole = cuda_ms(torch, whole, reps if qn < 2048 else 1)
        ms2 = cuda_ms(torch, split, reps)
        p1 = cuda_ms(torch, plain, 1)
        n_split, split_rows = cuda_topk.split_geometry(qn, args.n, sms)
        by_split = {}
        for s in splits:  # the split pass alone, then kernel C over it; whole
            # tiles a split, so the count run may be under the one asked
            rows = -(-args.n // s // cuda_topk.TILE_ROWS) * cuda_topk.TILE_ROWS
            one = lambda: cuda_topk.split_pass(qs, xd, args.n, k, n_split=s,  # noqa: E731
                                               split_rows=rows, **kw)
            vals, ids, _ = one()
            by_split[s] = dict(n_split=-(-args.n // rows), split_rows=rows,
                               split_pass_ms=cuda_ms(torch, one, reps),
                               second_pass_ms=cuda_ms(torch, lambda: (
                                   cuda_topk.cuda_topk_values(vals, ids, k)),
                                   reps) if s > 1 else 0.0)
        flop = 2.0 * qn * args.n * args.dim
        print(json.dumps({
            "card": card, "Q": qn, "N": args.n, "d": args.dim, "k": k,
            "corpus": args.corpus, **kw,
            "n_split": n_split, "split_rows": split_rows,
            "kernel_ms": [ms, ms2], "unsplit_ms": ms_whole, "plain_ms": [p0, p1],
            "by_split": by_split,
            "flop_per_s": flop / (min(ms, ms2) * 1e-3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
