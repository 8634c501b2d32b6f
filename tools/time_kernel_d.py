#!/usr/bin/env python3
"""Kernel D (the bucket-min scan) on one CUDA card, by query count.

On the smoke run's corpus (``synthetic_gaussian`` 1M x 300 from seed 0,
unit rows, held at the store's capacity of 1,000,064 rows as
``FlatIndex`` holds it) and its bucket geometry (chunk 2048, superchunk
7: a W = 8960 table), for each query count it times with CUDA events,
in turns (plain, kernel, kernel, plain):

  * ``cuda_bucket_table`` on the prepared corpus;
  * the plain version ``bucket_table_plain``;

and prints one JSON line per query count with the card's name and power
limit, the grid, the bound (``utils/roofline.py``) and the share of it
reached. First it prints kernel D's ``ptxas`` report and the SASS
opcode counts of its kernels (``cuobjdump``). ``--ablate`` then times,
at the largest query count, variants built from edited copies of the
source: a 6-slot ring (``ring6``), only the k-steps below d_pad multiplied
(``exact_k``: 19 where 20 run at d_pad 304), the update cut to one min
per accumulator (``min_only``), no wgmmas (``no_wgmma``), and neither
wgmmas nor update (``loads_only``: loads, handshakes and the table
write). Usage, from the repository root:

    python3 tools/time_kernel_d.py [--n N] [--queries 64,2048,16384]
        [--reps R] [--ablate]

Needs one CUDA card; exits 2 without one.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_timing import (  # noqa: E402
    Variant, build_variants, card_line, cuda_ms, ptxas_report, sass_counts)

OPCODES = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "WARPGROUP")

# variant name -> [(text in csrc/bucket_scan.cu, its replacement)]
UPDATE = """        const float v = fmaxf(
            fmaf(mul, acc[i], (h ? base1 : base0) + (e ? x2.y : x2.x)), lo);
        if (v < best[i]) {
          best[i] = v;
          ord.set(i, g);
        }"""
NO_WGMMA = ("          wgmma_bf16(acc, sw128_desc(a + kk * 32)",
            "          if (false) wgmma_bf16(acc, sw128_desc(a + kk * 32)")
ABLATIONS = {
    "ring6": [("constexpr int NS_MAX = 8;", "constexpr int NS_MAX = 6;")],
    "exact_k": [("for (int kk = 0; kk < KS / 16; ++kk)",
                 "for (int kk = 0; kk < min(KS, d_pad - j * KS) / 16; ++kk)")],
    "min_only": [(UPDATE, "        best[i] = fminf(best[i], acc[i]);")],
    "no_wgmma": [NO_WGMMA],
    "loads_only": [NO_WGMMA, (
        "  for (int j = 0; j < 16; ++j) {\n    const float2 x2",
        "  for (int j = 0; j < 0; ++j) {\n    const float2 x2")],
}


def hgmma_shapes(path):
    """The HGMMA shapes in a library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)],
                          capture_output=True, text=True).stdout
    return sorted(set(re.findall(r"HGMMA\.[0-9x]+\.F32\.\w+", sass)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--queries", default="64,2048,16384")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from vers_tpu_torch.core import round_up
    from vers_tpu_torch.ops import _build, cuda_bucket
    from vers_tpu_torch.utils.data import synthetic_gaussian
    from vers_tpu_torch.utils.roofline import bucket_scan_bound

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(json.dumps({"card": card, "build": dict(
        ptxas=ptxas_report(_build, "bucket"),
        hgmma_shapes=hgmma_shapes(_build.library_path()),
        sass=sass_counts(_build.library_path(), OPCODES, "bucket"))}),
        flush=True)

    q_counts = [int(v) for v in args.queries.split(",")]
    x, q = synthetic_gaussian(args.n, args.dim, n_clusters=1024,
                              n_queries=max(q_counts), seed=0, normalized=True,
                              query_noise=0.5)
    dev = torch.device("cuda")
    xd = torch.zeros((round_up(args.n, 128), args.dim), device=dev)
    xd[: args.n] = torch.from_numpy(x).to(dev)
    qd = torch.from_numpy(q).to(dev)
    chunk, superchunk, _ = cuda_bucket.bucket_geometry(xd.shape[0])
    span = chunk * superchunk
    prep = cuda_bucket.prepare_bucket_corpus(xd)

    def kernel(qs):
        return lambda: cuda_bucket.cuda_bucket_table(qs, xd, args.n, span,
                                                     prepared=prep)

    for qn in q_counts:
        qs = qd[:qn]
        reps = max(1, args.reps if qn < 16384 else args.reps // 2)
        plain = lambda: cuda_bucket.bucket_table_plain(qs, xd, args.n, span)  # noqa: E731
        p0 = cuda_ms(torch, plain, 1)
        ms = [cuda_ms(torch, kernel(qs), reps), cuda_ms(torch, kernel(qs), reps)]
        p1 = cuda_ms(torch, plain, 1)
        width = -(-xd.shape[0] // span) * 128
        b = bucket_scan_bound(qn, args.n, args.dim, width)
        print(json.dumps({
            "card": card, "Q": qn, "N": xd.shape[0], "n_valid": args.n,
            "d": args.dim, "span": span, "W": width,
            "geometry": cuda_bucket.kernel_d_geometry(
                qn, xd.shape[0], args.dim, span),
            "kernel_ms": ms, "plain_ms": [p0, p1],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "share_of_bound": b["bound_ms"] / min(ms),
            "bf16_flop_per_s": b["ops"] / (min(ms) * 1e-3)}), flush=True)

    if args.ablate:
        qs = qd[: max(q_counts)]
        libs = build_variants(_build, "bucket_scan.cu", "vers_bucket_scan",
                              ABLATIONS)
        real = cuda_bucket._build
        rows = {"full": cuda_ms(torch, kernel(qs), 2)}
        try:
            for name, (lib, _) in libs.items():
                cuda_bucket._build = Variant(lib)
                rows[name] = cuda_ms(torch, kernel(qs), 2)
        finally:
            cuda_bucket._build = real
        rows["full_again"] = cuda_ms(torch, kernel(qs), 2)
        hgmma = {name: sorted({c["HGMMA"] for c in sass_counts(
            path, ("HGMMA",), "bucket").values()})
                 for name, (_, path) in libs.items()}
        print(json.dumps({"card": card, "Q": qs.shape[0], "ablation_ms": rows,
                          "variant_hgmma_per_kernel": hgmma}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
