#!/usr/bin/env python3
"""Kernel C (the values top-k) on one CUDA card, at the main path's shapes.

On the bucket table of the smoke run (``synthetic_gaussian`` 1M x 300
from seed 0, 16384 queries, kernel D's (16384, 8960) table of bucket
minima) it times with CUDA events, in turns (plain, kernel, library,
kernel, library, plain), for each shortlist width s (10, 32 and 128):

  * ``cuda_topk_values`` (kernel C);
  * its plain version ``topk_values_plain`` (a stable sort);
  * ``torch.topk(values, s, largest=False)``, the one library call that
    computes the same function (the yardstick; the port never calls it);

then kernel C on kernel A's second-pass shape, the (16384, 2 * 10) table
of two corpus splits' best sets (here a slice of the bucket table). One
JSON line per shape carries the card's name and power limit, the bound
(``utils/roofline.py``) and the share of it reached. First it prints
kernel C's ``ptxas`` report and the SASS counts of its loads, votes and
shared-memory accesses. ``--ablate`` then times, at s = 10 and 32:

  * the candidate buffer at other sizes (``cap``: 64 ... 1024 keys; the
    wrapper picks the power of two at or above 4 s);
  * variants built from edited copies of the source: the loads and the
    reject compare alone (``loads_only``: nothing is a candidate), 1, 4
    and 8 loads in flight per lane, 4 and 16 rows per block.

``--parent PATH`` builds an earlier version of ``csrc/topk_values.cu``
(one whose entry point takes no buffer size) and times it beside the
kernel, both launched bare (outputs allocated once, no prefill), at
every shape: the comparison of two versions inside one call.

Usage, from the repository root:

    python3 tools/time_kernel_c.py [--n N] [--queries Q] [--reps R] [--ablate]
        [--parent PATH]

Needs one CUDA card; exits 2 without one.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_timing import (  # noqa: E402
    Variant, build_variants, card_line, cuda_ms, ptxas_report, sass_counts)

OPCODES = ("LDG.128", "LDG", "VOTE", "SHFL", "LDS", "STS", "BAR", "WARPSYNC")

# variant name -> [(text in csrc/topk_values.cu, its replacement)]
ABLATIONS = {
    "loads_only": [("if (!__any_sync(FULL, least <= thr)) continue;",
                    "if (!__any_sync(FULL, least < -CUDART_INF_F)) continue;")],
    "loads1": [("constexpr int VLOADS = 2;", "constexpr int VLOADS = 1;")],
    "loads4": [("constexpr int VLOADS = 2;", "constexpr int VLOADS = 4;")],
    "loads8": [("constexpr int VLOADS = 2;", "constexpr int VLOADS = 8;")],
    "warps4": [("constexpr int VWARPS = 8;", "constexpr int VWARPS = 4;")],
    "warps16": [("constexpr int VWARPS = 8;", "constexpr int VWARPS = 16;")],
}


def bare_library(_build, source):
    """An earlier csrc/topk_values.cu, built into a library of its own;
    its entry point is today's without the buffer size."""
    import ctypes
    import subprocess

    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "lib_topk_values_parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(source.parent), "-o", str(path), str(source)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    sig = _build._SIGNATURES["vers_topk_values"]
    lib.vers_topk_values.argtypes = sig[:7] + sig[8:]
    lib.vers_topk_values.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--queries", type=int, default=16384)
    ap.add_argument("--widths", default="10,32,128")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--parent", help="an earlier csrc/topk_values.cu to time "
                    "beside the kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from vers_tpu_torch.core import round_up
    from vers_tpu_torch.ops import _build, cuda_bucket, cuda_topk
    from vers_tpu_torch.utils.data import synthetic_gaussian
    from vers_tpu_torch.utils.roofline import topk_values_bound

    card = card_line()
    print(json.dumps({
        "card": card, "ptxas": ptxas_report(_build, "topk_values"),
        "sass": sass_counts(_build.library_path(), OPCODES, "topk_values"),
    }), flush=True)

    x, q = synthetic_gaussian(args.n, args.dim, n_clusters=1024,
                              n_queries=args.queries, seed=0, normalized=True,
                              query_noise=0.5)
    dev = torch.device("cuda")
    xd = torch.zeros((round_up(args.n, 128), args.dim), device=dev)
    xd[: args.n] = torch.from_numpy(x).to(dev)
    qd = torch.from_numpy(q).to(dev)
    chunk, superchunk, _ = cuda_bucket.bucket_geometry(xd.shape[0])
    vals, ids = cuda_bucket.cuda_bucket_table(qd, xd, args.n, chunk * superchunk)
    del xd
    q_n, width = vals.shape

    def kernel(v, i, s):
        return lambda: cuda_topk.cuda_topk_values(v, i, s)

    for s in (int(v) for v in args.widths.split(",")):
        got = cuda_topk.cuda_topk_values(vals, ids, s)
        want = cuda_topk.topk_values_plain(vals, ids, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), s
        del got, want
        plain = lambda: cuda_topk.topk_values_plain(vals, ids, s)  # noqa: E731
        lib = lambda: torch.topk(vals, s, dim=1, largest=False)  # noqa: E731
        p0 = cuda_ms(torch, plain, 2)
        ms = [cuda_ms(torch, kernel(vals, ids, s), args.reps)]
        lib_ms = [cuda_ms(torch, lib, args.reps)]
        ms.append(cuda_ms(torch, kernel(vals, ids, s), args.reps))
        lib_ms.append(cuda_ms(torch, lib, args.reps))
        p1 = cuda_ms(torch, plain, 2)
        b = topk_values_bound(q_n, width, s)
        print(json.dumps({
            "card": card, "Q": q_n, "W": width, "s": s,
            "cap": cuda_topk.values_buffer_keys(s), "kernel_ms": ms,
            "torch_topk_ms": lib_ms, "plain_ms": [p0, p1],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "share_of_bound": b["bound_ms"] / min(ms),
            "bytes_per_s": b["bytes"] / (min(ms) * 1e-3)}), flush=True)

    # kernel A's second pass: two splits' best sets of k = 10
    nv, ni = vals[:, :20].contiguous(), ids[:, :20].contiguous()
    got = cuda_topk.cuda_topk_values(nv, ni, 10)
    want = cuda_topk.topk_values_plain(nv, ni, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b = topk_values_bound(q_n, 20, 10)
    print(json.dumps({
        "card": card, "Q": q_n, "W": 20, "s": 10,
        "kernel_ms": [cuda_ms(torch, kernel(nv, ni, 10), 50) for _ in range(2)],
        "torch_topk_ms": cuda_ms(
            torch, lambda: torch.topk(nv, 10, dim=1, largest=False), 50),
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}), flush=True)

    if args.parent:
        # both versions launched bare, in turns, 200 launches a reading
        old = bare_library(_build, Path(args.parent))
        new = _build.load_library()
        stream = torch.cuda.current_stream().cuda_stream
        for v, i, s in ((vals, ids, 10), (vals, ids, 32), (nv, ni, 10)):
            od = torch.empty((q_n, s), dtype=torch.float32, device=dev)
            oi = torch.empty((q_n, s), dtype=torch.int32, device=dev)
            head = (v.data_ptr(), i.data_ptr(), od.data_ptr(), oi.data_ptr(),
                    q_n, v.shape[1], s)
            cap = cuda_topk.values_buffer_keys(s)
            run_old = lambda: old.vers_topk_values(*head, stream)  # noqa: E731
            run_new = lambda: new.vers_topk_values(*head, cap, stream)  # noqa: E731
            ms = [cuda_ms(torch, f, 200)
                  for f in (run_old, run_new, run_new, run_old)]
            print(json.dumps({"card": card, "Q": q_n, "W": v.shape[1], "s": s,
                              "bare_parent_ms": [ms[0], ms[3]],
                              "bare_kernel_ms": ms[1:3]}), flush=True)

    if args.ablate:
        real_build, real_cap = cuda_topk._build, cuda_topk.values_buffer_keys
        libs = build_variants(_build, "topk_values.cu", "vers_topk_values",
                              ABLATIONS)
        for s in (10, 32):
            rows = {"full": cuda_ms(torch, kernel(vals, ids, s), args.reps)}
            try:
                for cap in (64, 128, 256, 512, 1024):
                    if cap >= s + 32:
                        cuda_topk.values_buffer_keys = lambda k, c=cap: c
                        rows[f"cap{cap}"] = cuda_ms(
                            torch, kernel(vals, ids, s), args.reps)
                cuda_topk.values_buffer_keys = real_cap
                for name, (lib, _) in libs.items():
                    cuda_topk._build = Variant(lib)
                    rows[name] = cuda_ms(torch, kernel(vals, ids, s), args.reps)
            finally:
                cuda_topk._build = real_build
                cuda_topk.values_buffer_keys = real_cap
            rows["full_again"] = cuda_ms(torch, kernel(vals, ids, s), args.reps)
            print(json.dumps({"card": card, "Q": q_n, "W": width, "s": s,
                              "ablation_ms": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
