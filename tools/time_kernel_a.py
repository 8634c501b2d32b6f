#!/usr/bin/env python3
"""Kernel A (exact distance top-k) on one CUDA card, by route and query
count.

On the smoke run's corpus (``synthetic_gaussian`` 1M x 300 from seed 0,
unit rows) and k = 10, for each route and query count it prints the
route's plan (``cuda_topk.kernel_plan``: query tile, slots, resident
parts, shared bytes, blocks an SM by the plan and by the card's
occupancy query, splits) and times with CUDA events, in turns (plain,
kernel, kernel, plain):

  * ``cuda_distance_topk`` as the flat index calls it (corpus split by
    the plan, then kernel C over the splits' best sets);
  * the same kernel with the corpus unsplit (one split), to show what
    the split buys;
  * the plain version ``fused_scan_topk``;

one JSON line per route and query count, with the card's name and power
limit. ``--routes`` lists routes ("bf16/default,f32/high", or "bf16" for
the five bf16 routes; a bf16 corpus is the f32 one rounded, and the
queries too, as HNSW's scans pass them); ``--metric`` picks the metric.
``--splits`` also times the split pass alone at each listed split count
(whole tiles a split: the count run, which may fall under the one asked,
is printed) and kernel C over its best sets. ``--plans`` times the
split pass at every plan the shared memory allows (query tile 64 or 128,
resident parts or not, 2 to SLOTS_MAX slots) with the plan's split.
``--ablate`` times, at the largest query count, variants of the bf16
routes built from edited copies of ``csrc/distance_bf16.cu`` (no corpus
staging, no MMAs, no |x|^2, no merge, ...), with their ptxas reports. Usage, from
the repository root:

    python3 tools/time_kernel_a.py [--n N] [--queries 1,64,2048,16384]
        [--reps R] [--top-k K] [--routes f32/highest,bf16]
        [--metric sq_euclidean|cosine] [--splits 1,8,81] [--plans]
        [--ablate]

The scan-routed HNSW build's layer-1 scan at 1M rows, for example:
``--n 41368 --queries 256 --top-k 100 --routes bf16/default --metric
cosine --splits 1,4,8,16,25,33,48,82``.

Needs one CUDA card; exits 2 without one.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_timing import (  # noqa: E402
    Variant, build_variants, card_line, cuda_ms, ptxas_lines)

BF16_ROUTES = ("bf16/highest", "bf16/high", "bf16/default", "f32/high",
               "f32/default")

# variant name -> [(text in csrc/distance_bf16.cu, its replacement)]
NO_MERGE = ("      merge_tile(pw, lane, mask, dist, bd, bi, kth, k, QTT, nq,",
            "      if (false) merge_tile(pw, lane, mask, dist, bd, bi, kth, k, QTT, nq,")
ABLATIONS = {
    "no_copies": [  # the slot lands as it was (no TMA, no cp.async)
        ("          mbar_expect(&full[slot], R::SLOT);\n"
         "          tma_2d(dst, &map0, k0, (int)g0, &full[slot]);",
         "          mbar_arrive(&full[slot]);"),
        ("          mbar_expect(&full[slot], PART / 2 + 64 * 144);\n"
         "          tma_2d(dst, &map0, k0, (int)(g0 / 2), &full[slot]);\n"
         "          tma_2d(dst + PART / 2, &map1, d + k0 - 4, (int)(g0 / 2),\n"
         "                 &full[slot]);",
         "          mbar_arrive(&full[slot]);"),
        ("                                      int k0, int p, int gran) {\n#pragma unroll\n  for (int i = 0; i < UNITS_B; ++i) {\n    const int u = i * PRODUCERS + p, r = u / 8;\n    const int c = k0 + ((u % 8) ^ (r % 8)) * 8;  // the unit's first feature",
         "                                      int k0, int p, int gran) {\n  return;\n#pragma unroll\n  for (int i = 0; i < UNITS_B; ++i) {\n    const int u = i * PRODUCERS + p, r = u / 8;\n    const int c = k0 + ((u % 8) ^ (r % 8)) * 8;  // the unit's first feature")],
    "no_mma": [("              wgmma_ss(acc, sw128_desc(aa + (uint32_t)(pa * a_part)), dh,",
                "              if (false) wgmma_ss(acc, sw128_desc(aa + (uint32_t)(pa * a_part)), dh,")],
    "no_squares": [("    const bool squares = !cosine;", "    const bool squares = false;")],
    "no_merge": [NO_MERGE],
    "no_filter": [("        if (row && lr < nx && v < kr) {", "        if (false) {")],
    "no_setmaxnreg": [
        ("    if constexpr (R::XB16 && QTT == 128)\n      asm volatile(\"setmaxnreg.dec",
         "    if constexpr (false)\n      asm volatile(\"setmaxnreg.dec"),
        ("    if constexpr (R::XB16 && QTT == 128)\n      asm volatile(\"setmaxnreg.inc",
         "    if constexpr (false)\n      asm volatile(\"setmaxnreg.inc")],
    "setmaxnreg_104": [
        ("setmaxnreg.dec.sync.aligned.u32 120;", "setmaxnreg.dec.sync.aligned.u32 104;"),
        ("setmaxnreg.inc.sync.aligned.u32 192;", "setmaxnreg.inc.sync.aligned.u32 200;")],
}
ABLATIONS["skeleton"] = (ABLATIONS["no_copies"] + ABLATIONS["no_squares"]
                         + ABLATIONS["no_filter"])
ABLATIONS["skeleton_no_mma"] = ABLATIONS["skeleton"] + ABLATIONS["no_mma"]


def routes_of(arg):
    out = []
    for r in arg.split(","):
        out += list(BF16_ROUTES) if r == "bf16" else [r]
    return out


def all_plans(cuda_topk, plan, d, k):
    """Every (query tile, resident, slots) the shared memory allows for
    plan's route, with plan's split."""
    out = []
    for qt, res in ((128, True), (64, True), (64, False)):
        for slots in range(2, cuda_topk.SLOTS_MAX + 1):
            smem = cuda_topk.bf16_smem_bytes(plan.route, d, k, qt, slots, res)
            if smem <= cuda_topk.SMEM_BLOCK:
                out.append(dataclasses.replace(plan, query_tile=qt,
                                               resident=res, slots=slots,
                                               smem_bytes=smem))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--queries", default="1,64,2048,16384")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--routes", default="f32/highest")
    ap.add_argument("--metric", default="sq_euclidean")
    ap.add_argument("--splits", default="")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from vers_tpu_torch.ops import _build, cuda_topk
    from vers_tpu_torch.ops.topk import fused_scan_topk
    from vers_tpu_torch.utils import roofline
    from vers_tpu_torch.utils.data import synthetic_gaussian

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    _build.load_library()
    q_counts = [int(v) for v in args.queries.split(",")]
    x, q = synthetic_gaussian(args.n, args.dim, n_clusters=1024,
                              n_queries=max(q_counts), seed=0, normalized=True,
                              query_noise=0.5)
    dev = torch.device("cuda")
    xf, qf = torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)
    xh, qh = xf.to(torch.bfloat16), qf.to(torch.bfloat16).float()
    k, n, d = args.top_k, args.n, args.dim
    splits = [int(v) for v in args.splits.split(",") if v]
    for route in routes_of(args.routes):
        dt, precision = route.split("/")
        xd, qd = (xh, qh) if dt == "bf16" else (xf, qf)
        kw = dict(metric=args.metric, precision=precision)
        for qn in q_counts:
            qs = qd[:qn]
            reps = max(1, args.reps if qn < 2048 else args.reps // 2)
            plan = cuda_topk.plan_for(qs, xd, n, k, precision)
            whole = dataclasses.replace(
                plan, n_split=1, split_rows=-(-n // cuda_topk.TILE_ROWS)
                * cuda_topk.TILE_ROWS)
            split = lambda: cuda_topk.cuda_distance_topk(qs, xd, n, k, **kw)  # noqa: E731
            plain = lambda: fused_scan_topk(qs, xd, n, k, **kw)  # noqa: E731
            p0 = cuda_ms(torch, plain, 1)
            ms = cuda_ms(torch, split, reps)
            ms_whole = cuda_ms(torch, lambda: cuda_topk.split_pass(
                qs, xd, n, k, plan=whole, **kw), reps if qn < 2048 else 1)
            ms2 = cuda_ms(torch, split, reps)
            p1 = cuda_ms(torch, plain, 1)
            by_split = {}
            for s in splits:  # the split pass alone, then kernel C over it;
                # whole tiles a split, so the count run may be under the one asked
                rows = -(-n // s // cuda_topk.TILE_ROWS) * cuda_topk.TILE_ROWS
                at = dataclasses.replace(plan, n_split=-(-n // rows),
                                         split_rows=rows)
                one = lambda: cuda_topk.split_pass(qs, xd, n, k, plan=at, **kw)  # noqa: E731
                vals, ids, _ = one()
                by_split[s] = dict(
                    n_split=at.n_split, split_rows=rows,
                    split_pass_ms=cuda_ms(torch, one, reps),
                    second_pass_ms=cuda_ms(torch, lambda: (
                        cuda_topk.cuda_topk_values(vals, ids, k)), reps)
                    if at.n_split > 1 else 0.0)
                del vals, ids
            by_plan = {}
            if args.plans and route != "f32/highest":
                for p in all_plans(cuda_topk, plan, d, k):
                    key = f"q{p.query_tile}{'r' if p.resident else 's'}{p.slots}"
                    by_plan[key] = cuda_ms(torch, lambda: cuda_topk.split_pass(
                        qs, xd, n, k, plan=p, **kw), reps)
            b = roofline.distance_topk_bound(qn, n, d, k, corpus=dt,
                                             precision=precision)
            print(json.dumps({
                "card": card, "route": route, "Q": qn, "N": n, "d": d, "k": k,
                "metric": args.metric, "plan": plan.as_dict(),
                "card_plan": dict(zip(("smem_bytes", "blocks_per_sm"),
                                      cuda_topk.card_plan(plan, d, k))),
                "kernel_ms": [ms, ms2], "unsplit_ms": ms_whole,
                "plain_ms": [p0, p1], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"],
                "share_of_bound": b["bound_ms"] / min(ms, ms2),
                "by_split": by_split, "by_plan": by_plan}), flush=True)

    if args.ablate:
        qn = max(q_counts)
        libs = build_variants(_build, "distance_bf16.cu", "vers_distance_topk",
                              ABLATIONS, unchanged=("distance_topk.cu",))
        real = cuda_topk._build
        for route in routes_of(args.routes):
            if route == "f32/highest":
                continue
            dt, precision = route.split("/")
            xd, qd = (xh, qh) if dt == "bf16" else (xf, qf)
            qs = qd[:qn]
            plan = cuda_topk.plan_for(qs, xd, n, k, precision)

            def kernel():
                return cuda_topk.split_pass(qs, xd, n, k, metric=args.metric,
                                            precision=precision, plan=plan)

            rows = {"full": cuda_ms(torch, kernel, 2)}
            try:
                for name, (lib, _) in libs.items():
                    cuda_topk._build = Variant(lib)
                    rows[name] = cuda_ms(torch, kernel, 2)
            finally:
                cuda_topk._build = real
            rows["full_again"] = cuda_ms(torch, kernel, 2)
            print(json.dumps({"card": card, "route": route, "Q": qn,
                              "plan": plan.as_dict(), "ablation_ms": rows}),
                  flush=True)
        print(json.dumps({"variant_ptxas": {
            name: ptxas_lines(path.with_suffix(".log").read_text(), "b16")
            for name, (_, path) in libs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
