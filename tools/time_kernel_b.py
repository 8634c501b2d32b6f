#!/usr/bin/env python3
"""Kernel B (the IVF packed scan) on one CUDA card, at the main path's shapes.

Builds the smoke run's IVF index (``synthetic_gaussian`` 1M x 300 from
seed 0, k = 2048 clusters, 2 restarts, 10 Lloyd iterations), captures
the packed-scan arguments of a 16384-query search (or of each batch size
in ``--queries``) at each ``--nprobe`` (1 and 2), and for each times with CUDA events, in turns (plain, kernel,
kernel, plain), ``cuda_packed_scan`` and its plain version
``packed_scan_plain``, after holding the kernel to the plain version
(tie-aware, |d distance| <= 1e-4) and to itself on a repeat call. One
JSON line per nprobe carries the card's name and power limit, the
kernel's geometry and work (grid, r_blk, and from the live tiles each
block reports, ``cuda_packed_scan_walk``: working blocks, live tiles,
issued products; the useful products and the masked share follow from
the probes), the bound (``utils/roofline.py``) and the share of it
reached. The host mirror of the walk (``packed_scan_units``) is held to
the kernel's report block by block, and ``schedule`` models what the
uneven runs cost: the most tiles one of the card's SMs walks when each
takes the next working block as it falls free (one block an SM), in the
kernel's order (heaviest first, by the plan's cost) and in list order,
beside the mean. A second line a scan times both of the kernel's walks,
forced (``cuda_packed_scan_walk(split=...)``), with each walk's work from
its host mirror; ``split`` in the first line says which one
``split_walk`` picks there.
First it prints kernel B's ``ptxas`` report and the SASS counts of its
matrix, copy and barrier instructions. ``--ablate`` then times, at the
last nprobe, variants built from edited copies of the source:

  * ``no_plan``: blocks in the order of the work list, not heaviest first;
  * ``stream_q_ring3`` / ``stream_q_ring5``: the query tile read through
    L1 instead of resident, with a ring of 3 or 5 slots;
  * ``no_merge``: products and bin test, no candidate passes the filter;
  * ``no_wgmma``: loads, hi/lo split and handshakes, no products, no
    candidates;
  * ``loads_only``: as ``no_wgmma`` without the hi/lo split;
  * ``no_reg_merge``: best sets merged in shared memory at every k, not
    in the mergers' registers up to k = 16;
  * ``maxnreg``: ``setmaxnreg`` moves registers from the producer
    warpgroup (104) to the two consumer warpgroups (200);

and prints each variant's ``ptxas`` stack frame, spills and registers,
which says whose registers the kernel's spill belongs to.

``--parent PATH`` builds an earlier version of ``csrc/packed_scan.cu``
(one whose entry point takes neither the plan's scratch, the walk
report nor the corpus row count; its headers beside it)
and times it beside the kernel at each nprobe, both launched bare
(outputs allocated once): the comparison of two versions inside one call.

``--forest`` times the kernel on its second caller's scans instead: it
builds the smoke run's RP-forest (8 trees, ``max_node_size`` 100) and
captures the first tree's packed scan of a 16384-query search at
``probes_per_tree`` 1, 4 and the default auto depth, each at the
index's own query block (64 rows: one plan unit a work item) and at
128-row blocks (two units an item, which takes the auto depth past
``PLAN_MAX``, where the kernel runs its blocks in list order). Each scan
gets the same line as an IVF scan, and where the plan applies also the
time of the ``no_plan`` variant: list order against plan order.

Usage, from the repository root:

    python3 tools/time_kernel_b.py [--n N] [--queries 64,16384] [--nprobe 1,2]
        [--reps R] [--ablate] [--parent PATH] [--forest]

Needs one CUDA card; exits 2 without one.
"""

import argparse
import heapq
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_timing import (  # noqa: E402
    Variant, build_variants, card_line, cuda_ms, ptxas_report, sass_counts,
    variant_spills)

OPCODES = ("HGMMA", "HMMA", "FFMA", "UTMALDG", "LDGSTS", "SYNCS", "BAR", "ATOMS")

NO_WGMMA = [("          wgmma_tf32(acc, al[ks], dh, j > 0 || ks > 0);",
             "          if (false) wgmma_tf32(acc, al[ks], dh, j > 0 || ks > 0);"),
            ("          wgmma_tf32(acc, ah[ks], dl, 1);\n"
             "          wgmma_tf32(acc, ah[ks], dh, 1);",
             "          if (false) wgmma_tf32(acc, ah[ks], dl, 1);")]
NO_FILTER = ("                if (v < kr) {", "                if (v < -1.f) {")
NO_SPLIT = ("          split_unit(xs + (size_t)slot * SLICE, lo + (size_t)slot * SLICE,\n"
            "                     i * SPLITTERS + p);", "          ;")
# variant name -> [(text in csrc/packed_scan.cu, its replacement)]
STREAM_Q = ("  if (ps::make_layout(d, k, true).bytes <= (size_t)max_smem)",
            "  if (false)")
ABLATIONS = {
    "no_plan": [("  if (plan && units <= ps::PLAN_MAX) {", "  if (false) {")],
    "stream_q_ring3": [STREAM_Q],
    "stream_q_ring5": [STREAM_Q, ("constexpr int RING = 3;",
                                  "constexpr int RING = 5;")],
    "no_merge": [NO_FILTER],
    "no_wgmma": [*NO_WGMMA, NO_FILTER],
    "loads_only": [*NO_WGMMA, NO_FILTER, NO_SPLIT],
    "no_reg_merge": [("      if (k <= KREG) {  // the row's",
                      "      if (false) {  // the row's")],
    "maxnreg": [("  int g_slices = 0, g_tiles = 0;  // slices",
                 "  if (tid >= CONSUMERS)\n"
                 "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 104;\\n\""
                 " ::: \"memory\");\n"
                 "  else\n"
                 "    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 200;\\n\""
                 " ::: \"memory\");\n"
                 "  int g_slices = 0, g_tiles = 0;  // slices")],
}


def schedule(cuda_binned, units, a, q_blk, r_blk, sms, split):
    """A greedy model of the blocks' schedule on ``sms`` SMs, one block
    an SM, in tiles: the makespan in the kernel's order (by the corpus
    rows a block will test: those its run holds inside its query rows'
    bin range, or, split, those of its group with its rows' bins;
    heaviest first; list order past PLAN_MAX units) and in list order,
    and the mean per SM."""
    qbin, gb, rbin = (t.cpu().numpy().reshape(-1) for t in (a[1], a[3], a[5]))
    n_tiles = [len(t) for _, _, t, _ in units]
    cost = []
    for row0, nq, _, (w, end) in units:
        rows = np.concatenate([rbin[int(g) * r_blk : (int(g) + 1) * r_blk]
                               for g in gb[w:end]])
        live = qbin[row0 : row0 + nq]
        live = live[live >= 0]
        cost.append(int(np.isin(rows, live).sum() if split else
                        ((rows >= live.min()) & (rows <= live.max())).sum()))

    def makespan(key):
        free = [0] * max(1, min(sms, len(units)))
        for u in sorted(range(len(units)), key=key):
            heapq.heappush(free, heapq.heappop(free) + n_tiles[u])
        return max(free)

    planned = a[2].shape[0] * -(-q_blk // cuda_binned.QUERY_TILE) \
        <= cuda_binned.PLAN_MAX
    in_list = makespan(lambda u: units[u][0])
    return dict(sms=sms, planned=planned, makespan_tiles_list_order=in_list,
                makespan_tiles=makespan(lambda u: (-cost[u], units[u][0]))
                if planned else in_list,
                mean_tiles_per_sm=sum(n_tiles) / sms)


def bare_library(_build, source):
    """An earlier csrc/packed_scan.cu, built into a library of its own;
    its entry point is today's without the plan's scratch, the walk report,
    the corpus row count and the walk's choice."""
    import ctypes
    import subprocess

    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "lib_packed_scan_parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(source.parent), "-I", str(_build.CSRC), "-o", str(path),
                    str(source)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    sig = _build._SIGNATURES["vers_packed_scan"]
    lib.vers_packed_scan.argtypes = sig[:10] + sig[12:13] + sig[14:-2] + sig[-1:]
    lib.vers_packed_scan.restype = ctypes.c_int
    return lib


def forest_scans(torch, vt, binned, x, qd, args):
    """The first tree's packed scan of a forest search at 1, 4 and the
    auto probe depth, at 64- and 128-row query blocks: [(label, scan
    args, scan kwargs)]."""
    from vers_tpu_torch.ops.forest_shared import forest_search_shared

    forest = vt.ANNIndex.build_index(args.trees, args.max_node_size, x,
                                     np.arange(len(x)))
    scans = []
    for probes in (1, 4, None):
        depth = forest._auto_probes(args.top_k) if probes is None else probes
        deficit_k = args.top_k if probes is None and depth > 1 else 0
        for q_blk in (64, 128):
            sh, plan = forest._shared_plan(args.top_k)
            plan.update(q_blk=q_blk)
            with binned.captured_scans(only=(0,)) as calls:
                forest_search_shared(
                    qd, sh["coeffs"], sh["consts"], sh["cbase"], sh["splits"],
                    sh["buckets"], sh["offsets"], sh["sizes_dev"],
                    sh["corpus_pad"], sh["xx"], sh["src"], sh["rbin"],
                    sh["g_first"], n_probes=depth, num_bins=sh["num_bins"],
                    top_k=args.top_k, deficit_k=deficit_k, **plan)
            scans.append((dict(forest_probes="auto" if probes is None else probes,
                               depth=depth, tree=0), *calls[0]))
    return scans


def scan_bound(torch, roofline, args, kw):
    """The bound of one scan from its own probes: every live stacked row
    against the rows of its bin (``pairs``); the probed bins' rows read
    once."""
    q_stack, qbin, rbin = args[0], args[1].reshape(-1), args[5].reshape(-1)
    sizes = torch.bincount(rbin[rbin >= 0].long(), minlength=int(qbin.max()) + 1)
    live = qbin[qbin >= 0].long()
    pairs = int(sizes[live].sum())  # the products that count
    return dict(roofline.packed_scan_bound(
        live.numel(), q_stack.shape[0], pairs,
        int(sizes[torch.unique(live)].sum()), q_stack.shape[1], kw["top_k"]),
        pairs=pairs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--queries", default="16384",
                    help="query batch sizes, comma-separated")
    ap.add_argument("--clusters", type=int, default=2048)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--nprobe", default="1,2")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--parent", help="an earlier csrc/packed_scan.cu to time "
                    "beside the kernel")
    ap.add_argument("--forest", action="store_true",
                    help="time the RP-forest's scans instead of the IVF's")
    ap.add_argument("--trees", type=int, default=8)
    ap.add_argument("--max-node-size", type=int, default=100)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import vers_tpu_torch as vt
    from vers_tpu_torch.ops import _build, binned, cuda_binned
    from vers_tpu_torch.utils import roofline
    from vers_tpu_torch.utils.data import synthetic_gaussian
    from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cuda_binned.kernel_constants() == dict(
        QUERY_TILE=cuda_binned.QUERY_TILE, TILE_ROWS=cuda_binned.TILE_ROWS,
        PLAN_MAX=cuda_binned.PLAN_MAX)
    print(json.dumps({
        "card": card, "ptxas": ptxas_report(_build, "packed_scan"),
        "sass": sass_counts(_build.library_path(), OPCODES, "packed_scan"),
    }), flush=True)

    batches = [int(v) for v in args.queries.split(",")]
    x, q = synthetic_gaussian(args.n, args.dim, n_clusters=1024,
                              n_queries=max(batches), seed=0, normalized=True,
                              query_noise=0.5)
    qd = torch.from_numpy(q).to("cuda")

    def kernel(a, kw):
        return lambda: cuda_binned.cuda_packed_scan(*a, **kw)

    parent = bare_library(_build, Path(args.parent)) if args.parent else None
    no_plan = None
    if args.forest:
        scans = forest_scans(torch, vt, binned, x, qd, args)
        no_plan = Variant(build_variants(
            _build, "packed_scan.cu", "vers_packed_scan",
            {"no_plan": ABLATIONS["no_plan"]})["no_plan"][0])
    else:
        ivf = vt.IVFFlatIndex.build_index(args.clusters, 2, 10, x)
        ivf._ensure_layout()
        scans = []
        for q_n in batches:
            for nprobe in (int(v) for v in args.nprobe.split(",")):
                with binned.captured_scans() as calls:
                    ivf.search_batch_device(qd[:q_n], args.top_k, nprobe)
                scans.append((dict(queries=q_n, nprobe=nprobe), *calls[0]))

    for label, a, kw in scans:
        r_blk = kw["chunk"] * kw["r_chunks"]
        got = cuda_binned.cuda_packed_scan(*a, **kw)
        again = cuda_binned.cuda_packed_scan_walk(*a, **kw)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        walked = again[2].cpu().numpy()
        split = cuda_binned.walk_splits(a[0], kw["q_blk"])
        units = cuda_binned.packed_scan_units(a[1], a[2], a[3], a[5],
                                              kw["q_blk"], r_blk, split)
        assert np.array_equal(walked, cuda_binned.units_walked(
            units, a[2].shape[0], kw["q_blk"]))
        want = cuda_binned.packed_scan_plain(*a, **kw)
        assert_topk_match(got[0], got[1], want[0], want[1], rtol=0.0, atol=1e-4)
        err = max_abs_diff(got[0], want[0])
        del got, again, want
        plain = lambda: cuda_binned.packed_scan_plain(*a, **kw)  # noqa: E731
        p0 = cuda_ms(torch, plain, 1)
        ms = [cuda_ms(torch, kernel(a, kw), args.reps) for _ in range(2)]
        p1 = cuda_ms(torch, plain, 1)
        b = scan_bound(torch, roofline, a, kw)
        live_tiles = int(walked[walked >= 0].sum())
        issued = cuda_binned.QUERY_TILE * cuda_binned.TILE_ROWS * live_tiles
        work = dict(
            grid=list(walked.shape), r_blk=r_blk,
            working_blocks=int((walked >= 0).sum()), live_tiles=live_tiles,
            max_tiles_per_block=int(walked.max()), issued_products=issued,
            useful_products=b["pairs"],
            masked_share=1.0 - b["pairs"] / issued,
            split=split,
            schedule=schedule(cuda_binned, units, a, kw["q_blk"], r_blk, sms,
                              split))
        list_order = None
        if no_plan is not None and work["schedule"]["planned"]:
            real = cuda_binned._build
            cuda_binned._build = no_plan
            try:
                list_order = cuda_ms(torch, kernel(a, kw), args.reps)
            finally:
                cuda_binned._build = real
            ms.append(cuda_ms(torch, kernel(a, kw), args.reps))
        print(json.dumps({
            "card": card, **label, "rows": a[0].shape[0],
            "plan_units": walked.size, "list_order_ms": list_order,
            "work_items": a[2].shape[0], "d": a[0].shape[1],
            "top_k": kw["top_k"], "q_blk": kw["q_blk"], "work": work,
            "max_abs_err": err, "kernel_ms": ms, "plain_ms": [p0, p1],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bound_bytes": b["bytes"], "bound_ops": b["ops"],
            "share_of_bound": b["bound_ms"] / min(ms),
            "issued_tf32_flop_per_s":
                3 * 2 * a[0].shape[1] * work["issued_products"] / (min(ms) * 1e-3),
        }), flush=True)
        walks = {}
        for name, flag in (("run", False), ("split", True)):
            mirror = cuda_binned.packed_scan_work(a[1], a[2], a[3], a[5],
                                                  kw["q_blk"], r_blk, flag)
            walks[name] = dict(
                kernel_ms=cuda_ms(torch, lambda flag=flag: (
                    cuda_binned.cuda_packed_scan_walk(*a, **kw, split=flag)),
                    args.reps),
                **{key: mirror[key] for key in (
                    "working_blocks", "live_tiles", "max_tiles_per_block",
                    "masked_share")})
        print(json.dumps({"card": card, **label, "walks": walks}), flush=True)

        if parent is not None:  # both launched bare, in turns
            od = torch.empty((a[0].shape[0], kw["top_k"]), device="cuda")
            oi = torch.empty(od.shape, dtype=torch.int32, device="cuda")
            ptrs = [None if t is None else t.data_ptr()
                    for t in (*a[:7], kw["ids_padded"], od, oi)]
            tail = (a[0].shape[1], a[2].shape[0], kw["q_blk"], r_blk,
                    kw["top_k"], int(kw["metric"] == "cosine"),
                    torch.cuda.current_stream().cuda_stream)
            new = _build.load_library()
            run_old = lambda: parent.vers_packed_scan(  # noqa: E731
                *ptrs, a[0].shape[0], *tail)
            plan = torch.empty((3 * a[2].shape[0] * -(-kw["q_blk"] // 64),),
                               dtype=torch.int32, device="cuda")
            run_new = lambda: new.vers_packed_scan(  # noqa: E731
                *ptrs, plan.data_ptr(), None, a[0].shape[0], a[4].shape[0],
                *tail[:-1], int(split), tail[-1])
            ms = [cuda_ms(torch, f, args.reps)
                  for f in (run_old, run_new, run_new, run_old)]
            print(json.dumps({"card": card, **label,
                              "bare_parent_ms": [ms[0], ms[3]],
                              "bare_kernel_ms": ms[1:3]}), flush=True)

    if args.ablate:
        libs = build_variants(_build, "packed_scan.cu", "vers_packed_scan",
                              ABLATIONS)
        real = cuda_binned._build
        rows = {"full": cuda_ms(torch, kernel(a, kw), args.reps)}
        try:
            for name, (lib, _) in libs.items():
                cuda_binned._build = Variant(lib)
                rows[name] = cuda_ms(torch, kernel(a, kw), args.reps)
        finally:
            cuda_binned._build = real
        rows["full_again"] = cuda_ms(torch, kernel(a, kw), args.reps)
        hgmma = {name: sass_counts(path, ("HGMMA",), "packed_scan")
                 for name, (_, path) in libs.items()}
        spills = {name: variant_spills(path, "packed_scan")
                  for name, (_, path) in libs.items()}
        print(json.dumps({"card": card, **label, "ablation_ms": rows,
                          "variant_hgmma": hgmma, "variant_ptxas": spills}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
