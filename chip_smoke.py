#!/usr/bin/env python3
"""Smoke run of vers_tpu_torch on one CUDA card, at full size.

Drives the port's main path once through the entry points a user
calls, at the reference dataset's shape (1M x 300 f32, k = 2048
clusters, 16384 queries; the corpus is ``synthetic_gaussian`` from a
seed, as bench.py makes it when the wiki file is absent). Every index is
built without ``device=``, so the run also shows that the card is the
port's default device:

  1. exact ground truth with ``FlatIndex`` (kernel A),
  2. the flat approximate engines, each through ``search_batch``:
     ``FlatIndex(engine="bucket")`` without and with
     ``bucket_rescore`` (kernel D, the bucket-min scan, then kernel C,
     the values top-k) and ``FlatIndex(engine="approx")``, recall@10
     against the ground truth,
  3. ``IVFFlatIndex.build_index(2048, 2, 10, ...)``,
  4. ``search_batch`` over nprobe 1, 2, 4, 8 until recall@10 >= 0.95
     (kernel B), then the adaptive nprobe=0, ``search_approximate``,
     ``add`` + search for the added row, and a save/load round trip,
  5. the RP-forest at the size bench.py runs it:
     ``ANNIndex.build_index(8, 100, ...)`` (build seconds on the host and
     on the card apart, leaves per tree), ``search_batch`` with the
     default auto probes (the deficit rule), ``probes_per_tree=4`` and
     ``=1``: recall@10 against phase 1's ground truth with a floor per
     setting, the median and spread of five timed calls of
     ``search_batch_device``, kernel B launched once a tree a search,
     the plan units of a launch against ``PLAN_MAX``; the plain engine
     (``engine="xla"``) on a 2048-query slice equal to the kernel
     engine's; ``search_approximate``; ``add`` of enough rows into one
     leaf to split it, then a search that finds them; a save/load round
     trip,
  6. HNSW at the reference's own workload (``main.rs:70-79``):
     ``HNSWIndex.build_index_batched(12, 100, 32, 24, x)`` with no
     ``device=`` and the default ``wave_cap="auto"`` (build seconds,
     device and host apart, layer sizes, the auto policy's (cap, dp),
     the inline beam asserted on), first on phase 1's corpus (recall@10
     at ef = 32 against phase 1's truth, floor = first reading less
     0.02, then the cheapest ef reaching 0.95), then on the 4096-cluster
     corpus of the JAX package's 1M HNSW record with its own exact truth
     (kernel A): ``search_batch`` at ef = 32, k = 10, recall@10 >= 0.95;
     the median and spread of five timed calls of
     ``search_batch_device``; the same graph with the classic gather
     beam (``nav_inline_dp=None``) and with ``route_mode="beam"`` on a
     2048-query slice; ``add`` of one row on the device fast path, then
     a search that finds it first; the int8 navigation table on the same
     index (``nav_dtype="int8"``, ``nav_inline_dp=None``: recall@10 and
     the median and spread of five searches of all 16384 queries beside
     the bf16 classic beam's in the same run, with a floor; the nav
     table's bytes; ``route_mode="beam"`` on the slice; a
     device ``add`` found first; with the inline table on, the cache
     asserted bf16); the scan-routed build
     (``build_index_batched(..., route_scan=True)``) and the
     inline-insertion build (``insert_inline=True``) of the same corpus,
     each with its build seconds split as above beside the classic
     build's, the classic layer sizes, kernel A's launches in the build
     (all bf16/default for the scans; none for the inline build, whose
     construction table's bytes are printed) and recall@10 of the
     default search beside the classic build's, with a floor each; a
     save/load round trip of a separate 20k-row index. Kernel A's
     counter is zeroed before the HNSW builds and must have moved by the
     end: it runs the layer-1 routing scan of every scan-routed search
     and every scan of the scan-routed build; the inputs of one routing
     scan and of the build's last k = 100 and k = 1 scans are captured
     and held to the plain version below. Kernel E's counters
     (``beam_inline.LAUNCHES``, ``LAUNCHES_PLAIN``) are zeroed with it:
     the main reading's search moves the first, and by the phase's end
     every inline beam step of the phase (the default policy) ran on
     kernel E, none on the plain step. The steps of one search at
     ef = 48 (the benchmark's HNSW cell's widths: 4 entries expanded,
     degree 32, dp 64, 96 refined, d 300) are captured, held to the
     plain step one by one and timed (below), outside the phase's
     counts.
  7. the multi-device layer (``vers_tpu_torch.parallel``) on a mesh of
     four shards on the one card (``make_mesh(4, device="cuda:0")``),
     over the corpora, truths and indexes of the earlier phases:
     ``ShardedFlatIndex`` equal to phase 1's exact search (tie-aware,
     |d| within 1e-4; kernel A once a shard a search; median and spread
     of five calls); ``ShardedIVFFlatIndex`` from phase 2's centroids
     and rows equal to a single-device index of the same bins at nprobe
     1 and 2 (kernel B once a shard; the shards bin their rows on the
     card in the JAX package's numpy difference form, held bit for bit to
     numpy on every row phase 2's matmul form bins otherwise and on a
     sample; that index is phase 2's when no row moved), then built once
     by the sharded k-means
     (``build_index(2048, 2, 10, x, mesh)``: build seconds, recall@10 at
     nprobe 2); ``ShardedANNIndex`` over phase 5's forest equal to its
     search at 1 and 4 probes (kernel B 4 x 8 a search);
     ``ShardedHNSWIndex`` over phase 6's index equal to its
     ``route_mode="beam"`` search on a 2048-query slice, with the bf16
     and with the int8 navigation table;
     ``PartitionedANNIndex.build_index(8, 100, x, mesh)`` and
     ``PartitionedHNSWIndex.build_index(12, 100, 32, 24, x, mesh)``
     (build seconds, recall@10 against phase 1's truth with a floor,
     the per-shard launches: B 8 a shard, A 1 a shard); and a save/load
     round trip of every class at 20k rows. All four counters are zeroed
     just before the phase and read just after (kernel D: no caller
     there). Then each path's kernel is held to its plain version on
     inputs captured from the phase's own searches: kernel A on shard
     0's exact scan (Q = 16384 over its 250k rows) and on the partitioned
     HNSW's shard-0 routing scan, kernel B on shard 0's IVF scan at
     nprobe 2, on query shard 0's first-tree scan of the sharded forest
     at 4 probes and on shard 0's first-tree scan of the partitioned
     forest at the auto probes. Every search runs its shards at once
     (``mesh.map_shards``: a thread and a stream a shard) and is timed
     three ways, interleaved call by call: at once, in turn (the bodies
     one after another on the caller's thread and stream, the loop the
     package ran before it had an executor, patched back in by
     ``shard_intervals`` for the yardstick) and the single-device twin:
     median and spread of five calls each, and the shards' overlap (the
     sum of each body's interval on its stream, from CUDA events, over
     the call's wall). On a machine of two to four cards
     every class runs again over ``make_mesh()``, one shard a card (the
     partitioned forests rebuilt from the same tables card by card, the
     partitioned HNSW's serving tables assembled on the cards), equal to
     its one-card twin and timed the same way, with the gather of the
     merge across cards; one card prints that it was not run.
  8. kernel A's other routes and their callers, then the user-facing
     surface, with the counters of kernels A (by route), C and D zeroed
     just before and read just after: ``FlatIndex(dtype="bfloat16")``
     over phase 1's corpus (the store's bytes beside the f32 store's;
     the exact engine, kernel A's bf16-corpus route at "highest",
     recall@10 against phase 1's f32 truth with a floor; bucket +
     rescore, kernels D and C over the bf16 rows, recall with a floor);
     ``distance_topk`` at precision "default" and "high" over phase 1's
     f32 corpus and over the bf16 store at 2048 and 16384 queries; the
     README flow (``load_wiki()``, ``HNSW(100, 8, 32, 8)`` built on the
     card, the queen's neighbours printed) and ``demo.main(["--index",
     "ivfflat"])`` on the card. Then each route of kernel A is held to
     its plain version at the same setting (tie-aware, distances within
     1e-4, a repeat call bit-identical) at 2048 and 16384 queries and
     timed beside its bound, with its plan printed (query tile, slots,
     resident query parts, shared bytes, blocks an SM from the card's
     occupancy query, splits) and its shared bytes held to the built
     kernel's layout; and
     a 100k x 300 `.vec` file and a saved 100k-row HNSW index are read
     by the native and the Python readers, equal, both times printed.
     (Phase 6's routing scan runs the bf16 route at "default" over a
     bf16 table; it is held there to its plain version and timed beside
     the route it took before, 3xTF32 over an f32 copy of the same
     table, timed in the same run.)

The launch counters of kernels C and D are zeroed just before phase 2
and must have moved by its end; those of A and B likewise around phases
1-4, and kernel B's again around phase 5 (8 launches a search). The
packed-scan inputs of the main path's own searches (each nprobe of the
sweep, the adaptive nprobe=0, a 64-query ``search_batch`` at nprobe 2
from host queries, the batch of online retrieval, which kernel B walks
split (``cuda_binned.split_walk``), and the forest's first and last tree at
each probe setting, copied as they pass because the trees share one
view buffer) are captured as they pass. Then each kernel is held against its plain torch version on the
card at the main path's shapes and timed with CUDA events: kernel A
(which splits the corpus across blocks and takes the final k with
kernel C) on the first 1, 64, 2048 and all 16384 queries over the whole
corpus, k = 10, tie-aware, distances within 1e-4, a repeat call bit-
identical, with its split count, grid and second-pass time logged, and
``FlatIndex.search_approximate`` for one query on the host clock; kernel
B on the captured scans, the same (a repeat call bit-identical too);
kernel D's bucket table on the
first 64, 2048 and all 16384 queries (the phase-2 search's own call at
16384), distances within 1e-4 and rows equal except at near-ties
(counted), a repeat call and the unprepared-corpus call bit-identical,
with its grid logged; kernel C on that table at the shortlist widths 10,
32 and 128, bit-identical (it only selects), beside one ``torch.topk``
call on the same table (timed as the yardstick, with its tie order
checked; the port never calls it), and on the narrow table of kernel A's
second pass (the best sets of its corpus splits at 16384 queries).
Kernel B's lines also carry its geometry (r_blk, grid) and its work as
the kernel itself reports it in one more launch (the blocks that work
and the live tiles each walks, hence the products issued and, against
the products its probes need, the masked share); at the operating
nprobe, on the 64-query scan, and for the forest's first tree at each
probe setting, the host mirror of the walk is held to that report block
by block, and the other of kernel B's two walks, forced, gives the same
answer bit for bit and its own report equal to its own mirror. Kernel
B's entry counts its launches on the split walk (``LAUNCHES_SPLIT``)
apart, by phase. Kernel
A is also held on HNSW's captured routing scan (Q = 16384 over the
layer-1 members, k = 8, cosine, its bf16 route at "default" over the
bf16 table): tie-aware, distances within 1e-5, a repeat call
bit-identical; and on the scan-routed build's last upper-layer scan
(k = 100 over layer 1's built members) and last seed scan (k = 1), the
same route: tie-aware, distances within 1e-4, a repeat call
bit-identical, each timed beside its plain version and its bound.
Kernel F (``rank_merge``, the binned search's cross-probe merge) is held
on the merges of the sweep's nprobe > 1 searches and of the adaptive
nprobe=0 (the benchmark's adaptive cell: 16384 queries at the walk's
depth), captured as they pass, against ``rank_merge_plain`` on the card
bit for bit, a repeat call bit-identical, timed beside it and beside its
bound (the probe flags, each live rank's inverse entry and row, the
result); its launches are counted by phase, and the forest's phase
launches none (its trees overlap: the dedup merge).
Kernel E (``beam_step``, the inline beam's step) is held on the captured
steps as ``hold_beam_step`` says, and its ``ms`` and ``plain_ms`` are a
step's, with two bounds: from the rows the steps load (the picked
adjacency rows, the live candidates' inline blocks, the refined
full-dim rows) and at full width; its launches are phases 6 and 7's. The
``kernels`` line lists kernel A's f32 "highest" route as
``distance_topk`` and each other route as
``distance_topk[<corpus>/<precision>]``: each entry's launches, error
and times are that route's alone, its launches summed over the counted
phases. Each kernel's bound, the least time the card
could take for its work, comes from ``vers_tpu_torch/utils/roofline.py``
and this run's inputs (kernel B's from the probes it captured).

Every IVF, forest and HNSW search runs as the package runs it, replaying
CUDA graphs (``vers_tpu_torch.graphs``); the captures of the kernels'
arguments run under ``graphs.disabled()``. On the indexes and queries of
phases 4-7 each graph-replayed search is held to the same search run
eagerly (``graphs.disabled()``), ids and distances bit for bit: IVF at
nprobe 1 and 2 (nprobe 0, the adaptive depth, runs eagerly); the forest
at 1 and 4 probes and auto; HNSW scan-routed with the inline beam, the
classic beam and the int8 table; the sharded IVF (nprobe 2), forest (1
probe) and HNSW (beam route) on four shards of the card. Five calls of
each are timed, graph and eager interleaved call by call (medians and
spread), with each graph's pool bytes; the IVF (nprobe 1, 2 and 0) and
forest searches make no host synchronisation after a setting's capture
(``set_sync_debug_mode("error")``); and eight calls chained and drained
once are timed beside eight drained each (IVF at the operating nprobe,
the forest at 1 probe). The indexes keep their graphs to the end of the
run, as a server would.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and builds the kernels from ``vers_tpu_torch/csrc``
on first use. Any failure raises and exits non-zero. The line before the
last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N, DIM, N_QUERIES, TOP_K = 1_000_000, 300, 16384, 10
SMALL_QUERIES = 64  # online retrieval's batch: kernel B's split walk
A_QUERIES = (1, 64, 2048, N_QUERIES)  # query counts of the kernel-A phase
D_QUERIES = (64, 2048, N_QUERIES)     # ... and of the kernel-D phase
K_CLUSTERS = 2048
TARGET_RECALL = 0.95
# recall@10 floors of the flat approximate engines against the exact scan
ENGINE_RECALL = {"bucket": 0.95, "bucket+rescore": 0.99, "approx": 0.999}
TOL = 1e-4  # distances: f32 sums in other orders, TF32 off
FOREST_TREES, FOREST_LEAF = 8, 100  # bench.py's forest: 8 trees, max_node_size 100
FOREST_SLICE = 2048                 # queries of the plain-engine comparison
# recall@10 floors of the forest per probes_per_tree (None: the auto
# deficit rule). The reference promises nothing at 1M rows: each floor is
# the first reading on an H100 (0.3330 / 0.6608 / 0.3326) less 0.02.
FOREST_RECALL = {None: 0.313, 4: 0.640, 1: 0.312}
# HNSW: the reference's main.rs:70-79 build (num_layers, ef_construction,
# ef_search, M) and its ef_search
HNSW_ARGS = (12, 100, 32, 24)
HNSW_EF = HNSW_ARGS[2]
HNSW_SLICE = 2048  # queries of the classic-beam and beam-route readings
# The JAX package's 1M HNSW record ran on a corpus of 4096 clusters
# (benchmarks/tpu_1m_hnsw_default.py:48-51): recall@10 >= 0.95 at
# ef = 32 is held there. On phase 1's 1024-cluster corpus the same
# build reads lower (first reading on an H100: 0.9357; the JAX package's
# own bench row on that corpus, BENCH_1M.json, 0.9313 at (8, 100, 32,
# 16)): its floor is that reading less 0.02, and the cheapest ef that
# reaches 0.95 is found and held.
HNSW_CLUSTERS = 4096
HNSW_RECALL_PHASE1 = 0.915
HNSW_EFS = (48, 64, 96, 128, 192)
HNSW_IO_ROWS = 20_000  # the save/load round trip's separate index
# kernel E (the inline beam's step) is held and timed on the steps of a
# search at the benchmark's HNSW cell's ef (perfbench/configs/
# wiki300-hnsw-m24.json): with the served degree 32 and dp 64, 4 entries
# expanded and 96 candidates refined a step, as there
HNSW_E_EF = 48
# recall@10 floors of phase 6's HNSW options on the 4096-cluster corpus at
# ef = 32, each the first reading on an H100 less 0.02: the scan-routed
# build (0.9952) and the inline-insertion build (0.9801), searched by
# default, and the int8 navigation table (0.9623, the classic beam)
HNSW_SCAN_BUILD_RECALL = 0.975
HNSW_INLINE_BUILD_RECALL = 0.960
HNSW_INT8_RECALL = 0.942
# the multi-device phase: a mesh of four shards on the one card
PARALLEL_SHARDS = 4
PARALLEL_IO_ROWS = 20_000  # the save/load round trips of every class
# recall@10 floors of the partitioned builds on phase 1's corpus: the
# forest at the auto probes, HNSW at ef = 32; each the first reading on an
# H100 (0.5189 / 0.9964) less 0.02
PART_FOREST_RECALL = 0.498
PART_HNSW_RECALL = 0.976
# phase 8: kernel A's other routes, the bf16 flat store, the README flow,
# the demo and the native IO
A8_QUERIES = (2048, N_QUERIES)  # query counts of the default/high readings
# recall@10 floors of the bf16 store against phase 1's f32 truth: the
# exact engine and bucket + rescore, each the first reading on an H100
# (0.9937 / 0.9934) less 0.02
BF16_EXACT_RECALL = 0.973
BF16_BUCKET_RECALL = 0.973
NATIVE_ROWS = 100_000  # the .vec file's rows and the saved HNSW index's
NATIVE_HNSW_ARGS = (6, 40, 32, 8)  # that index's (layers, efc, ef, M)
ROOT = Path(__file__).resolve().parent


T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:5.0f} s] {msg}", flush=True)


def cuda_ms(torch, fn, reps=3):
    """Mean milliseconds per call on the card's timeline, after two
    warm-up calls (a search's first call runs eagerly, its second
    captures its CUDA graph)."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(torch, fn):
    """Milliseconds of one call on the card's timeline (CUDA events),
    ending in a synchronize."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def same_result(torch, got, want):
    """Ids equal and distances bit for bit: (dists, ids) tensors, or
    SearchResults."""
    if isinstance(got, tuple):
        return (torch.equal(got[1], want[1])
                and torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32)))
    return (np.array_equal(got.ids, want.ids)
            and np.array_equal(got.distances.view(np.int32),
                               want.distances.view(np.int32)))


def pool_bytes(caches):
    """The bytes of each ``graphs.GraphCache``'s pool (an index's graphs
    share one; a sharded index has a cache a shard), with the keys of
    the configurations whose graphs it holds."""
    return [dict(bytes=cache.pool_bytes(),
                 sites=[str(site.key[0]) for site in cache.sites()])
            for cache in caches]


def graph_reading(torch, label, search, caches=(), reps=5):
    """A search as the package runs it (replaying CUDA graphs) against
    the same search eagerly (``graphs.disabled()``): its first call (run
    eagerly), its second (the capture), unless earlier calls of this
    configuration made them, and a replay equal to the eager search, ids
    and distances bit for bit; then ``reps`` calls of each, the two
    interleaved call by call, timed with CUDA events (medians and
    spread); the pool bytes of ``caches``' graphs. Returns the row."""
    from vers_tpu_torch import graphs

    calls = []
    for _ in range(2):
        t0 = time.perf_counter()
        calls.append(search())
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
    first, first_s, capture, capture_s = calls
    replay = search()
    with graphs.disabled():
        eager = search()
    for got in (first, capture, replay):
        assert same_result(torch, got, eager), label
    del calls, first, capture, replay, eager
    g_ms, e_ms = [], []
    for _ in range(reps):
        g_ms.append(event_ms(torch, search))
        with graphs.disabled():
            e_ms.append(event_ms(torch, search))
    g_ms.sort()
    e_ms.sort()
    mid = reps // 2
    pools = pool_bytes(list(caches))
    total = sum(p["bytes"] for p in pools)
    log(f"{label}: graph replays equal the eager search bit for bit; graph "
        f"median {g_ms[mid]:.3f} ms (min {g_ms[0]:.3f}, max {g_ms[-1]:.3f} of "
        f"{reps}), eager {e_ms[mid]:.3f} ms ({e_ms[0]:.3f}-{e_ms[-1]:.3f}), "
        f"interleaved; eager / graph {e_ms[mid] / g_ms[mid]:.2f}; first call "
        f"{first_s:.3f} s, capturing call {capture_s:.3f} s; graph pools "
        f"{total / 1e9:.3f} GB {pools}")
    return dict(graph_ms=g_ms[mid], graph_min=g_ms[0], graph_max=g_ms[-1],
                eager_ms=e_ms[mid], eager_min=e_ms[0], eager_max=e_ms[-1],
                first_call_s=first_s, capture_call_s=capture_s,
                pool_bytes=pools, pool_bytes_total=total)


def no_sync_reading(torch, label, searches):
    """Each search twice (its first call and its capture, where new),
    then twice more each under ``torch.cuda.set_sync_debug_mode("error")``:
    a host synchronisation in any of them raises."""
    for search in searches:
        search()
        search()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for search in searches:
            search()
            search()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{label}: {len(searches)} searches, two calls each after the "
        f"capture under set_sync_debug_mode('error'): no host "
        f"synchronisation")
    return dict(searches=len(searches), calls_checked=2 * len(searches))


def chained_reading(torch, label, search, n_queries, depth=8, rounds=3):
    """The pipelined serving model of ``docs/SERVING.md``: ``depth``
    calls chained with one drain at the end, beside ``depth`` calls each
    drained, as the package runs them (graphs) and eagerly; host clock,
    ms a call, the best of ``rounds``, all four interleaved."""
    from vers_tpu_torch import graphs

    def chained(drain_each):
        t0 = time.perf_counter()
        for _ in range(depth):
            search()
            if drain_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / depth * 1e3

    search()
    search()
    torch.cuda.synchronize()
    got = {"graph_chained": [], "graph_synced": [], "eager_chained": [],
           "eager_synced": []}
    for _ in range(rounds):
        got["graph_chained"].append(chained(False))
        got["graph_synced"].append(chained(True))
        with graphs.disabled():
            got["eager_chained"].append(chained(False))
            got["eager_synced"].append(chained(True))
    row = {k: min(v) for k, v in got.items()}
    row["depth"] = depth
    row["graph_chained_qps"] = n_queries / row["graph_chained"] * 1e3
    log(f"{label}, {depth} calls chained then drained: {row['graph_chained']:.3f}"
        f" ms a call ({row['graph_chained_qps']:.0f} qps); each drained "
        f"{row['graph_synced']:.3f}; eager chained {row['eager_chained']:.3f}, "
        f"each drained {row['eager_synced']:.3f} (host clock, best of {rounds})")
    return row


def hold_kernel_b(torch, args, kw, label, mirror, time_plain=True):
    """Kernel B against its plain version on one captured packed scan:
    tie-aware, distances within TOL, a repeat call bit-identical; its
    time, its bound from these inputs and its work as the kernel reports
    it (``mirror``: the host mirror of the walk held to that report block
    by block, and the other walk, forced, held to the walk taken bit for
    bit and its report to its own mirror). Returns the scan's row for
    the ``kernels`` line."""
    from vers_tpu_torch.ops import cuda_binned
    from vers_tpu_torch.utils import roofline
    from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

    q_stack, qb, gb, corpus_padded = args[0], args[2], args[3], args[4]
    r_blk = kw["chunk"] * kw["r_chunks"]
    cuda_binned.check_work_items(qb, gb, q_stack.shape[0], kw["q_blk"],
                                 corpus_padded.shape[0], r_blk)
    kb = cuda_binned.cuda_packed_scan(*args, **kw)
    # a repeat call on the walk ``split_walk`` picks, which also reports
    # the tiles each block walked
    split = cuda_binned.walk_splits(q_stack, kw["q_blk"])
    again = cuda_binned.cuda_packed_scan_walk(*args, **kw, split=split)
    assert torch.equal(kb[0], again[0]) and torch.equal(kb[1], again[1]), label
    walked = again[2].cpu().numpy()
    if mirror:
        other = cuda_binned.cuda_packed_scan_walk(*args, **kw, split=not split)
        assert torch.equal(other[1], kb[1]), label
        assert torch.equal(other[0].view(torch.int32),
                           kb[0].view(torch.int32)), label
        for flag, report in ((split, walked), (not split, other[2].cpu().numpy())):
            units = cuda_binned.packed_scan_units(
                args[1], qb, gb, args[5], kw["q_blk"], r_blk, flag)
            assert np.array_equal(report, cuda_binned.units_walked(
                units, qb.shape[0], kw["q_blk"])), (label, flag)
        del other
    pb = cuda_binned.packed_scan_plain(*args, **kw)
    assert_topk_match(kb[0], kb[1], pb[0], pb[1], rtol=0.0, atol=TOL)
    err_b = max_abs_diff(kb[0], pb[0])
    del kb, again, pb
    ms_b = cuda_ms(torch, lambda: cuda_binned.cuda_packed_scan(*args, **kw))
    plain_b = cuda_ms(torch, lambda: cuda_binned.packed_scan_plain(*args, **kw),
                      reps=1) if time_plain else None
    # the work these probes ask for: each live stacked row against
    # the rows of its bin; the probed bins' rows read once
    qbin, rbin = args[1].reshape(-1), args[5].reshape(-1)
    sizes = torch.bincount(rbin[rbin >= 0].long(),
                           minlength=int(qbin.max()) + 1)
    live = qbin[qbin >= 0].long()
    useful = int(sizes[live].sum())
    bound = roofline.packed_scan_bound(
        live.numel(), q_stack.shape[0], useful,
        int(sizes[torch.unique(live)].sum()), q_stack.shape[1], kw["top_k"])
    live_tiles = int(walked[walked >= 0].sum())
    issued = cuda_binned.QUERY_TILE * cuda_binned.TILE_ROWS * live_tiles
    assert issued >= useful > 0, (issued, useful)
    units_n = walked.shape[0] * walked.shape[1]
    log(f"kernel B vs plain, {label} "
        f"({q_stack.shape[0]} query rows, {qb.shape[0]} work items, "
        f"{'split' if split else 'run'} walk"
        f"{', the other walk forced: bit-identical' if mirror else ''}): "
        f"max |d| {err_b:g}, {ms_b:.3f} ms vs "
        f"{'not timed' if plain_b is None else f'{plain_b:.2f} ms'}; bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, "
        f"{bound['ops']:.3g} TF32 flop, {bound['bytes']:.3g} bytes); "
        f"r_blk {r_blk}, grid {list(walked.shape)} = {units_n} plan units "
        f"({'over' if units_n > cuda_binned.PLAN_MAX else 'within'} PLAN_MAX), "
        f"{int((walked >= 0).sum())} working blocks, {live_tiles} "
        f"live tiles (at most {int(walked.max())} a block) as the kernel "
        f"reports them, masked share {1.0 - useful / issued:.4f} of "
        f"{issued:.4g} products issued")
    return dict(rows=q_stack.shape[0], work_items=qb.shape[0],
                walk="split" if split else "run",
                r_blk=r_blk, grid=list(walked.shape),
                max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


@contextlib.contextmanager
def captured_route_scan(shard=None):
    """Record the first HNSW layer-1 routing scan (``ops/beam.route_scan``,
    kernel A) that a search makes inside the block (with ``shard``, the
    first that shard's body makes under ``parallel.mesh.map_shards``), as
    (queries copied, table, rows, k); every call goes through unchanged,
    eagerly (``graphs.disabled``)."""
    from vers_tpu_torch import graphs
    from vers_tpu_torch.ops import beam
    from vers_tpu_torch.parallel.mesh import current_shard

    captured = []
    real = beam.route_scan

    def capturing(queries, l1_tab, n1, k):
        if not captured and (shard is None or current_shard() == shard):
            captured.append((queries.clone(), l1_tab, n1, k))
        return real(queries, l1_tab, n1, k)

    beam.route_scan = capturing
    try:
        with graphs.disabled():
            yield captured
    finally:
        beam.route_scan = real


@contextlib.contextmanager
def captured_merges():
    """Record every merge by kernel F (``cuda_binned.cuda_rank_merge``)
    that searches inside the block make, as its arguments; every call
    goes through unchanged, eagerly (``graphs.disabled``)."""
    from vers_tpu_torch import graphs
    from vers_tpu_torch.ops import binned

    captured = []
    real = binned.cuda_rank_merge

    def capturing(*args):
        captured.append(args)
        return real(*args)

    binned.cuda_rank_merge = capturing
    try:
        with graphs.disabled():
            yield captured
    finally:
        binned.cuda_rank_merge = real


def hold_rank_merge(torch, args, label):
    """Kernel F against its plain version on one captured merge, both on
    the card: ids and distances bit for bit, a repeat call bit-identical;
    its time beside the plain version's and its bound from these inputs
    (the probe flags, each live rank's inverse entry and row, the
    result). Returns the merge's row for the ``kernels`` line."""
    from vers_tpu_torch.ops import cuda_binned
    from vers_tpu_torch.utils import roofline

    probes, num_bins, top_k = args[3], args[5], args[6]
    kf = cuda_binned.cuda_rank_merge(*args)
    for got in (cuda_binned.cuda_rank_merge(*args),
                cuda_binned.rank_merge_plain(*args)):
        assert torch.equal(got[1], kf[1]), label
        assert torch.equal(got[0].view(torch.int32),
                           kf[0].view(torch.int32)), label
    q_n, p = probes.shape
    live = int((probes < num_bins).sum())
    short = int((kf[1] < 0).any(dim=1).sum())
    del kf
    ms = cuda_ms(torch, lambda: cuda_binned.cuda_rank_merge(*args), reps=20)
    plain = cuda_ms(torch, lambda: cuda_binned.rank_merge_plain(*args), reps=3)
    bound = roofline.rank_merge_bound(q_n, p, live, top_k)
    log(f"kernel F vs plain, {label} (Q={q_n}, p={p} ranks, {live} live "
        f"(query, rank) pairs, k={top_k}): bit-identical, {short} queries "
        f"with < {top_k} results; {ms:.4f} ms vs {plain:.3f} ms; bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
        f"{bound['bytes']:.3g} bytes), {bound['bound_ms'] / ms:.1%} of it")
    return dict(queries=q_n, ranks=p, live_pairs=live, k=top_k,
                max_abs_err=0.0, ms=ms, plain_ms=plain,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def hold_kernel_a(torch, q, corpus, n, k, label, metric="sq_euclidean",
                  precision="highest", reps=5, atol=TOL):
    """Kernel A at one route (the corpus dtype and ``precision``) against
    its plain version on the same inputs: a repeat call bit-identical,
    tie-aware at rtol 0 and ``atol``; the kernel's and the plain
    version's times and the route's bound from these inputs. Returns the
    row for the ``kernels`` line."""
    from vers_tpu_torch.ops import cuda_topk
    from vers_tpu_torch.ops.topk import fused_scan_topk
    from vers_tpu_torch.utils import roofline
    from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

    def call():
        return cuda_topk.cuda_distance_topk(q, corpus, n, k, metric=metric,
                                            precision=precision)

    def plain_call():
        return fused_scan_topk(q, corpus, n, k, metric=metric,
                               precision=precision)

    ka, again = call(), call()
    assert torch.equal(ka[0], again[0]) and torch.equal(ka[1], again[1]), label
    pa = plain_call()
    assert_topk_match(ka[0], ka[1], pa[0], pa[1], rtol=0.0, atol=atol)
    err = max_abs_diff(ka[0], pa[0])
    del ka, again, pa
    ms = cuda_ms(torch, call, reps=reps)
    plain = cuda_ms(torch, plain_call, reps=1)
    q_n, d = q.shape
    plan = cuda_topk.plan_for(q, corpus, n, k, precision)
    smem, blocks = cuda_topk.card_plan(plan, d, k)
    assert smem == plan.smem_bytes, (plan, smem)
    route = cuda_topk.route_name(corpus.dtype, precision)
    bound = roofline.distance_topk_bound(q_n, n, d, k,
                                         corpus=route.split("/")[0],
                                         precision=precision)
    log(f"kernel A {route} vs plain on {label} (Q={q_n} over {n} rows, k={k}, "
        f"{metric}): max |d| {err:g}, {ms:.3f} ms vs {plain:.2f} ms; plan: "
        f"{plan.query_tile}-query tile, {plan.slots} slots, query parts "
        f"{'resident' if plan.resident else 'in registers'} ({plan.parts}), "
        f"{plan.smem_bytes} B shared, {blocks} block(s) an SM, "
        f"{plan.n_split} splits of {plan.split_rows} rows; bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), "
        f"{bound['bound_ms'] / ms:.0%} of it")
    return dict(q=q_n, rows=n, k=k, route=route, plan=plan.as_dict(),
                blocks_per_sm=blocks, n_split=plan.n_split,
                split_rows=plan.split_rows, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"])


def hold_route_scan(torch, args, label):
    """Kernel A's bf16 route at precision "default" on one captured
    routing scan (the bf16 layer-1 table, the queries as the scan passes
    them, cosine) by ``hold_kernel_a`` at atol 1e-5; beside it, timed in
    this run, the route the scan took before: 3xTF32 ("f32/highest")
    over an f32 copy of the same table. Returns the scan's row."""
    from vers_tpu_torch.ops import cuda_topk

    q_in, l1_tab, n1, k = args
    assert l1_tab.dtype == torch.bfloat16, l1_tab.dtype
    q_scan = q_in.float().contiguous()
    row = hold_kernel_a(torch, q_scan, l1_tab, n1, k, label, metric="cosine",
                        precision="default", atol=1e-5)
    l1_f32 = l1_tab.float()
    row["ms_3xtf32"] = cuda_ms(torch, lambda: cuda_topk.cuda_distance_topk(
        q_scan, l1_f32, n1, k, metric="cosine"), reps=5)
    del l1_f32
    log(f"  the same scan by 3xTF32 over an f32 copy of the table: "
        f"{row['ms_3xtf32']:.3f} ms")
    return row


@contextlib.contextmanager
def captured_beam_steps():
    """Record every step of the HNSW inline beam's kernel
    (``beam_inline.cuda_beam_step``, kernel E) that searches inside the
    block make, as (the state copied before the step, the step's other
    arguments); every call goes through unchanged, eagerly
    (``graphs.disabled``)."""
    from vers_tpu_torch import graphs
    from vers_tpu_torch.ops import beam_inline

    captured = []
    real = beam_inline.cuda_beam_step

    def capturing(state, *args):
        captured.append((tuple(t.clone() for t in state), args))
        return real(state, *args)

    beam_inline.cuda_beam_step = capturing
    try:
        with graphs.disabled():
            yield captured
    finally:
        beam_inline.cuda_beam_step = real


def step_candidates(torch, state, args):
    """From a step's state and arguments: the candidates the step reads
    (Q, e * deg) ids, -1 past the picks), which of them are live (not -1,
    not in the beam, at no lower column of the step: the kernel loads
    an inline block for these alone) and the picked rows' count (an
    adjacency row each)."""
    from vers_tpu_torch.ops.beam import (in_beam, pick_unexpanded,
                                         repeats_earlier, take_rows)

    beam_d, beam_i, expanded = state
    qp, adj, tab, ef, e, r, qn, vecs = args
    n_pad, deg = adj.shape
    picked, has, _ = pick_unexpanded(beam_d, beam_i, expanded.clone(), e)
    nbrs = take_rows(adj, picked.clamp(0, n_pad - 1)).long()
    nbrs = torch.where(has[:, :, None], nbrs, -1).reshape(picked.shape[0], -1)
    live = (nbrs >= 0) & ~(in_beam(nbrs, beam_i) | repeats_earlier(nbrs))
    return picked, nbrs, live, int(has.sum())


def refine_cut_gaps(torch, state, args, rows):
    """For the given query rows of a step: the gap, in f64, between the
    r-th and the (r+1)-th smallest projected distance of the live
    candidates (+inf where fewer than r + 1 are live), the cut where a
    different order of f32 sums can keep another candidate."""
    qp, adj, tab, ef, e, r, qn, vecs = args
    n_pad, deg = adj.shape
    dp = qp.shape[1]
    sub = tuple(t[rows] for t in state)
    picked, nbrs, live, _ = step_candidates(torch, sub, args)
    blocks = tab[picked.clamp(0, n_pad - 1)].view(len(rows), -1, dp).double()
    dots = torch.bmm(blocks, qp[rows].double()[:, :, None])[:, :, 0]
    nd = torch.where(live, 1.0 - dots, float("inf")).sort(dim=1).values
    if not 0 < r < nd.shape[1]:  # no refine cut
        return np.full(len(rows), np.inf)
    return (nd[:, r] - nd[:, r - 1]).cpu().numpy()


def hold_beam_step(torch, steps, label, reps=5):
    """Kernel E (the inline beam's step, ``csrc/beam_step.cu``) against
    its plain version (``beam_inline.plain_step``) on the steps of one
    captured search. Each step runs from its captured state by both: the
    active flags equal; where the ids agree, the expanded flags equal
    and the distances within 1e-6; a row whose ids differ passes where
    the kernel's ids at the differing positions carry their own exact
    full-dim distances (within 1e-5 of f64: the seeds' come from the
    routing scan) and either the distances
    at every differing position lie within 1e-6 (equal distances
    swapped, or at the beam's cut) or its projected
    distances tie within 1e-6 at the refine cut (another candidate
    kept); such rows are counted. Then the search's steps in a row from
    its first state, timed by both with CUDA events, and the bound of
    each step from the rows it loads (``roofline.beam_step_bound`` with
    the step's picked rows, live candidates and refined rows) beside
    the full-width bound. Returns the row for the ``kernels`` line."""
    from vers_tpu_torch.ops import beam_inline
    from vers_tpu_torch.utils import roofline

    tol = 1e-6
    qp, adj, tab, ef, e, r, qn, vecs = steps[0][1]
    q_n, dp = qp.shape
    n_pad, deg = adj.shape
    d = vecs.shape[1] if r else 0
    assert all(args[3:6] == (ef, e, r) for _, args in steps)

    def kernel(st):
        return beam_inline.cuda_beam_step(st, *steps[0][1])

    err, swapped, cut, bounds = 0.0, 0, 0, []
    loads = dict(picked=0, live=0, refined=0)
    for state, args in steps:
        got, got_active = beam_inline.cuda_beam_step(
            tuple(t.clone() for t in state), *args)
        want, want_active = beam_inline.plain_step(
            args[0], args[2], args[1], ef, e, r, args[6], args[7])(
            tuple(t.clone() for t in state))
        assert bool(got_active) == bool(want_active)
        same = got[1] == want[1]
        assert torch.equal(got[2][same], want[2][same])
        both = same & torch.isfinite(want[0])
        if both.any():
            err = max(err, float((got[0] - want[0])[both].abs().max()))
        rows = torch.nonzero(~same.all(dim=1))[:, 0]
        if len(rows):
            moved = ~same[rows]
            if r:  # the kernel's ids at moved positions carry their own
                #    exact full-dim distances
                i, j = torch.nonzero(moved, as_tuple=True)
                ids, dist = got[1][rows[i], j], got[0][rows[i], j]
                live = ids >= 0
                exact = 1.0 - (args[7][ids[live]].double()
                               * args[6][rows[i][live]].double()).sum(dim=1)
                assert ((exact - dist[live].double()).abs() <= 1e-5).all()
                assert not torch.isfinite(dist[~live]).any()
            dd = (got[0][rows] - want[0][rows]).abs().masked_fill(~moved, 0.0)
            tied = (dd <= tol).all(dim=1)
            swapped += int(tied.sum())
            other = rows[~tied]
            if len(other):
                gaps = refine_cut_gaps(torch, state, args, other)
                assert (gaps < tol).all(), (gaps, other.tolist())
                cut += len(other)
        picked, nbrs, live, n_picked = step_candidates(torch, state, args)
        n_live = live.sum(dim=1)
        n_refined = int(n_live.clamp(max=r).sum()) if r else 0
        counts = dict(picked=n_picked, live=int(n_live.sum()),
                      refined=n_refined)
        for k in loads:
            loads[k] += counts[k]
        bounds.append(roofline.beam_step_bound(q_n, ef, e, deg, dp, r, d,
                                               **counts))
    assert err <= tol, err

    def run(step, reps):
        times = []
        for _ in range(reps + 1):  # the first warms up
            st = tuple(t.clone() for t in steps[0][0])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in steps:
                st, _ = step(st)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / len(steps))
        return sorted(times[1:])[len(times[1:]) // 2]

    ms = run(kernel, reps)
    plain_ms = run(beam_inline.plain_step(qp, tab, adj, ef, e, r, qn, vecs), 1)
    n = len(steps)
    bound_ms = sum(b["bound_ms"] for b in bounds) / n
    full = roofline.beam_step_bound(q_n, ef, e, deg, dp, r, d)
    share = dict(picked=loads["picked"] / (n * q_n * e),
                 live=loads["live"] / (n * q_n * e * deg),
                 refined=loads["refined"] / (n * q_n * r) if r else 0.0)
    log(f"kernel E vs plain, {label} (Q={q_n}, ef={ef}, e={e}, deg={deg}, "
        f"dp={dp}, r={r}, d={d}; {n} steps): max |d| {err:g} where the ids "
        f"agree, {swapped} row-steps with equal distances swapped, {cut} "
        f"with another candidate kept at a refine-cut tie; {ms:.3f} ms a "
        f"step vs {plain_ms:.2f} ms; bound {bound_ms:.3f} ms a step from the "
        f"rows loaded ({share['picked']:.1%} of the full width's picks, "
        f"{share['live']:.1%} of its candidates, {share['refined']:.1%} of "
        f"its refined rows; {bounds[0]['bound_by']}), {full['bound_ms']:.3f} "
        f"ms at full width: {bound_ms / ms:.0%} / {full['bound_ms'] / ms:.0%} "
        f"of them")
    return dict(steps=n, max_abs_err=err, swapped_row_steps=swapped,
                refine_cut_row_steps=cut, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bounds[0]["bound_by"],
                full_width_bound_ms=full["bound_ms"],
                loaded_share_of_full_width=share,
                bound_ms_by_step=[b["bound_ms"] for b in bounds],
                shape=f"Q={q_n} ef={ef} e={e} deg={deg} dp={dp} r={r} d={d}")


def forest_phase(torch, vt, x, q, qd, truth_ids, dev):
    """Phase 5: the RP-forest end to end (see the module docstring).
    Returns (per-setting rows of the searches, rows of kernel B on the
    captured scans, kernel B's launches in the phase, the forest)."""
    import dataclasses

    from vers_tpu_torch.ops import binned, cuda_binned
    from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

    cuda_binned.LAUNCHES = 0
    t0 = time.perf_counter()
    forest = vt.ANNIndex.build_index(FOREST_TREES, FOREST_LEAF, x, np.arange(N))
    build_s = time.perf_counter() - t0
    assert forest.device == dev, forest.device
    assert forest._values.shape == (N, DIM)  # no bitwise duplicates
    sizes = [np.array([len(m) for m in t.members]) for t in forest._trees]
    assert all(s.sum() == N for s in sizes)  # every row in one leaf a tree
    sec = forest.build_seconds
    log(f"forest build, {FOREST_TREES} trees, max_node_size {FOREST_LEAF}: "
        f"{build_s:.2f} s = dedup {sec['dedup_host']:.2f} s (host) + trees "
        f"{sec['trees_device']:.2f} s (card) + level tables and member lists "
        f"{sec['tables_host']:.2f} s (host); leaves per tree "
        f"{[len(s) for s in sizes]}, largest leaf {max(s.max() for s in sizes)}, "
        f"leaves under {TOP_K} rows {sum(int((s < TOP_K).sum()) for s in sizes)}, "
        f"leaves frozen at {FOREST_LEAF} rows or more at the bottom level "
        f"{sum(int((s >= FOREST_LEAF).sum()) for s in sizes)}, "
        f"levels {forest._trees[0].split.shape[0]}")

    searches, b_rows = {}, {}
    first_last = (0, FOREST_TREES - 1)
    for probes in (None, 4, 1):
        name = "auto" if probes is None else str(probes)
        depth = forest._auto_probes(TOP_K) if probes is None else probes
        before = cuda_binned.LAUNCHES
        t0 = time.perf_counter()
        with binned.captured_scans(only=first_last) as calls:
            res = forest.search_batch(qd, TOP_K, probes)
        first_s = time.perf_counter() - t0  # with the device tables' set-up
        per_search = cuda_binned.LAUNCHES - before
        assert per_search == FOREST_TREES, per_search
        assert res.ids.shape == (N_QUERIES, TOP_K)
        assert np.array_equal(res.ids >= 0, np.isfinite(res.distances))
        assert (np.diff(res.distances, axis=1) >= 0).all()
        live = np.sort(np.where(res.ids >= 0, res.ids, -np.arange(1, TOP_K + 1)),
                       axis=1)
        assert (live[:, 1:] != live[:, :-1]).all()  # no id twice in a row
        short = int((res.ids < 0).any(axis=1).sum())
        rec = vt.recall_at_k(res.ids, truth_ids)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        times = sorted(cuda_ms(torch, lambda: forest.search_batch_device(
            qd, TOP_K, probes), reps=1) for _ in range(5))
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        units = [c[0][2].shape[0] * -(-c[1]["q_blk"] // cuda_binned.QUERY_TILE)
                 for c in calls]
        log(f"forest probes_per_tree={name} (depth {depth}): recall@10 "
            f"{rec:.4f}, median {times[2]:.2f} ms / {N_QUERIES} queries "
            f"(min {times[0]:.2f}, max {times[4]:.2f} of 5 calls) = "
            f"{N_QUERIES / times[2] * 1e3:.0f} qps; kernel B launches a search "
            f"{per_search}, plan units a launch {units} (PLAN_MAX "
            f"{cuda_binned.PLAN_MAX}); {short} queries with < {TOP_K} results; "
            f"a search allocates at most {peak_gb:.2f} GB (one tree's view is "
            f"{calls[0][0][4].numel() * 4 / 1e9:.2f} GB); first call "
            f"{first_s:.2f} s")
        assert rec >= FOREST_RECALL[probes], (name, rec)
        searches[name] = dict(depth=depth, recall=rec, ms_median=times[2],
                              ms_min=times[0], ms_max=times[4],
                              qps=N_QUERIES / times[2] * 1e3,
                              launches_per_search=per_search, plan_units=units,
                              peak_search_gb=peak_gb,
                              over_plan_max=[u > cuda_binned.PLAN_MAX
                                             for u in units])
        # comparisons do not count
        counted = cuda_binned.LAUNCHES, cuda_binned.LAUNCHES_SPLIT
        for tree, (args, kw) in zip(first_last, calls):
            b_rows[f"forest probes={name} tree {tree}"] = hold_kernel_b(
                torch, args, kw,
                f"forest scan, probes_per_tree={name}, tree {tree}",
                mirror=tree == 0, time_plain=tree == 0)
        cuda_binned.LAUNCHES, cuda_binned.LAUNCHES_SPLIT = counted
        del calls

    # the search as CUDA graphs against itself eagerly, with no host
    # synchronisation after a setting's first call, and chained
    for probes in (1, 4, None):
        name = "auto" if probes is None else str(probes)
        searches[name]["graphs"] = graph_reading(
            torch, f"forest probes_per_tree={name}",
            lambda: forest.search_batch_device(qd, TOP_K, probes),
            [forest._graphs])
    searches["no_host_sync"] = no_sync_reading(
        torch, "forest probes_per_tree=1, 4, auto",
        [lambda p=p: forest.search_batch_device(qd, TOP_K, p)
         for p in (1, 4, None)])
    searches["chained"] = chained_reading(
        torch, "forest probes_per_tree=1",
        lambda: forest.search_batch_device(qd, TOP_K, 1), N_QUERIES)

    # the descent on the card against the CPU's on the same tables: a
    # leaf hangs on the sign of a projection, so leaves must be equal
    # wherever every |projection| on the path exceeds TOL and no two
    # margins are that close (the flip order); the rest are counted
    from vers_tpu_torch.ops import rpforest

    sh = forest._shared
    names = ("coeffs", "consts", "cbase", "splits", "buckets")
    qs = qd[:FOREST_SLICE]
    on_card = rpforest.descend_forest_flat(
        qs, *(sh[k] for k in names), sh["offsets"], n_probes=4).cpu()
    host = [sh[k].cpu() for k in names]
    on_cpu = rpforest.descend_forest_flat(
        qs.cpu(), *host, sh["offsets"].cpu(), n_probes=4)
    _, margins = rpforest._descend_once_flat(
        qs.cpu(), *host, torch.arange(FOREST_TREES), None, want_margins=True)
    m = margins.sort(dim=2).values  # (T, Q, L), +inf last
    gaps = torch.where(torch.isfinite(m[:, :, 1:]), m[:, :, 1:] - m[:, :, :-1],
                       float("inf"))
    unsure = ((m[:, :, 0] < TOL) | (gaps.min(dim=2).values < TOL)).T
    differs = (on_card != on_cpu).reshape(FOREST_SLICE, FOREST_TREES, 4).any(dim=2)
    assert not bool((differs & ~unsure).any()), int((differs & ~unsure).sum())
    log(f"forest descent, card vs CPU, {FOREST_SLICE} queries x {FOREST_TREES} "
        f"trees x 4 probes: {int(differs.sum())} (query, tree) cells differ, all "
        f"among the {int(unsure.sum())} with a |projection| or a margin gap "
        f"under {TOL:g}")
    del host, margins, m, gaps

    # the whole search on the plain engine, on a slice of the queries
    for probes in (None, 1):
        got = forest.search_batch(qd[:FOREST_SLICE], TOP_K, probes)
        forest.config = dataclasses.replace(forest.config, engine="xla")
        try:
            before = cuda_binned.LAUNCHES
            want = forest.search_batch(qd[:FOREST_SLICE], TOP_K, probes)
            assert cuda_binned.LAUNCHES == before  # no kernel on this route
        finally:
            forest.config = dataclasses.replace(forest.config, engine="auto")
        assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                          rtol=0.0, atol=TOL)
        log(f"forest engine='xla' (plain) vs kernel engine, {FOREST_SLICE} "
            f"queries, probes_per_tree={probes}: equal up to ties, max |d| "
            f"{max_abs_diff(got.distances, want.distances):g}")

    for i in range(3):
        pairs = forest.search_approximate(q[i], TOP_K)
        ids = np.array([j for j, _ in pairs])
        dists = np.array([d for _, d in pairs])
        assert len(pairs) == TOP_K and len(set(ids)) == TOP_K
        assert (ids >= 0).all() and (ids < N).all() and (np.diff(dists) >= 0).all()
        direct = ((x[ids] - q[i][None, :]) ** 2).sum(axis=1)
        assert np.allclose(dists, direct, rtol=0.0, atol=TOL)
    log("forest search_approximate (the host deficit rule): 3 queries ok")

    # fill tree 0's largest leaf past max_node_size with near-copies of
    # one of its rows: the leaf splits, and a search finds the new rows
    tree = forest._trees[0]
    leaf = int(np.argmax(np.where(sizes[0] < FOREST_LEAF, sizes[0], 0)))
    seed_row = x[tree.members[leaf][0]]
    leaves_before, added = tree.num_buckets, []
    t0 = time.perf_counter()
    for i in range(1, 4 * FOREST_LEAF):
        # 3e-3 apart: squared distances of 9e-6 and up between them, above
        # the f32 cancellation error (~2e-7) of the distance form on unit rows
        v = seed_row * np.float32(1.0 + 3e-3 * i)
        if forest._descend_host_pos(tree, v)[0] != leaf:
            continue
        forest.add(v, N + len(added))
        added.append(v)
        if tree.num_buckets > leaves_before:
            break
    add_s = time.perf_counter() - t0
    assert tree.num_buckets > leaves_before and not forest._dirty_trees
    assert all(len(tree.members[tree.leaf_of_vec[N + i]]) < FOREST_LEAF
               for i in range(len(added)))
    t0 = time.perf_counter()
    found = forest.search_batch(np.stack(added), 1)
    assert list(found.ids[:, 0]) == list(range(N, N + len(added))), found.ids
    log(f"forest add: {len(added)} rows into a leaf of {sizes[0][leaf]} split "
        f"it ({leaves_before} -> {tree.num_buckets} leaves; {add_s:.2f} s); "
        f"every new row found as its own nearest ({time.perf_counter() - t0:.2f}"
        f" s with the device tables rebuilt)")

    path = ROOT / "vers_tpu_torch" / "_build" / "smoke_lsh.index"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        forest.save_index(str(path))
        size_mb = path.stat().st_size / 1e6
        loaded = vt.ANNIndex.load_index(str(path))
        assert loaded.device == dev, loaded.device
        io_s = time.perf_counter() - t0
    finally:
        path.unlink(missing_ok=True)
    a = forest.search_batch(qd, TOP_K, 1)
    b = loaded.search_batch(qd, TOP_K, 1)
    assert np.array_equal(a.ids, b.ids)
    rt_err = max_abs_diff(a.distances, b.distances)
    assert rt_err <= 1e-6, rt_err
    log(f"forest save/load round trip: identical ids, max |d distance| "
        f"{rt_err:g} ({io_s:.1f} s for {size_mb:.0f} MB)")
    return searches, b_rows, cuda_binned.LAUNCHES, forest


def hnsw_phase(torch, vt, x, q, qd, truth_ids, dev):
    """Phase 6: HNSW end to end (see the module docstring). Returns
    (rows of the readings, kernel A's row on the captured routing scan,
    kernel A's launches in the HNSW searches, the main reading's index
    with one row added, that corpus's queries on the card, and kernel
    E's row)."""
    import dataclasses

    from vers_tpu_torch.ops import beam_inline, cuda_topk
    from vers_tpu_torch.utils.data import synthetic_gaussian
    from vers_tpu_torch.utils.parity import assert_topk_match

    rows = {}

    def build(corpus, label, **options):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = vt.HNSWIndex.build_index_batched(*HNSW_ARGS, corpus, **options)
        build_s = time.perf_counter() - t0
        assert h.device == dev, h.device
        t0 = time.perf_counter()
        cache = h._ensure_device_cache()
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        sec = h.build_seconds
        layers = h.get_num_nodes_in_layers()
        assert layers[0] == corpus.shape[0]
        assert all(a >= b for a, b in zip(layers, layers[1:]))
        cap, dp = cache["policy"]
        assert cache["inline"] is not None and (cap, dp) == (32, 64), (cap, dp)
        log(f"hnsw build {HNSW_ARGS}{''.join(f', {k}={v}' for k, v in options.items())} "
            f"on {label}: {build_s:.2f} s = upload "
            f"{sec['upload_s']:.2f} s + {sec['waves']} waves of up to "
            f"{sec['wave_cap']} {sec['waves_s']:.2f} s (card, ending in a sync; "
            f"the host enqueues them meanwhile) + graph to the host "
            f"{sec['graph_to_host_s']:.2f} s; serving cache {cache_s:.2f} s (host "
            f"pack of the adjacency, PCA, the inline table); layers {layers}; "
            f"auto policy (cap, dp) = ({cap}, {dp}), inline beam on, layer-1 "
            f"routing table {cache['n1']} rows")
        return h, dict(build_s=build_s, upload_s=sec["upload_s"],
                       waves_s=sec["waves_s"], waves=sec["waves"],
                       graph_to_host_s=sec["graph_to_host_s"],
                       cache_s=cache_s, layers=layers, cap=cap, dp=dp,
                       n1=cache["n1"], options=options)

    def recall(h, queries, truth, ef=HNSW_EF):
        h.ef_search = ef
        res = h.search_batch(queries, TOP_K)
        h.ef_search = HNSW_EF
        assert res.ids.shape == (queries.shape[0], TOP_K)
        assert (res.ids >= 0).all() and np.isfinite(res.distances).all()
        assert (np.diff(res.distances, axis=1) >= 0).all()
        return vt.recall_at_k(res.ids, truth)

    # the JAX record's workload and its exact truth, made before the
    # counter is zeroed (the truth's own kernel-A launch is phase 1's kind)
    t0 = time.perf_counter()
    x2, q2 = synthetic_gaussian(N, DIM, n_clusters=HNSW_CLUSTERS,
                                n_queries=N_QUERIES, seed=0, normalized=True,
                                query_noise=0.5)
    qd2 = torch.from_numpy(q2).to(dev)
    flat2 = vt.FlatIndex(x2)
    truth2 = flat2.search_batch(qd2, TOP_K).ids
    del flat2
    torch.cuda.empty_cache()
    log(f"hnsw corpus of {HNSW_CLUSTERS} clusters and its exact truth "
        f"({time.perf_counter() - t0:.1f} s)")

    cuda_topk.LAUNCHES_BY_ROUTE.clear()
    beam_inline.LAUNCHES = beam_inline.LAUNCHES_PLAIN = 0

    # -- phase 1's corpus -------------------------------------------------
    h, rows["phase1_build"] = build(x, "phase 1's corpus")
    rec = recall(h, qd, truth_ids)
    log(f"hnsw phase-1 corpus: recall@10 {rec:.4f} at ef={HNSW_EF}")
    assert rec >= HNSW_RECALL_PHASE1, rec
    sweep = {HNSW_EF: rec}
    for ef in HNSW_EFS:
        if sweep[max(sweep)] >= TARGET_RECALL:
            break
        h.ef_search = ef
        sweep[ef] = recall(h, qd, truth_ids, ef)
        ms = cuda_ms(torch, lambda: h.search_batch_device(qd, TOP_K), reps=1)
        h.ef_search = HNSW_EF
        log(f"hnsw phase-1 corpus: recall@10 {sweep[ef]:.4f} at ef={ef}, "
            f"{ms:.2f} ms / {N_QUERIES} queries")
    ef_ok = max(sweep)
    assert sweep[ef_ok] >= TARGET_RECALL, sweep
    rows["phase1_recall_by_ef"] = sweep
    del h
    torch.cuda.empty_cache()

    # -- the JAX record's workload: the main reading ----------------------
    h, rows["build"] = build(x2, f"the {HNSW_CLUSTERS}-cluster corpus")
    with captured_route_scan() as captured:
        before = cuda_topk.launches()
        steps_before = beam_inline.LAUNCHES
        res = h.search_batch(qd2, TOP_K)
        assert cuda_topk.launches() == before + 1  # the routing scan
        assert beam_inline.LAUNCHES > steps_before  # kernel E, every step
        assert beam_inline.LAUNCHES_PLAIN == 0
    rec = vt.recall_at_k(res.ids, truth2)
    assert (np.diff(res.distances, axis=1) >= 0).all()
    direct = 1.0 - np.einsum("qkd,qd->qk", x2[res.ids[:4]], q2[:4])
    assert np.allclose(res.distances[:4], direct, rtol=0.0, atol=1e-5)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = sorted(cuda_ms(torch, lambda: h.search_batch_device(qd2, TOP_K),
                           reps=1) for _ in range(5))
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    log(f"hnsw search_batch ef={HNSW_EF} (inline beam): recall@10 {rec:.4f}, "
        f"median {times[2]:.2f} ms / {N_QUERIES} queries (min {times[0]:.2f}, "
        f"max {times[4]:.2f} of 5 calls) = {N_QUERIES / times[2] * 1e3:.0f} qps; "
        f"a search allocates at most {peak_gb:.2f} GB")
    assert rec >= TARGET_RECALL, rec
    rows["inline"] = dict(recall=rec, ms_median=times[2], ms_min=times[0],
                          ms_max=times[4], qps=N_QUERIES / times[2] * 1e3,
                          peak_search_gb=peak_gb)
    rows["inline"]["graphs"] = graph_reading(
        torch, "hnsw inline beam", lambda: h.search_batch_device(qd2, TOP_K),
        [h._graphs])

    # kernel E on the steps of one search at the benchmark cell's widths,
    # held outside the phase's counts (its plain version is called)
    h.ef_search = HNSW_E_EF
    with captured_beam_steps() as beam_steps:
        h.search_batch_device(qd2, TOP_K)
    h.ef_search = HNSW_EF
    qp, adj, _, ef, e, r, _, vecs = beam_steps[0][1]
    assert (ef, e, r, adj.shape[1], qp.shape[1], vecs.shape[1]) == (
        HNSW_E_EF, 4, 2 * HNSW_E_EF, 32, 64, DIM)
    counted = beam_inline.LAUNCHES, beam_inline.LAUNCHES_PLAIN
    e_row = hold_beam_step(torch, beam_steps,
                           f"the steps of a search at ef={HNSW_E_EF}")
    beam_inline.LAUNCHES, beam_inline.LAUNCHES_PLAIN = counted
    del beam_steps, qp, adj, vecs

    qs, ts = qd2[:HNSW_SLICE], truth2[:HNSW_SLICE]
    base = h.config
    for name, cfg in (("classic", dataclasses.replace(base, nav_inline_dp=None)),
                      ("beam_route", dataclasses.replace(base, route_mode="beam"))):
        h.config, h._device_cache = cfg, None
        before = cuda_topk.launches()
        rec_s = recall(h, qs, ts)
        scans = cuda_topk.launches() - before
        assert scans == (1 if name == "classic" else 0), (name, scans)
        assert h._device_cache["inline"] is None
        ms = cuda_ms(torch, lambda: h.search_batch_device(qs, TOP_K), reps=1)
        log(f"hnsw {name} on {HNSW_SLICE} queries: recall@10 {rec_s:.4f}, "
            f"{ms:.2f} ms ({HNSW_SLICE / ms * 1e3:.0f} qps); kernel A "
            f"launches {scans}")
        rows[name] = dict(queries=HNSW_SLICE, recall=rec_s, ms=ms)
    h.config, h._device_cache = base, None
    rows["inline_slice_recall"] = recall(h, qs, ts)

    # add one row on the device fast path; a search finds it first
    v = q2[11] * np.float32(1.0)
    t0 = time.perf_counter()
    h.add(v, N)
    add_s = time.perf_counter() - t0
    assert h._last_add_patch is not None and h._last_add_patch["row"] == N
    found = h.search_batch(v[None, :], 1)
    assert found.ids[0, 0] == N, found.ids
    log(f"hnsw add (device fast path): row {N} in {add_s * 1e3:.1f} ms, found "
        f"first by a search")

    rows["int8"] = int8_readings(torch, vt, h, qd2, truth2, q2)

    # -- the scan-routed and the inline-insertion builds, beside the -------
    # -- classic build of the same corpus in this run ----------------------
    classic_rec = rows["inline"]["recall"]
    for key, options in (("scan_build", dict(route_scan=True)),
                         ("inline_build", dict(insert_inline=True))):
        routes0 = dict(cuda_topk.LAUNCHES_BY_ROUTE)
        values0, plain0 = cuda_topk.LAUNCHES_VALUES, cuda_topk.LARGE_K_PLAIN
        with captured_build_scans() as scans:
            hb, row = build(x2, f"the {HNSW_CLUSTERS}-cluster corpus", **options)
        row["build_launches"] = {
            r: n - routes0.get(r, 0)
            for r, n in cuda_topk.LAUNCHES_BY_ROUTE.items()
            if n != routes0.get(r, 0)}
        row["build_launches_topk_values"] = cuda_topk.LAUNCHES_VALUES - values0
        assert cuda_topk.LARGE_K_PLAIN == plain0  # efc = 100 <= 128
        assert row["layers"] == rows["build"]["layers"], row["layers"]
        if key == "scan_build":
            # every upper-layer step and every layer-0 seed is a scan: k =
            # min(efc, rows of the layer's table), and k = 1 for the seeds
            assert set(row["build_launches"]) == {"bf16/default"}, row
            assert {1, HNSW_ARGS[1]} <= set(scans), sorted(scans)
            row["scan_ks"] = sorted(scans)
            build_scans = {k: scans[k] for k in (HNSW_ARGS[1], 1)}
        else:
            assert not row["build_launches"] and not scans, row
            row["inline_table_bytes"] = hb.build_seconds["inline_table_bytes"]
        row["recall"] = recall(hb, qd2, truth2)
        log(f"hnsw {key}: recall@10 {row['recall']:.4f} at ef={HNSW_EF} (the "
            f"classic build's {classic_rec:.4f}); build {row['build_s']:.2f} s "
            f"(classic {rows['build']['build_s']:.2f} s: waves "
            f"{row['waves_s']:.2f} vs {rows['build']['waves_s']:.2f} s); layers "
            f"as the classic build's; kernel launches in the build "
            f"{row['build_launches']} (+ {row['build_launches_topk_values']} of "
            f"kernel C)"
            + (f"; construction table {row['inline_table_bytes'] / 1e9:.3f} GB"
               if key == "inline_build" else ""))
        floor = (HNSW_SCAN_BUILD_RECALL if key == "scan_build"
                 else HNSW_INLINE_BUILD_RECALL)
        assert row["recall"] >= floor, (key, row["recall"])
        rows[key] = row
        del hb
        torch.cuda.empty_cache()

    # save/load round trip on a separate small index (the format does not
    # depend on size). The loaded index answers as the saved one up to
    # ties: an adjacency row's order comes from a set on either side,
    # and a heap's equal distances come back in reverse insertion order
    # (the reference port's quirk, the JAX package's too)
    small = vt.HNSWIndex.build_index_batched(*HNSW_ARGS, x2[:HNSW_IO_ROWS])
    path = ROOT / "vers_tpu_torch" / "_build" / "smoke_hnsw.index"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        small.save_index(str(path))
        size_mb = path.stat().st_size / 1e6
        loaded = vt.HNSWIndex.load_index(str(path))
        assert loaded.device == dev, loaded.device
        io_s = time.perf_counter() - t0
    finally:
        path.unlink(missing_ok=True)
    assert loaded.get_num_nodes_in_layers() == small.get_num_nodes_in_layers()
    assert np.array_equal(loaded._vecs[:HNSW_IO_ROWS], x2[:HNSW_IO_ROWS])
    a = small.search_batch(qd2[:HNSW_SLICE], TOP_K)
    b = loaded.search_batch(qd2[:HNSW_SLICE], TOP_K)
    assert_topk_match(b.distances, b.ids, a.distances, a.ids, rtol=0.0,
                      atol=1e-6)
    log(f"hnsw save/load round trip ({HNSW_IO_ROWS} rows, {size_mb:.1f} MB, "
        f"{io_s:.1f} s): same layers and vectors, results equal up to ties "
        f"({int((a.ids != b.ids).any(axis=1).sum())} of {HNSW_SLICE} rows "
        f"ordered otherwise)")
    launches = cuda_topk.launches()
    rows["launches_by_route"] = dict(cuda_topk.LAUNCHES_BY_ROUTE)
    assert rows["launches_by_route"] == {"bf16/default": launches}, \
        rows["launches_by_route"]
    # every inline beam step of the phase (the default policy) on kernel E
    e_row["launches_hnsw"] = beam_inline.LAUNCHES
    log(f"kernel E launches in the HNSW phase: {beam_inline.LAUNCHES}, "
        f"plain steps {beam_inline.LAUNCHES_PLAIN}")
    assert beam_inline.LAUNCHES > 0 and beam_inline.LAUNCHES_PLAIN == 0

    # kernel A on the captured routing scan against its plain version
    a_row = hold_route_scan(torch, captured[0], "the HNSW routing scan")
    a_row["share_of_search"] = a_row["ms"] / rows["inline"]["ms_median"]
    log(f"the routing scan is {a_row['share_of_search']:.1%} of the search's "
        f"median")
    # ... and on the scan-routed build's last upper-layer scan (k = efc)
    # and its last layer-0 seed scan (k = 1)
    for k, (q_in, tab, n_built) in build_scans.items():
        a_row[f"build_scan_k{k}"] = hold_kernel_a(
            torch, q_in, tab, n_built, k,
            f"the scan-routed build's last {'seed' if k == 1 else 'layer'} "
            f"scan", metric="cosine", precision="default")
    return rows, a_row, launches, h, qd2, e_row


@contextlib.contextmanager
def captured_build_scans():
    """Record, by k, the last scan of the scan-routed wave build
    (``ops/hnsw_build.scan_members``, kernel A) made inside the block, as
    (queries as the kernel takes them, member table, built rows); every
    call goes through unchanged, eagerly (``graphs.disabled``)."""
    from vers_tpu_torch import graphs
    from vers_tpu_torch.ops import hnsw_build

    captured = {}
    real = hnsw_build.scan_members

    def capturing(q, tab, tab_members, n_built, k, chunk):
        captured[k] = (q.float().contiguous().clone(), tab, n_built)
        return real(q, tab, tab_members, n_built, k, chunk)

    hnsw_build.scan_members = capturing
    try:
        with graphs.disabled():
            yield captured
    finally:
        hnsw_build.scan_members = real


def int8_readings(torch, vt, h, qd2, truth2, q2):
    """Phase 6's int8 navigation readings on the main index (see the
    module docstring), each beside the bf16 classic beam on the same
    queries in this run. Returns their rows."""
    import dataclasses

    base = h.config
    rows = {}
    for name, cfg in (("bf16_classic", dataclasses.replace(base,
                                                           nav_inline_dp=None)),
                      ("int8", dataclasses.replace(base, nav_dtype="int8",
                                                   nav_inline_dp=None))):
        h.config, h._device_cache = cfg, None
        cache = h._ensure_device_cache()
        assert cache["inline"] is None
        nav = cache["vecs_nav"]
        nav_bytes = nav.numel() * nav.element_size()
        if name == "int8":
            assert nav.dtype == torch.int8, nav.dtype
            nav_bytes += cache["nav_scales"].numel() * 4
        else:
            assert nav.dtype == torch.bfloat16 and cache["nav_scales"] is None
        res = h.search_batch(qd2, TOP_K)
        rec = vt.recall_at_k(res.ids, truth2)
        assert (res.ids >= 0).all() and np.isfinite(res.distances).all()
        assert (np.diff(res.distances, axis=1) >= 0).all()
        times = sorted(cuda_ms(torch, lambda: h.search_batch_device(qd2, TOP_K),
                               reps=1) for _ in range(5))
        rows[name] = dict(recall=rec, ms_median=times[2], ms_min=times[0],
                          ms_max=times[4], qps=N_QUERIES / times[2] * 1e3,
                          nav_bytes=nav_bytes)
        log(f"hnsw nav table {name}: {nav_bytes / 1e6:.1f} MB; recall@10 "
            f"{rec:.4f}, median {times[2]:.2f} ms / {N_QUERIES} queries (min "
            f"{times[0]:.2f}, max {times[4]:.2f} of 5 calls)")
        rows[name]["graphs"] = graph_reading(
            torch, f"hnsw {name} beam", lambda: h.search_batch_device(qd2, TOP_K),
            [h._graphs])
    assert rows["int8"]["recall"] >= HNSW_INT8_RECALL, rows

    # the beam route on the slice, and a device add, on the int8 cache
    qs, ts = qd2[:HNSW_SLICE], truth2[:HNSW_SLICE]
    h.config, h._device_cache = dataclasses.replace(h.config,
                                                    route_mode="beam"), None
    rec = vt.recall_at_k(h.search_batch(qs, TOP_K).ids, ts)
    ms = cuda_ms(torch, lambda: h.search_batch_device(qs, TOP_K), reps=1)
    assert h._device_cache["vecs_nav"].dtype == torch.int8
    log(f"hnsw int8 beam route on {HNSW_SLICE} queries: recall@10 {rec:.4f}, "
        f"{ms:.2f} ms")
    rows["int8_beam_route"] = dict(queries=HNSW_SLICE, recall=rec, ms=ms)
    row = h._rows_used
    v = q2[12] * np.float32(1.0)
    h.add(v, row)
    assert h._last_add_patch is not None and h._last_add_patch["row"] == row
    assert h._device_cache["nav_scales"][row] > 0
    found = h.search_batch(v[None, :], 1)
    assert found.ids[0, 0] == row, found.ids
    log(f"hnsw int8 add (device fast path): row {row} found first by a search")

    # with the inline table on, int8 quietly becomes bf16
    h.config, h._device_cache = dataclasses.replace(base, nav_dtype="int8"), None
    cache = h._ensure_device_cache()
    assert cache["inline"] is not None and cache["nav_scales"] is None
    assert cache["vecs_nav"].dtype == torch.bfloat16, cache["vecs_nav"].dtype
    h.config, h._device_cache = base, None
    return rows


def bf16_phase(torch, vt, x, qd, truth, xd):
    """Phase 8 (see the module docstring): the path's own calls with the
    counters of kernels A (by route), C and D zeroed just before and read
    just after, then the held readings. Returns (rows of the readings,
    kernel A's rows by route for the ``kernels`` line, the path's
    launches)."""
    import io

    from vers_tpu_torch import demo, native
    from vers_tpu_torch.index.hnsw import HNSWIndex
    from vers_tpu_torch.ops import cuda_binned, cuda_bucket, cuda_topk
    from vers_tpu_torch.utils.data import (
        ROYAL_WORDS,
        load_vec_file,
        parse_vec_python,
    )

    dev = qd.device
    rows = {}
    cuda_topk.LAUNCHES_VALUES = 0
    cuda_topk.LAUNCHES_BY_ROUTE.clear()
    cuda_binned.LAUNCHES = cuda_bucket.LAUNCHES = 0

    # -- the bf16 flat store: exact, then bucket + rescore ---------------
    flat = vt.FlatIndex(x, config=vt.FlatConfig(dtype="bfloat16"))
    assert flat.device == dev, flat.device
    store = flat._store.data
    assert store.dtype == torch.bfloat16 and store.is_contiguous()
    bf16_mb = store.numel() * store.element_size() / 1e6
    f32_mb = xd.numel() * xd.element_size() / 1e6
    res = flat.search_batch(qd, TOP_K)
    assert res.ids.shape == (N_QUERIES, TOP_K) and (res.ids >= 0).all()
    assert np.isfinite(res.distances).all()
    rec = vt.recall_at_k(res.ids, truth.ids)
    ms = cuda_ms(torch, lambda: flat.search_batch_device(qd, TOP_K), reps=2)
    log(f"bf16 flat store: {bf16_mb:.1f} MB beside the f32 store's "
        f"{f32_mb:.1f} MB; exact engine recall@10 {rec:.4f} against phase 1's "
        f"f32 truth, {ms:.2f} ms / {N_QUERIES} queries = "
        f"{N_QUERIES / ms * 1e3:.0f} qps")
    assert rec >= BF16_EXACT_RECALL, rec
    rows["exact"] = dict(store_mb=bf16_mb, f32_store_mb=f32_mb, recall=rec,
                         ms=ms, qps=N_QUERIES / ms * 1e3)
    bidx = vt.FlatIndex(x, config=vt.FlatConfig(
        dtype="bfloat16", engine="bucket", bucket_rescore=True))
    bres = bidx.search_batch(qd, TOP_K)
    assert (bres.ids >= 0).all() and np.isfinite(bres.distances).all()
    brec = vt.recall_at_k(bres.ids, truth.ids)
    bms = cuda_ms(torch, lambda: bidx.search_batch_device(qd, TOP_K), reps=2)
    log(f"bf16 flat store, bucket + rescore: recall@10 {brec:.4f}, {bms:.2f} "
        f"ms / {N_QUERIES} queries")
    assert brec >= BF16_BUCKET_RECALL, brec
    rows["bucket_rescore"] = dict(recall=brec, ms=bms)
    del bidx, bres
    torch.cuda.empty_cache()

    # -- distance_topk at "default" and "high": the f32 corpus and the --
    # -- bf16 store ------------------------------------------------------
    corpora = {"f32": xd, "bf16": store}
    settings = [(c, p, qn) for c in corpora for p in ("default", "high")
                for qn in A8_QUERIES]
    for c, p, qn in settings:
        d, i = cuda_topk.distance_topk(qd[:qn], corpora[c], N, TOP_K,
                                       precision=p)
        assert (i >= 0).all() and bool(torch.isfinite(d).all()), (c, p, qn)

    # -- the README flow and the demo, on the card -----------------------
    emb = vt.load_wiki()  # no file here: the synthetic royal-words corpus
    t0 = time.perf_counter()
    readme = vt.HNSW(ef_construction=100, num_layers=8, ef_search=32,
                     num_neighbours=8)
    readme.build_index(emb)
    build_s = time.perf_counter() - t0
    assert readme.index.device == dev, readme.index.device
    found = readme.search(emb.get("queen"), top_k=TOP_K)
    log(f"README flow: load_wiki() ({len(emb)} x {emb.vectors.shape[1]}), "
        f"HNSW(100, 8, 32, 8) built on the card in {build_s:.2f} s; the "
        f"queen's neighbours: {', '.join(f'{w} {d:.4f}' for w, d in found)}")
    words = [w for w, _ in found]
    assert words[0] == "queen" and len(set(words) & set(ROYAL_WORDS)) >= 5
    rows["readme"] = dict(build_s=build_s, neighbours=found)
    del readme
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        demo_res = demo.main(["--index", "ivfflat"])
    for line in out.getvalue().splitlines():
        log(f"  demo: {line}")
    assert f"on {dev}" in out.getvalue(), out.getvalue()
    words = [w for w, _ in demo_res]
    assert words[0] == "queen" and len(set(words) & set(ROYAL_WORDS)) >= 5
    rows["demo_ivfflat"] = [w for w, _ in demo_res]

    launches = dict(routes=dict(cuda_topk.LAUNCHES_BY_ROUTE),
                    topk_values=cuda_topk.LAUNCHES_VALUES,
                    bucket_scan=cuda_bucket.LAUNCHES,
                    packed_scan=cuda_binned.LAUNCHES)
    log(f"kernel launches in phase 8: {launches}")
    for route in ("bf16/highest", "bf16/default", "bf16/high", "f32/default",
                  "f32/high"):
        assert launches["routes"].get(route, 0) > 0, (route, launches)
    # the demo's harness searches on the host (search_approximate): no
    # kernel B there
    assert launches["topk_values"] > 0 and launches["bucket_scan"] > 0, launches

    # -- kernel A's routes against their plain versions ------------------
    def hold(c, p, qn):
        return hold_kernel_a(torch, qd[:qn], corpora[c], N, TOP_K,
                             f"phase 8's {c} corpus", precision=p,
                             reps=2 if qn >= N_QUERIES else 5)

    a_rows = {"bf16/highest": {qn: hold("bf16", "highest", qn)
                               for qn in A8_QUERIES}}
    for c, p, qn in settings:
        a_rows.setdefault(f"{c}/{p}", {})[qn] = hold(c, p, qn)
    del flat, store, corpora
    torch.cuda.empty_cache()

    # -- the native IO against the Python readers ------------------------
    assert native.available(), "the native IO library did not build"
    io_dir = ROOT / "vers_tpu_torch" / "_build"
    vec_path, idx_path = io_dir / "smoke_native.vec", io_dir / "smoke_native.index"
    try:
        # the text write_vec_file writes (4 decimals), a row per format
        words = [f"w{j}" for j in range(NATIVE_ROWS)]
        t0 = time.perf_counter()
        fmt = " ".join(["%.4f"] * DIM)
        with open(vec_path, "w", encoding="utf-8") as fp:
            fp.write(f"{NATIVE_ROWS} {DIM}\n")
            fp.writelines(f"{w} {fmt % tuple(r)}\n" for w, r in
                          zip(words, x[:NATIVE_ROWS].tolist()))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nw, ne = load_vec_file(str(vec_path), DIM)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pw, pe = parse_vec_python(str(vec_path), DIM)
        python_s = time.perf_counter() - t0
        assert nw == pw == words and np.array_equal(ne, pe), "vec readers differ"
        assert np.allclose(ne, x[:NATIVE_ROWS], rtol=0.0, atol=6e-5)
        log(f"native .vec parser, {NATIVE_ROWS} x {DIM} "
            f"({vec_path.stat().st_size / 1e6:.0f} MB, written in "
            f"{write_s:.1f} s): equal to the Python reader; {native_s:.2f} s "
            f"vs {python_s:.2f} s")
        rows["vec"] = dict(rows=NATIVE_ROWS, native_s=native_s,
                           python_s=python_s)
        t0 = time.perf_counter()
        h = HNSWIndex.build_index_batched(*NATIVE_HNSW_ARGS, x[:NATIVE_ROWS])
        torch.cuda.synchronize()
        hb_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h.save_index(str(idx_path))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        a = HNSWIndex.load_index(str(idx_path))
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = HNSWIndex._load_index_python(str(idx_path), DIM)
        python_s = time.perf_counter() - t0
        assert a.device == b.device == dev
        assert a.get_num_nodes_in_layers() == b.get_num_nodes_in_layers() == \
            h.get_num_nodes_in_layers()
        for la, lb in zip(a.layers, b.layers):
            assert la.adjacency.keys() == lb.adjacency.keys()
            assert all(la.adjacency[n].neighbours == lb.adjacency[n].neighbours
                       for n in lb.adjacency)
        assert a._id_row == b._id_row
        assert np.array_equal(a._vecs[: a._rows_used], b._vecs[: b._rows_used])
        ra = a.search_batch(qd[:HNSW_SLICE], TOP_K)
        rb = b.search_batch(qd[:HNSW_SLICE], TOP_K)
        assert np.array_equal(ra.ids, rb.ids)
        assert np.array_equal(ra.distances, rb.distances)
        log(f"native HNSW scanner, {NATIVE_ROWS}-row index "
            f"{NATIVE_HNSW_ARGS} ({idx_path.stat().st_size / 1e6:.0f} MB; "
            f"built {hb_s:.1f} s, saved {save_s:.1f} s): the same layers, "
            f"vectors and searches as the Python reader; {native_s:.2f} s vs "
            f"{python_s:.2f} s")
        rows["hnsw_file"] = dict(rows=NATIVE_ROWS, native_s=native_s,
                                 python_s=python_s, save_s=save_s)
        del h, a, b
    finally:
        vec_path.unlink(missing_ok=True)
        idx_path.unlink(missing_ok=True)
    return rows, a_rows, launches


@contextlib.contextmanager
def shard_intervals(torch, in_turn=False):
    """Time each shard's body: ``map_shards`` is patched where
    ``vers_tpu_torch.parallel`` calls it so that two timing events on the
    body's own stream bracket it, kept in the yielded list as (start,
    end). With ``in_turn`` the bodies run one after another on the
    caller's thread and its current stream, as the shards ran before they
    had an executor (the readings' yardstick; the package has no such
    mode)."""
    import threading

    from vers_tpu_torch.parallel import (
        hnsw, hnsw_partitioned, ivf, kmeans, lsh, lsh_partitioned, mesh, search)

    sites = (search, kmeans, ivf, lsh, lsh_partitioned, hnsw, hnsw_partitioned)
    real = mesh.map_shards
    intervals, lock = [], threading.Lock()

    def bracketed(body):
        def run(s, dev, *args):
            stream = torch.cuda.current_stream(dev)
            start = stream.record_event(torch.cuda.Event(enable_timing=True))
            out = body(s, dev, *args)
            end = stream.record_event(torch.cuda.Event(enable_timing=True))
            with lock:
                intervals.append((start, end))
            return out
        return run

    def patched(m, body, *per_shard):
        if not in_turn:
            return real(m, bracketed(body), *per_shard)
        out = []
        for s, dev in enumerate(m.devices):
            with torch.cuda.device(dev):
                out.append(bracketed(body)(s, dev, *(a[s] for a in per_shard)))
        return out

    for site in sites:
        site.map_shards = patched
    try:
        yield intervals
    finally:
        for site in sites:
            site.map_shards = real


def shard_readings(torch, settings, reps=5):
    """Time each of ``settings`` (name -> (fn, in_turn), ``fn`` a search,
    ``in_turn`` as ``shard_intervals`` takes it) with CUDA events on the
    caller's stream: two warm-up calls each (a search's first call runs
    eagerly, its second captures its graphs), then ``reps`` calls each, the
    settings interleaved call by call, so that a drift of the host's
    speed falls on all of them alike. Returns name -> (sorted ms, the
    median call's overlap: the shards' stream intervals summed over its
    wall)."""
    calls = {name: [] for name in settings}
    for rep in range(reps + 2):
        for name, (fn, in_turn) in settings.items():
            with shard_intervals(torch, in_turn) as intervals:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
            wall = start.elapsed_time(end)
            if rep > 1:
                calls[name].append(
                    (wall, sum(a.elapsed_time(b) for a, b in intervals) / wall))
    out = {}
    for name, c in calls.items():
        c.sort()
        out[name] = ([w for w, _ in c], c[reps // 2][1])
    return out


def plain_reading(torch, fn, reps=5):
    """``fn`` after two warm-up calls, ``reps`` calls timed with CUDA
    events: sorted ms."""
    return shard_readings(torch, {"fn": (fn, False)}, reps)["fn"][0]


def compare_shards(torch, label, fn, twin=None, reps=5):
    """``fn`` (a sharded search) with its shards at once and in turn,
    beside ``twin`` (the single-device search, when there is one), the
    three interleaved: medians and spreads of ``reps`` calls and the
    shards' overlap. Returns the row."""
    settings = {"at once": (fn, False), "in turn": (fn, True)}
    if twin is not None:
        settings["single"] = (twin, False)
    got = shard_readings(torch, settings, reps)
    (ms, overlap), (turn, turn_overlap) = got["at once"], got["in turn"]
    single = got["single"][0] if twin is not None else None
    mid = reps // 2
    log(f"{label}: median {ms[mid]:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f} "
        f"of {reps}) with the shards at once, overlap {overlap:.2f}; in turn "
        f"{turn[mid]:.2f} ms ({turn[0]:.2f}-{turn[-1]:.2f}), overlap "
        f"{turn_overlap:.2f}; "
        + (f"single device {single[mid]:.2f} ms ({single[0]:.2f}-{single[-1]:.2f})"
           if single else "no single-device twin in this run"))
    return dict(ms=ms[mid], ms_min=ms[0], ms_max=ms[-1], overlap=overlap,
                in_turn_ms=turn[mid], in_turn_min=turn[0], in_turn_max=turn[-1],
                in_turn_overlap=turn_overlap,
                single_ms=single[mid] if single else None,
                single_min=single[0] if single else None,
                single_max=single[-1] if single else None)


def parallel_phase(torch, vt, x, qd, truth, dev, flat, ivf, forest, h, qd2,
                   cards=None):
    """Phase 7: the multi-device layer (``vers_tpu_torch.parallel``) on a
    mesh of PARALLEL_SHARDS shards on the one card, over the corpora,
    truths and indexes of the earlier phases (see the module docstring);
    with ``cards`` (a mesh of one shard a card), every class again over
    that mesh. The caller zeroes the launch counters before and reads
    them after. Returns (rows of the readings, the kernel inputs captured
    from the phase's searches for ``hold_shard_kernels``), which the
    caller holds after reading the counts."""
    import dataclasses

    from vers_tpu_torch import parallel
    from vers_tpu_torch.ops import binned, cuda_binned, cuda_topk
    from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

    S = PARALLEL_SHARDS
    mesh = parallel.make_mesh(S, device="cuda:0")
    assert mesh.devices == (dev,) * S, mesh
    rows, held = {"cards": {}}, {}
    on_cards = rows["cards"]
    if cards is None:
        log(f"multi-card part: not run ({torch.cuda.device_count()} card; it "
            f"needs two or more)")
    else:
        log(f"multi-card part: every class also over {cards}")

    def same(got, want):
        assert_topk_match(got.distances, got.ids, want.distances, want.ids,
                          rtol=0.0, atol=TOL)

    # -- ShardedFlatIndex: phase 1's exact search, sharded ------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sf = parallel.ShardedFlatIndex(x, mesh=mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    before = cuda_topk.launches()
    res = sf.search_batch(qd, TOP_K)
    assert cuda_topk.launches() == before + S, cuda_topk.launches() - before
    same(res, truth)
    err = max_abs_diff(res.distances, truth.distances)
    log(f"sharded flat, {S} shards of {sf._counts.tolist()} rows ({sf._per} with "
        f"headroom; placed in {place_s:.2f} s): equal to phase 1's exact search "
        f"up to ties, max |d| {err:g}; kernel A launches a search {S}")
    rows["flat"] = dict(shard_rows=sf._counts.tolist(), per=sf._per,
                        place_s=place_s, max_abs_err=err, **compare_shards(
                            torch, f"sharded flat, {N_QUERIES} queries",
                            lambda: sf.search_batch_device(qd, TOP_K),
                            lambda: flat.search_batch_device(qd, TOP_K)))
    held["a_shard"] = (sf._data[0], int(sf._counts[0]))
    del sf
    if cards is not None:
        cf = parallel.ShardedFlatIndex(x, mesh=cards)
        same(cf.search_batch(qd, TOP_K), truth)
        on_cards["flat"] = compare_shards(
            torch, f"sharded flat over {cards.size} cards",
            lambda: cf.search_batch_device(qd, TOP_K))
        # the merge's gather: one peer copy a card
        parts = cf._search_batch_rows(qd, TOP_K)
        pieces = [parts[0].to(d) for d in cards.devices]
        gather = plain_reading(torch,
                               lambda: parallel.mesh.all_gather(pieces, 1))
        peer = [torch.cuda.can_device_access_peer(d.index, dev.index)
                for d in cards.devices[1:]]
        log(f"all_gather of {cards.size} ({N_QUERIES}, {TOP_K}) f32 parts to "
            f"the lead: median {gather[2]:.3f} ms; peer access to the lead "
            f"{peer}")
        on_cards["flat"].update(all_gather_ms=gather[2], peer_access=peer)
        del cf, parts, pieces
        torch.cuda.empty_cache()

    # -- ShardedIVFFlatIndex from phase 2's centroids ---------------------
    values = ivf._values  # phase 4 added a row: N + 1 rows

    def sharded_ivf(m):
        bl = np.array_split(np.arange(values.shape[0]), m.size)
        return parallel.ShardedIVFFlatIndex(
            K_CLUSTERS, ivf._centroids, [values[b[0] : b[-1] + 1] for b in bl],
            bl, mesh=m)

    sivf = sharded_ivf(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sivf._ensure_state()
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    bins = np.concatenate(sivf._state["bins"])
    # the bins are the JAX package's numpy difference form, bit for bit:
    # held to numpy on every row phase 2's matmul form bins otherwise and
    # on a sample of the rest
    moved = np.flatnonzero(bins != ivf._assignments)
    sample = np.random.default_rng(7).choice(values.shape[0], 512, replace=False)
    check = np.union1d(moved, sample)
    rows_c = values[check]
    want = np.argmin(np.stack([((rows_c - c[None, :]) ** 2).sum(-1)
                               for c in ivf._centroids], axis=1), axis=1)
    assert np.array_equal(bins[check], want), int((bins[check] != want).sum())
    # the single-device reference of the same bins: phase 2's own index
    # when no row moved
    if moved.size:
        order = np.argsort(bins, kind="stable")
        members = np.split(order, np.cumsum(np.bincount(
            bins, minlength=K_CLUSTERS))[:-1])
        ref = vt.IVFFlatIndex(K_CLUSTERS, values, ivf._centroids, bins,
                              [m.tolist() for m in members])
    else:
        ref = ivf
    log(f"sharded ivf bins: {moved.size} rows binned otherwise than phase 2's "
        f"matmul form; those and {sample.size} sampled rows equal to numpy's "
        f"difference form ({check.size} rows held); the reference is "
        f"{'a single-device index of these bins' if moved.size else 'phase 2'}")
    rows["ivf"] = dict(state_s=state_s, rows_binned_otherwise=int(moved.size),
                       rows_held_to_numpy=int(check.size))
    civf = sharded_ivf(cards) if cards is not None else None
    for nprobe in (1, 2):
        before = cuda_binned.LAUNCHES
        with binned.captured_scans(only=(0,), shard=0) as calls:
            got = sivf.search_batch(qd, TOP_K, nprobe=nprobe)
        assert cuda_binned.LAUNCHES == before + S, cuda_binned.LAUNCHES - before
        if nprobe == 2:
            held["b_ivf"] = calls[0]
        del calls
        want = ref.search_batch(qd, TOP_K, nprobe=nprobe)
        same(got, want)
        log(f"sharded ivf from phase 2's centroids, nprobe={nprobe}: equal to "
            f"the single-device search up to ties; kernel B launches a search "
            f"{S}; shard bins and layouts {state_s:.2f} s")
        rows["ivf"][f"nprobe{nprobe}"] = compare_shards(
            torch, f"sharded ivf, nprobe={nprobe}",
            lambda: sivf._search_batch_rows(qd, TOP_K, nprobe),
            lambda: ref.search_batch_device(qd, TOP_K, nprobe))
        if nprobe == 2:
            rows["ivf"]["nprobe2"]["graphs"] = graph_reading(
                torch, "sharded ivf, nprobe=2",
                lambda: sivf._search_batch_rows(qd, TOP_K, 2), sivf._graphs)
        if civf is not None:
            same(civf.search_batch(qd, TOP_K, nprobe=nprobe), want)
            on_cards[f"ivf_nprobe{nprobe}"] = compare_shards(
                torch, f"sharded ivf over {cards.size} cards, nprobe={nprobe}",
                lambda: civf._search_batch_rows(qd, TOP_K, nprobe))
    del sivf, ref, civf
    torch.cuda.empty_cache()

    def kmeans_build(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = parallel.ShardedIVFFlatIndex.build_index(K_CLUSTERS, 2, 10, x,
                                                         mesh=m)
        torch.cuda.synchronize()
        return built, time.perf_counter() - t0

    built, build_s = kmeans_build(mesh)
    res = built.search_batch(qd, TOP_K, nprobe=2)
    rec = vt.recall_at_k(res.ids, truth.ids)
    log(f"sharded ivf build_index({K_CLUSTERS}, 2, 10) by the sharded k-means: "
        f"{build_s:.2f} s; recall@10 {rec:.4f} at nprobe 2")
    assert rec >= TARGET_RECALL, rec
    rows["ivf"]["build"] = dict(build_s=build_s, recall_nprobe2=rec)
    centroids = built._centroids
    del built
    torch.cuda.empty_cache()
    if cards is not None:
        cbuilt, cbuild_s = kmeans_build(cards)
        # the sums' order within a shard is the atomics' (index_add_), so
        # the builds agree to rounding, not bit for bit
        delta = float(np.abs(cbuilt._centroids - centroids).max())
        crec = vt.recall_at_k(cbuilt.search_batch(qd, TOP_K, nprobe=2).ids,
                              truth.ids)
        log(f"sharded k-means build over {cards.size} cards: {cbuild_s:.2f} s "
            f"(one card: {build_s:.2f}); centroids within {delta:g} of the "
            f"one-card build's; recall@10 {crec:.4f} at nprobe 2")
        assert crec >= TARGET_RECALL, crec
        on_cards["kmeans_build"] = dict(build_s=cbuild_s, max_abs_delta=delta,
                                        recall_nprobe2=crec)
        del cbuilt
        torch.cuda.empty_cache()

    # -- ShardedANNIndex over phase 5's forest ------------------------------
    sa = parallel.ShardedANNIndex(forest, mesh=mesh)
    ca = None if cards is None else parallel.ShardedANNIndex(forest, mesh=cards)
    rows["forest"] = {}
    for probes in (1, 4):
        before = cuda_binned.LAUNCHES
        # query shard 0's first-tree scan, for hold_shard_kernels
        with binned.captured_scans(only=(0,) if probes == 4 else (),
                                   shard=0) as calls:
            got = sa.search_batch(qd, TOP_K, probes)
        if probes == 4:
            held["b_sharded_forest"] = calls[0]
        del calls
        per_search = cuda_binned.LAUNCHES - before
        assert per_search == S * FOREST_TREES, per_search
        want = forest.search_batch(qd, TOP_K, probes)
        same(got, want)
        log(f"sharded forest, probes_per_tree={probes}: equal to phase 5's "
            f"search up to ties; kernel B launches a search {per_search}")
        rows["forest"][str(probes)] = dict(
            launches_per_search=per_search, **compare_shards(
                torch, f"sharded forest, probes_per_tree={probes}",
                lambda: sa._search_batch_rows(qd, TOP_K, probes),
                lambda: forest.search_batch_device(qd, TOP_K, probes)))
        if probes == 1:
            rows["forest"]["1"]["graphs"] = graph_reading(
                torch, "sharded forest, probes_per_tree=1",
                lambda: sa._search_batch_rows(qd, TOP_K, 1), sa._graphs)
        if ca is not None:
            same(ca.search_batch(qd, TOP_K, probes), want)
            on_cards[f"forest_{probes}"] = compare_shards(
                torch, f"sharded forest over {cards.size} cards, "
                f"probes_per_tree={probes}",
                lambda: ca._search_batch_rows(qd, TOP_K, probes))
    del sa, ca
    torch.cuda.empty_cache()

    # -- ShardedHNSWIndex over phase 6's index (the beam route) -------------
    h.config, h._device_cache = dataclasses.replace(h.config,
                                                    route_mode="beam"), None
    beam_cfg = h.config
    qs = qd2[:HNSW_SLICE]
    sh = parallel.ShardedHNSWIndex(h, mesh=mesh)
    ch = parallel.ShardedHNSWIndex(h, mesh=cards) if cards is not None else None
    for name, cfg, label in (
            ("hnsw", beam_cfg, "its route_mode='beam' search"),
            ("hnsw_int8", dataclasses.replace(beam_cfg, nav_dtype="int8",
                                              nav_inline_dp=None),
             "its single-device int8 search")):
        h.config, h._device_cache = cfg, None
        before = cuda_topk.launches()
        want = h.search_batch(qs, TOP_K)
        got = sh.search_batch(qs, TOP_K)
        assert cuda_topk.launches() == before  # the beam route runs no scan
        if name == "hnsw_int8":
            assert h._device_cache["vecs_nav"].dtype == torch.int8
        same(got, want)
        log(f"sharded hnsw over phase 6's index ({name}), {HNSW_SLICE} "
            f"queries: equal to {label} up to ties")
        rows[name] = dict(queries=HNSW_SLICE, **compare_shards(
            torch, f"sharded hnsw ({name}), {HNSW_SLICE} queries",
            lambda: sh._search_batch_rows(qs, TOP_K),
            lambda: h.search_batch_device(qs, TOP_K)))
        if name == "hnsw":
            rows[name]["graphs"] = graph_reading(
                torch, f"sharded hnsw ({name}), {HNSW_SLICE} queries",
                lambda: sh._search_batch_rows(qs, TOP_K), sh._graphs)
        if ch is not None:
            same(ch.search_batch(qs, TOP_K), want)
            on_cards[name] = compare_shards(
                torch, f"sharded hnsw ({name}) over {cards.size} cards",
                lambda: ch._search_batch_rows(qs, TOP_K))
    h.config = beam_cfg
    del sh, ch
    h._device_cache = None
    torch.cuda.empty_cache()

    # -- PartitionedANNIndex: one forest a shard ----------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pa = parallel.PartitionedANNIndex.build_index(FOREST_TREES, FOREST_LEAF, x,
                                                  mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rows["part_forest"] = dict(build_s=build_s)
    # the same forests, one a card
    cpa = None if cards is None or cards.size != S else \
        parallel.PartitionedANNIndex(
            [vt.ANNIndex.from_numpy(FOREST_LEAF, s._trees, s._values, s._ids,
                                    device=d)
             for s, d in zip(pa.shards, cards.devices)], gids=pa.gids,
            mesh=cards)
    if cards is not None and cpa is None:
        log(f"partitioned forest and hnsw over {cards.size} cards: not run "
            f"(their one-card twins have {S} shards)")
    for probes in (None, 1):
        before = cuda_binned.LAUNCHES
        # shard 0's first-tree scan, for hold_shard_kernels
        with binned.captured_scans(only=(0,) if probes is None else (),
                                   shard=0) as calls:
            res = pa.search_batch(qd, TOP_K, probes_per_tree=probes)
        if probes is None:
            held["b_part_forest"] = calls[0]
        del calls
        per_search = cuda_binned.LAUNCHES - before
        assert per_search == S * FOREST_TREES, per_search
        rec = vt.recall_at_k(res.ids, truth.ids)
        name = "auto" if probes is None else str(probes)
        log(f"partitioned forest build_index({FOREST_TREES}, {FOREST_LEAF}) on "
            f"{S} shards: {build_s:.2f} s; probes_per_tree={name}: recall@10 "
            f"{rec:.4f}; kernel B launches a search {per_search} "
            f"({FOREST_TREES} a shard)")
        rows["part_forest"][name] = dict(
            recall=rec, launches_per_search=per_search, **compare_shards(
                torch, f"partitioned forest, probes_per_tree={name}",
                lambda: pa._search_batch_rows(qd, TOP_K, probes),
                lambda: forest.search_batch_device(qd, TOP_K, probes)))
        if cpa is not None:
            same(cpa.search_batch(qd, TOP_K, probes_per_tree=probes), res)
            on_cards[f"part_forest_{name}"] = compare_shards(
                torch, f"partitioned forest over {cards.size} cards, "
                f"probes_per_tree={name}",
                lambda: cpa._search_batch_rows(qd, TOP_K, probes))
    assert rows["part_forest"]["auto"]["recall"] >= PART_FOREST_RECALL
    del pa, cpa
    torch.cuda.empty_cache()

    # -- PartitionedHNSWIndex: one subgraph a shard ------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ph = parallel.PartitionedHNSWIndex.build_index(*HNSW_ARGS, x, mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    secs = [s.build_seconds for s in ph.shards]
    t0 = time.perf_counter()
    cache = ph._ensure_device_cache()
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    before = cuda_topk.launches()
    with captured_route_scan(shard=0) as captured:  # for hold_shard_kernels
        res = ph.search_batch(qd, TOP_K)
    held["a_route"] = captured[0]
    per_search = cuda_topk.launches() - before
    assert per_search == S, per_search  # a routing scan a shard
    rec = vt.recall_at_k(res.ids, truth.ids)
    assert (np.diff(res.distances, axis=1) >= 0).all()
    log(f"partitioned hnsw build_index{HNSW_ARGS} on {S} shards: {build_s:.2f} s "
        f"(waves per shard {[s['waves'] for s in secs]} of up to "
        f"{secs[0]['wave_cap']}, waves {sum(s['waves_s'] for s in secs):.2f} s "
        f"on the card in all); serving tables {cache_s:.2f} s (layer-1 rows "
        f"{cache['n1s'].tolist()}); recall@10 {rec:.4f} at ef={HNSW_EF}; "
        f"kernel A launches a search {per_search}")
    rows["part_hnsw"] = dict(build_s=build_s, cache_s=cache_s,
                             waves=[s["waves"] for s in secs],
                             wave_cap=secs[0]["wave_cap"],
                             waves_s=sum(s["waves_s"] for s in secs),
                             n1=cache["n1s"].tolist(), recall=rec,
                             launches_per_search=per_search, **compare_shards(
                                 torch, f"partitioned hnsw, {N_QUERIES} queries",
                                 lambda: ph.search_batch_device(qd, TOP_K)))
    assert rec >= PART_HNSW_RECALL, rec
    del cache
    if cards is not None and cards.size == S:
        # the same subgraphs, their serving tables assembled one a card
        cph = parallel.PartitionedHNSWIndex(ph.shards, gids=ph.gids, mesh=cards)
        assert [v.device for v in cph._ensure_device_cache()["vecs"]] == list(
            cards.devices)
        same(cph.search_batch(qd, TOP_K), res)
        on_cards["part_hnsw"] = compare_shards(
            torch, f"partitioned hnsw over {cards.size} cards",
            lambda: cph.search_batch_device(qd, TOP_K))
        del cph
    del ph
    torch.cuda.empty_cache()

    # -- save / load of every class at PARALLEL_IO_ROWS rows ---------------
    xs, qs = x[:PARALLEL_IO_ROWS], qd[:HNSW_SLICE]
    io_blocks = np.array_split(np.arange(PARALLEL_IO_ROWS), S)
    cases = [
        ("sharded_flat", lambda: parallel.ShardedFlatIndex(xs, mesh=mesh),
         lambda i: i.search_batch(qs, TOP_K)),
        ("sharded_ivf", lambda: parallel.ShardedIVFFlatIndex(
            K_CLUSTERS, centroids, [xs[b[0] : b[-1] + 1] for b in io_blocks],
            io_blocks, mesh=mesh),
         lambda i: i.search_batch(qs, TOP_K, nprobe=2)),
        ("sharded_forest", lambda: parallel.ShardedANNIndex.build_index(
            FOREST_TREES, FOREST_LEAF, xs, mesh=mesh),
         lambda i: i.search_batch(qs, TOP_K)),
        ("sharded_hnsw", lambda: parallel.ShardedHNSWIndex.build_index(
            *HNSW_ARGS, xs, mesh=mesh, batched=True),
         lambda i: i.search_batch(qs, TOP_K)),
        ("partitioned_forest", lambda: parallel.PartitionedANNIndex.build_index(
            FOREST_TREES, FOREST_LEAF, xs, mesh=mesh),
         lambda i: i.search_batch(qs, TOP_K)),
        ("partitioned_hnsw", lambda: parallel.PartitionedHNSWIndex.build_index(
            *HNSW_ARGS, xs, mesh=mesh),
         lambda i: i.search_batch(qs, TOP_K)),
    ]
    build_dir = ROOT / "vers_tpu_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    rows["io"] = {}
    for name, make, search in cases:
        idx = make()
        path = build_dir / f"smoke_{name}.index"
        try:
            t0 = time.perf_counter()
            idx.save_index(str(path))
            size_mb = sum(f.stat().st_size
                          for f in build_dir.glob(path.name + "*")) / 1e6
            loaded = type(idx).load_index(str(path), mesh=mesh)
            io_s = time.perf_counter() - t0
        finally:
            for f in build_dir.glob(path.name + "*"):
                f.unlink()
        a, b = search(idx), search(loaded)
        # graphs come back from their dict form: equal up to ties (the
        # heap's equal distances return in another order, phase 6)
        assert_topk_match(b.distances, b.ids, a.distances, a.ids, rtol=0.0,
                          atol=1e-6)
        reordered = int((a.ids != b.ids).any(axis=1).sum())
        log(f"{name} save/load ({PARALLEL_IO_ROWS} rows, {size_mb:.1f} MB, "
            f"{io_s:.1f} s): results equal up to ties ({reordered} of "
            f"{HNSW_SLICE} rows ordered otherwise)")
        rows["io"][name] = dict(mb=size_mb, s=io_s, reordered=reordered)
        del idx, loaded

    # kernels A and B at the shard-local shapes go to hold_shard_kernels,
    # after the caller has read the counts
    return rows, held


def hold_shard_kernels(torch, qd, held):
    """Each kernel of the multi-device phase against its plain version,
    on inputs captured from that phase's own searches (see the module
    docstring). Returns (kernel A's rows, kernel B's rows) for the
    ``kernels`` line."""
    part, count = held["a_shard"]
    a_row = hold_kernel_a(torch, qd, part, count, TOP_K, "one shard", reps=3)
    a_rows = {"shard_scan": a_row,
              "partitioned_hnsw_route_scan": hold_route_scan(
                  torch, held["a_route"],
                  "the partitioned HNSW's shard-0 routing scan")}
    b_rows = {
        "sharded_ivf": hold_kernel_b(
            torch, *held["b_ivf"], "sharded ivf, shard 0, nprobe=2",
            mirror=False),
        "sharded_forest": hold_kernel_b(
            torch, *held["b_sharded_forest"],
            "sharded forest, query shard 0, probes_per_tree=4, tree 0",
            mirror=True),
        "partitioned_forest": hold_kernel_b(
            torch, *held["b_part_forest"],
            "partitioned forest, shard 0, probes_per_tree=auto, tree 0",
            mirror=True),
    }
    return a_rows, b_rows


def cards_mesh(torch, vt):
    """One shard a card over up to four cards (``make_mesh()``), or None
    on a machine of one card."""
    from vers_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        return None
    return make_mesh(min(4, torch.cuda.device_count()))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    import vers_tpu_torch as vt
    from vers_tpu_torch.ops import (_build, beam_inline, binned, cuda_binned,
                                    cuda_bucket, cuda_topk)
    from vers_tpu_torch.ops.topk import fused_scan_topk
    from vers_tpu_torch.utils.data import synthetic_gaussian
    from vers_tpu_torch.utils.harness import search_exhaustive
    from vers_tpu_torch.utils import roofline
    from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)  # where an index goes unless told
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- build the kernels -------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info['seconds']:.2f} s) -> {_build.library_path().name}")
    for line in _build.build_info["log"].splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "C75" in line):  # C7510..C7520: wgmma serialised
            log(f"  ptxas: {line.strip()}")

    # -- data --------------------------------------------------------
    t0 = time.perf_counter()
    x, q = synthetic_gaussian(N, DIM, n_clusters=1024, n_queries=N_QUERIES,
                              seed=0, normalized=True, query_noise=0.5)
    qd = torch.from_numpy(q).to(dev)
    log(f"data: {N} x {DIM} corpus, {N_QUERIES} queries "
        f"({time.perf_counter() - t0:.1f} s)")
    # -- the main path, counted --------------------------------------
    cuda_topk.LAUNCHES_BY_ROUTE.clear()
    cuda_binned.LAUNCHES = cuda_binned.LAUNCHES_SPLIT = 0
    cuda_binned.LAUNCHES_MERGE = 0

    flat = vt.FlatIndex(x)
    assert flat.device == dev, flat.device
    truth = flat.search_batch(qd, TOP_K)
    flat_ms = cuda_ms(torch, lambda: flat.search_batch_device(qd, TOP_K), reps=2)
    assert truth.ids.shape == (N_QUERIES, TOP_K) and (truth.ids >= 0).all()
    assert np.isfinite(truth.distances).all()
    for i in range(3):  # ground truth against the host reference
        want = search_exhaustive(x, q[i], TOP_K)
        assert_topk_match(truth.distances[i : i + 1], truth.ids[i : i + 1],
                          np.array([[d for _, d in want]]),
                          np.array([[j for j, _ in want]]), rtol=0.0, atol=TOL)
    log(f"flat exact: {flat_ms:.2f} ms / {N_QUERIES} queries = "
        f"{N_QUERIES / flat_ms * 1e3:.0f} qps")

    # -- the flat approximate engines, counted -----------------------
    cuda_bucket.LAUNCHES = 0
    cuda_topk.LAUNCHES_VALUES = 0
    engines = {}
    for name, cfg in (
        ("bucket", vt.FlatConfig(engine="bucket")),
        ("bucket+rescore", vt.FlatConfig(engine="bucket", bucket_rescore=True)),
        ("approx", vt.FlatConfig(engine="approx")),
    ):
        idx = vt.FlatIndex(x, config=cfg)
        assert idx.device == dev, idx.device
        res = idx.search_batch(qd, TOP_K)
        assert res.ids.shape == (N_QUERIES, TOP_K) and (res.ids >= 0).all()
        assert np.isfinite(res.distances).all()
        assert (np.diff(res.distances, axis=1) >= 0).all()
        rec = vt.recall_at_k(res.ids, truth.ids)
        if name != "bucket":  # exact f32 distances: equal to the truth's
            same = res.ids == truth.ids
            assert np.allclose(res.distances[same], truth.distances[same],
                               rtol=0.0, atol=TOL)
        ms = cuda_ms(torch, lambda: idx.search_batch_device(qd, TOP_K),
                     reps=1 if name == "approx" else 3)
        log(f"flat {name}: recall@10 {rec:.4f}, {ms:.2f} ms / {N_QUERIES} "
            f"queries = {N_QUERIES / ms * 1e3:.0f} qps")
        assert rec >= ENGINE_RECALL[name], (name, rec)
        engines[name] = dict(recall=rec, ms=ms, qps=N_QUERIES / ms * 1e3)
        del idx, res  # the engine's own copy of the corpus
    engine_launches = {"bucket_scan": cuda_bucket.LAUNCHES,
                       "topk_values": cuda_topk.LAUNCHES_VALUES}
    log(f"kernel launches of the flat engines: {engine_launches}")
    assert all(n > 0 for n in engine_launches.values()), engine_launches
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = vt.IVFFlatIndex.build_index(K_CLUSTERS, 2, 10, x)
    assert ivf.device == dev, ivf.device
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    layout = ivf._ensure_layout()
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    sizes = layout["sizes_host"]
    log(f"ivf build k={K_CLUSTERS}: {build_s:.2f} s k-means + assignment, "
        f"{layout_s:.2f} s layout; cluster sizes min {sizes.min()} "
        f"max {sizes.max()} empty {(sizes == 0).sum()}")

    operating = None
    scans = {}  # nprobe -> the packed-scan arguments of that search
    merges = {}  # nprobe -> kernel F's arguments (nprobe > 1)
    for nprobe in (1, 2, 4, 8):
        with binned.captured_scans() as calls, captured_merges() as merged:
            res = ivf.search_batch(qd, TOP_K, nprobe=nprobe)
        scans[nprobe] = calls
        if nprobe > 1:
            merges[nprobe] = merged
        # a probed cluster can hold fewer than TOP_K rows (k-means leaves
        # some clusters empty): such slots are (+inf, -1)
        assert res.ids.shape == (N_QUERIES, TOP_K)
        assert np.array_equal(res.ids >= 0, np.isfinite(res.distances))
        short = int((res.ids < 0).any(axis=1).sum())
        rec = vt.recall_at_k(res.ids, truth.ids)
        ms = cuda_ms(torch, lambda: ivf.search_batch_device(qd, TOP_K, nprobe))
        log(f"ivf nprobe={nprobe}: recall@10 {rec:.4f}, {ms:.2f} ms / "
            f"{N_QUERIES} queries = {N_QUERIES / ms * 1e3:.0f} qps "
            f"({short} queries with < {TOP_K} results)")
        if rec >= TARGET_RECALL:
            operating = nprobe
            break
    assert operating is not None, f"recall@10 < {TARGET_RECALL} at nprobe <= 8"

    with binned.captured_scans() as calls, captured_merges() as merged:
        res0 = ivf.search_batch(qd, TOP_K, nprobe=0)
    scans[0], merges[0] = calls, merged
    # online retrieval's batch: host queries in, kernel B's split walk
    with binned.captured_scans() as small_scan:
        res_small = ivf.search_batch(q[:SMALL_QUERIES], TOP_K, nprobe=2)
    (small_args, small_kw), = small_scan
    assert cuda_binned.walk_splits(small_args[0], small_kw["q_blk"])
    log(f"ivf search_batch of {SMALL_QUERIES} host queries, nprobe=2: "
        f"recall@10 {vt.recall_at_k(res_small.ids, truth.ids[:SMALL_QUERIES]):.4f}"
        f", kernel B's split walk")
    ms0 = cuda_ms(torch, lambda: ivf.search_batch_device(qd, TOP_K, 0))
    log(f"ivf adaptive nprobe=0: recall@10 {vt.recall_at_k(res0.ids, truth.ids):.4f}, "
        f"{N_QUERIES / ms0 * 1e3:.0f} qps")

    # the IVF search as CUDA graphs against itself eagerly, with no host
    # synchronisation after a setting's first call, and chained
    ivf_graphs = {}
    for nprobe in (1, 2):
        ivf_graphs[f"nprobe{nprobe}"] = graph_reading(
            torch, f"ivf nprobe={nprobe}",
            lambda: ivf.search_batch_device(qd, TOP_K, nprobe), [ivf._graphs])
    ivf_graphs["no_host_sync"] = no_sync_reading(
        torch, "ivf nprobe=1, 2, 0",
        [lambda p=p: ivf.search_batch_device(qd, TOP_K, p) for p in (1, 2, 0)])
    ivf_graphs["chained"] = chained_reading(
        torch, f"ivf nprobe={operating}",
        lambda: ivf.search_batch_device(qd, TOP_K, operating), N_QUERIES)

    for i in range(3):
        pairs = ivf.search_approximate(q[i], TOP_K)
        ids = np.array([j for j, _ in pairs])
        dists = np.array([d for _, d in pairs])
        assert len(pairs) == TOP_K and (ids >= 0).all() and (ids < N).all()
        direct = ((x[ids] - q[i][None, :]) ** 2).sum(axis=1)
        assert np.allclose(dists, direct, rtol=0.0, atol=TOL)
    log("search_approximate: 3 queries ok")

    v = q[5] * np.float32(1.001)
    ivf.add(v, 123)  # the caller's id is ignored (PARITY #7)
    # add assigns on the host, search probes on the card: probe 2 so that
    # a near-tie between two centroids cannot hide the new row
    found = ivf.search_batch(v[None, :], 1, nprobe=2)
    assert found.ids[0, 0] == N, found.ids
    log(f"add: new row found as id {found.ids[0, 0]}")

    path = ROOT / "vers_tpu_torch" / "_build" / "smoke_ivfflat.index"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        ivf.save_index(str(path))
        loaded = vt.IVFFlatIndex.load_index(str(path))
        assert loaded.device == dev, loaded.device
        io_s = time.perf_counter() - t0
        a = ivf.search_batch(qd, TOP_K, nprobe=operating)
        b = loaded.search_batch(qd, TOP_K, nprobe=operating)
    finally:
        path.unlink(missing_ok=True)
    assert np.array_equal(a.ids, b.ids)
    rt_err = max_abs_diff(a.distances, b.distances)
    assert rt_err <= 1e-6, rt_err
    log(f"save/load round trip: identical ids, max |d distance| {rt_err:g} "
        f"({io_s:.1f} s for {path.name})")

    launches = {"distance_topk": cuda_topk.launches(),
                "packed_scan": cuda_binned.LAUNCHES,
                "packed_scan_split": cuda_binned.LAUNCHES_SPLIT,
                "rank_merge": cuda_binned.LAUNCHES_MERGE}
    main_routes = dict(cuda_topk.LAUNCHES_BY_ROUTE)
    log(f"kernel launches on the main path: {launches}, kernel A by route "
        f"{main_routes}")
    assert all(n > 0 for n in launches.values()), launches
    assert main_routes == {"f32/highest": launches["distance_topk"]}

    # -- the forest, kernel B's second caller, counted on its own -----
    cuda_binned.LAUNCHES_SPLIT = 0
    merges_before = cuda_binned.LAUNCHES_MERGE
    forest_rows, forest_scans, forest_launches, forest = forest_phase(
        torch, vt, x, q, qd, truth.ids, dev)
    forest_split = cuda_binned.LAUNCHES_SPLIT
    log(f"kernel B launches in the forest phase: {forest_launches}, "
        f"{forest_split} of them on the split walk")
    assert forest_launches > 0
    # the trees overlap: the dedup merge, never kernel F
    assert cuda_binned.LAUNCHES_MERGE == merges_before
    torch.cuda.empty_cache()

    # -- HNSW, kernel A's second caller, counted on its own -----------
    hnsw_rows, hnsw_scan, hnsw_launches, hnsw_index, qd2, e_row = hnsw_phase(
        torch, vt, x, q, qd, truth.ids, dev)
    log(f"kernel A launches in the HNSW phase: {hnsw_launches}")
    assert hnsw_launches > 0
    torch.cuda.empty_cache()

    # -- the multi-device layer: kernels A, B and C at shard-local ----
    # -- shapes, counted on its own -----------------------------------
    cuda_topk.LAUNCHES_VALUES = 0
    cuda_topk.LAUNCHES_BY_ROUTE.clear()
    cuda_binned.LAUNCHES = cuda_binned.LAUNCHES_SPLIT = 0
    cuda_binned.LAUNCHES_MERGE = 0
    cuda_bucket.LAUNCHES = 0
    beam_inline.LAUNCHES = beam_inline.LAUNCHES_PLAIN = 0
    parallel_rows, held = parallel_phase(
        torch, vt, x, qd, truth, dev, flat, ivf, forest, hnsw_index, qd2,
        cards_mesh(torch, vt))
    parallel_launches = {"distance_topk": cuda_topk.launches(),
                         "packed_scan": cuda_binned.LAUNCHES,
                         "packed_scan_split": cuda_binned.LAUNCHES_SPLIT,
                         "rank_merge": cuda_binned.LAUNCHES_MERGE,
                         "topk_values": cuda_topk.LAUNCHES_VALUES,
                         "bucket_scan": cuda_bucket.LAUNCHES,
                         "beam_step": beam_inline.LAUNCHES,
                         "beam_step_plain": beam_inline.LAUNCHES_PLAIN}
    parallel_routes = dict(cuda_topk.LAUNCHES_BY_ROUTE)
    log(f"kernel launches in the multi-device phase: {parallel_launches}, "
        f"kernel A by route {parallel_routes}")
    assert set(parallel_routes) == {"f32/highest", "bf16/default"}, \
        parallel_routes
    assert all(parallel_launches[k] > 0 for k in
               ("distance_topk", "packed_scan", "rank_merge", "topk_values")), \
        parallel_launches
    assert parallel_launches["bucket_scan"] == 0  # no caller in parallel/
    del forest, hnsw_index, qd2
    torch.cuda.empty_cache()
    shard_a, shard_b = hold_shard_kernels(torch, qd, held)
    del held
    torch.cuda.empty_cache()

    # -- kernel A's other routes, the bf16 store, the README flow, the --
    # -- demo and the native IO, counted on their own -----------------
    bf16_rows, route_rows, bf16_launches = bf16_phase(
        torch, vt, x, qd, truth, flat._store.data)
    torch.cuda.empty_cache()

    # -- each kernel against its plain version, on the card, at the --
    # -- main path's shapes ------------------------------------------
    # kernel A (with kernel C as its second pass when the corpus is split)
    # at the flat index's query counts, from one query up
    xd = flat._store.data
    a_rows = {}
    for qn in A_QUERIES:
        qs = qd[:qn]
        ka = cuda_topk.cuda_distance_topk(qs, xd, N, TOP_K)
        again = cuda_topk.cuda_distance_topk(qs, xd, N, TOP_K)
        # deterministic: a repeat call, and the ground truth's own call
        assert torch.equal(ka[0], again[0]) and torch.equal(ka[1], again[1]), qn
        assert np.array_equal(ka[1].cpu().numpy(), truth.ids[:qn])
        assert np.array_equal(ka[0].cpu().numpy(), truth.distances[:qn])
        pa = fused_scan_topk(qs, xd, N, TOP_K)
        assert_topk_match(ka[0], ka[1], pa[0], pa[1], rtol=0.0, atol=TOL)
        err = max_abs_diff(ka[0], pa[0])
        del ka, again, pa
        plan = cuda_topk.plan_for(qs, xd, N, TOP_K)
        n_split, split_rows = plan.n_split, plan.split_rows
        grid = [-(-qn // plan.query_tile), n_split]
        reps = 2 if qn >= 2048 else 20
        ms = cuda_ms(torch, lambda: cuda_topk.cuda_distance_topk(qs, xd, N, TOP_K),
                     reps=reps)
        plain = cuda_ms(torch, lambda: fused_scan_topk(qs, xd, N, TOP_K),
                        reps=1 if qn >= 2048 else 5)
        second = 0.0
        if n_split > 1:
            vals, ids, _ = cuda_topk.split_pass(qs, xd, N, TOP_K)
            second = cuda_ms(torch, lambda: cuda_topk.cuda_topk_values(
                vals, ids, TOP_K), reps=reps)
            del vals, ids
        log(f"kernel A vs plain, Q={qn} over {N}: max |d| {err:g}, {ms:.3f} ms "
            f"vs {plain:.2f} ms; {n_split} splits of {split_rows} rows, grid "
            f"{grid}, second pass (kernel C over {n_split * TOP_K} columns) "
            f"{second:.3f} ms")
        a_rows[qn] = dict(n_split=n_split, split_rows=split_rows, grid=grid,
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          second_pass_ms=second)
    err_a = max(r["max_abs_err"] for r in a_rows.values())
    ms_a, plain_a = a_rows[N_QUERIES]["ms"], a_rows[N_QUERIES]["plain_ms"]
    one = q[7]
    flat.search_approximate(one, TOP_K)
    t0 = time.perf_counter()
    for _ in range(20):
        pairs = flat.search_approximate(one, TOP_K)
    single_ms = (time.perf_counter() - t0) / 20 * 1e3
    want = search_exhaustive(x, one, TOP_K)
    assert [j for j, _ in pairs] == [j for j, _ in want] or np.allclose(
        [d for _, d in pairs], [d for _, d in want], rtol=0.0, atol=TOL)
    log(f"flat search_approximate, one query: {single_ms:.3f} ms (host clock, "
        f"result on the host)")

    # kernel D: the bucket table of the engine's stage 1 (the same call,
    # on the corpus prepared as FlatIndex prepares it), by query count
    chunk, superchunk, n_super = cuda_bucket.bucket_geometry(xd.shape[0])
    span = chunk * superchunk
    prep = cuda_bucket.prepare_bucket_corpus(xd)
    d_rows = {}
    for qn in D_QUERIES:
        qs = qd[:qn]
        kd = cuda_bucket.cuda_bucket_table(qs, xd, N, span, prepared=prep)
        again = cuda_bucket.cuda_bucket_table(qs, xd, N, span, prepared=prep)
        fresh = cuda_bucket.cuda_bucket_table(qs, xd, N, span)
        for other in (again, fresh):  # deterministic; prepared = unprepared
            assert torch.equal(kd[0], other[0]) and torch.equal(kd[1], other[1])
        del again, fresh
        pd = cuda_bucket.bucket_table_plain(qs, xd, N, span)
        err, ties = cuda_bucket.compare_bucket_tables(kd, pd, qs, xd, N, span,
                                                      atol=TOL)
        del pd
        ms = cuda_ms(torch, lambda: cuda_bucket.cuda_bucket_table(
            qs, xd, N, span, prepared=prep), reps=3 if qn >= 2048 else 20)
        plain = cuda_ms(torch, lambda: cuda_bucket.bucket_table_plain(
            qs, xd, N, span), reps=1)
        geo = cuda_bucket.kernel_d_geometry(qn, xd.shape[0], DIM, span)
        bound = roofline.bucket_scan_bound(qn, N, DIM, kd[0].shape[1])
        log(f"kernel D vs plain, Q={qn} over {xd.shape[0]} rows (chunk {chunk}, "
            f"superchunk {superchunk}, {n_super} x 128 = {kd[0].shape[1]} "
            f"buckets; grid {list(geo['grid'])}, ring {geo['ring']}, "
            f"resident {geo['resident']}): max |d| {err:g}, {ties} near-tie "
            f"rows, {ms:.3f} ms vs {plain:.2f} ms; bound {bound['bound_ms']:.3f} "
            f"ms ({bound['bound_by']})")
        d_rows[qn] = dict(grid=list(geo["grid"]), ring=geo["ring"],
                          max_abs_err=err, near_tie_rows=ties, ms=ms,
                          plain_ms=plain, bound_ms=bound["bound_ms"],
                          bound_by=bound["bound_by"])
        if qn != N_QUERIES:
            del kd
    width = kd[0].shape[1]
    del prep

    # kernel C on that table, at the engine's widths: selection only;
    # one torch.topk call computes the same function (the yardstick)
    c_rows = {}
    for s in (TOP_K, 32, cuda_topk.MAX_K):
        kc = cuda_topk.cuda_topk_values(kd[0], kd[1], s)
        pc = cuda_topk.topk_values_plain(kd[0], kd[1], s)
        assert torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1]), s
        tv, tsel = torch.topk(kd[0], s, dim=1, largest=False, sorted=True)
        assert torch.equal(tv, kc[0]), s
        tie_rows = int((torch.gather(kd[1], 1, tsel) != kc[1]).any(dim=1).sum())
        del pc, tv, tsel
        ms_c = cuda_ms(torch, lambda: cuda_topk.cuda_topk_values(kd[0], kd[1], s),
                       reps=5)
        plain_c = cuda_ms(torch, lambda: cuda_topk.topk_values_plain(
            kd[0], kd[1], s), reps=2)
        lib_c = cuda_ms(torch, lambda: torch.topk(kd[0], s, dim=1, largest=False,
                                                  sorted=True), reps=5)
        bound = roofline.topk_values_bound(N_QUERIES, width, s)
        log(f"kernel C vs plain, ({N_QUERIES}, {width}) table, s={s}: identical, "
            f"{ms_c:.3f} ms vs {plain_c:.2f} ms; torch.topk {lib_c:.3f} ms (same "
            f"values, {tie_rows} rows in another tie order); bound "
            f"{bound['bound_ms']:.3f} ms ({bound['bound_by']})")
        c_rows[s] = dict(max_abs_err=0.0, ms=ms_c, plain_ms=plain_c,
                         library_ms=lib_c, library_tie_order_rows=tie_rows,
                         bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        del kc
    del kd
    # ... and on kernel A's second-pass table: the splits' best sets
    vals, ids, n_split = cuda_topk.split_pass(qd, xd, N, TOP_K)
    assert n_split > 1, n_split
    kc = cuda_topk.cuda_topk_values(vals, ids, TOP_K)
    pc = cuda_topk.topk_values_plain(vals, ids, TOP_K)
    assert torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1])
    assert np.array_equal(kc[1].cpu().numpy(), truth.ids)
    del kc, pc
    narrow_ms = cuda_ms(torch, lambda: cuda_topk.cuda_topk_values(vals, ids, TOP_K),
                        reps=20)
    narrow_plain = cuda_ms(torch, lambda: cuda_topk.topk_values_plain(
        vals, ids, TOP_K), reps=5)
    narrow_lib = cuda_ms(torch, lambda: torch.topk(vals, TOP_K, dim=1,
                                                   largest=False), reps=20)
    bound = roofline.topk_values_bound(N_QUERIES, vals.shape[1], TOP_K)
    log(f"kernel C vs plain, kernel A's second pass ({N_QUERIES}, "
        f"{vals.shape[1]}), s={TOP_K}: identical, {narrow_ms:.4f} ms vs "
        f"{narrow_plain:.3f} ms; torch.topk {narrow_lib:.4f} ms; bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    c_rows["second_pass"] = dict(width=vals.shape[1], max_abs_err=0.0,
                                 ms=narrow_ms, plain_ms=narrow_plain,
                                 library_ms=narrow_lib,
                                 bound_ms=bound["bound_ms"],
                                 bound_by=bound["bound_by"])
    del vals, ids
    torch.cuda.empty_cache()

    assert cuda_binned.kernel_constants() == dict(
        QUERY_TILE=cuda_binned.QUERY_TILE, TILE_ROWS=cuda_binned.TILE_ROWS,
        PLAN_MAX=cuda_binned.PLAN_MAX)
    b_rows = {}
    for nprobe, calls in scans.items():
        assert len(calls) == 1, (nprobe, len(calls))
        b_rows[nprobe] = hold_kernel_b(
            torch, *calls[0], f"main-path scan of nprobe={nprobe}",
            mirror=nprobe == operating)
    del scans
    small_row = hold_kernel_b(
        torch, small_args, small_kw,
        f"main-path scan of a {SMALL_QUERIES}-query search_batch, nprobe=2",
        mirror=True)
    assert small_row["walk"] == "split", small_row
    del small_scan, small_args
    # kernel F on the merges of the sweep's nprobe > 1 and the adaptive
    # walk (the benchmark's adaptive cell: the walk's depth, 16384 queries)
    f_rows = {}
    for nprobe, merged in merges.items():
        assert len(merged) == 1, (nprobe, len(merged))
        f_rows[nprobe] = hold_rank_merge(
            torch, merged[0], f"main-path merge of nprobe={nprobe}")
    del merges

    bound_a = roofline.distance_topk_bound(N_QUERIES, N, DIM, TOP_K)
    by_route = {"flat": main_routes, "hnsw": hnsw_rows["launches_by_route"],
                "parallel": parallel_routes, "phase8": bf16_launches["routes"]}

    def route_launches(route):
        return sum(r.get(route, 0) for r in by_route.values())

    # kernel A, an entry a route: f32/highest (``distance_topk``) held at
    # phase 1's query counts and on one shard; every other route at Q =
    # 16384 over phase 1's corpus (f32) or the bf16 store, bf16/default
    # also on the two routing scans of HNSW
    shard_scan = shard_a["shard_scan"]
    part_scan = shard_a["partitioned_hnsw_route_scan"]

    def by_phase(route):
        return {ph: r.get(route, 0) for ph, r in by_route.items()}

    route_entries = [
        {"name": f"distance_topk[{route}]", "route": "cuda",
         "source": "vers_tpu_torch/csrc/distance_topk.cu",
         "replaces": "vers_tpu/ops/pallas_topk.py:294",
         "launches": route_launches(route),
         "launches_by_phase": by_phase(route),
         "max_abs_err": max(r["max_abs_err"] for r in by_q.values()),
         "ms": by_q[N_QUERIES]["ms"], "plain_ms": by_q[N_QUERIES]["plain_ms"],
         "bound_ms": by_q[N_QUERIES]["bound_ms"],
         "bound_by": by_q[N_QUERIES]["bound_by"], "library_ms": None,
         "shape": f"Q={N_QUERIES} N={N} d={DIM} k={TOP_K} "
                  f"{route.split('/')[0]} corpus, precision "
                  f"{route.split('/')[1]}",
         "by_q": by_q}
        for route, by_q in route_rows.items()]
    for e in route_entries:
        if e["name"] == "distance_topk[bf16/highest]":
            e["phase8"] = bf16_rows
        if e["name"] == "distance_topk[bf16/default]":
            e["max_abs_err"] = max(
                e["max_abs_err"], hnsw_scan["max_abs_err"],
                part_scan["max_abs_err"],
                *(hnsw_scan[f"build_scan_k{k}"]["max_abs_err"]
                  for k in (HNSW_ARGS[1], 1)))
            e["hnsw_route_scan"] = hnsw_scan
            e["partitioned_hnsw_route_scan"] = part_scan
            e["hnsw"] = hnsw_rows
    kernels = [
        {"name": "distance_topk", "route": "cuda",
         "source": "vers_tpu_torch/csrc/distance_topk.cu",
         "replaces": "vers_tpu/ops/pallas_topk.py:294",
         "launches": route_launches("f32/highest"),
         "launches_by_phase": by_phase("f32/highest"),
         "max_abs_err": max(err_a, shard_scan["max_abs_err"]),
         "ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a["bound_ms"],
         "bound_by": bound_a["bound_by"], "library_ms": None,
         "shape": f"Q={N_QUERIES} N={N} d={DIM} k={TOP_K} f32 corpus, "
                  f"precision highest",
         "by_q": a_rows, "search_approximate_ms": single_ms,
         "shard_scan": shard_scan, "parallel": parallel_rows},
        *route_entries,
        {"name": "packed_scan", "route": "cuda",
         "source": "vers_tpu_torch/csrc/packed_scan.cu",
         "replaces": "vers_tpu/ops/pallas_binned.py:235",
         "launches": launches["packed_scan"] + forest_launches
                     + parallel_launches["packed_scan"],
         "launches_ivf": launches["packed_scan"],
         "launches_forest": forest_launches,
         "launches_parallel": parallel_launches["packed_scan"],
         "launches_split": launches["packed_scan_split"] + forest_split
                           + parallel_launches["packed_scan_split"],
         "launches_split_by_phase": {
             "ivf": launches["packed_scan_split"], "forest": forest_split,
             "parallel": parallel_launches["packed_scan_split"]},
         "max_abs_err": max(r["max_abs_err"] for r in
                            (*b_rows.values(), small_row,
                             *forest_scans.values(), *shard_b.values())),
         "ms": b_rows[operating]["ms"], "plain_ms": b_rows[operating]["plain_ms"],
         "bound_ms": b_rows[operating]["bound_ms"],
         "bound_by": b_rows[operating]["bound_by"], "library_ms": None,
         "shape": f"Q={N_QUERIES} nprobe={operating} k={TOP_K} of the "
                  f"{K_CLUSTERS}-cluster layout",
         "by_nprobe": b_rows, "small_batch": small_row,
         "by_forest_scan": forest_scans,
         "forest": forest_rows, "parallel_scans": shard_b,
         "ivf_graphs": ivf_graphs},
        {"name": "rank_merge", "route": "cuda",
         "source": "vers_tpu_torch/csrc/rank_merge.cu",
         "replaces": None,  # the JAX package's merge is plain jnp
         "launches": launches["rank_merge"] + parallel_launches["rank_merge"],
         "launches_by_phase": {"ivf": launches["rank_merge"], "forest": 0,
                               "parallel": parallel_launches["rank_merge"]},
         "max_abs_err": 0.0,
         "ms": f_rows[0]["ms"], "plain_ms": f_rows[0]["plain_ms"],
         "bound_ms": f_rows[0]["bound_ms"], "bound_by": f_rows[0]["bound_by"],
         "library_ms": None,
         "shape": f"Q={N_QUERIES} p={f_rows[0]['ranks']} k={TOP_K}: the "
                  f"adaptive walk's merge",
         "by_nprobe": f_rows},
        {"name": "topk_values", "route": "cuda",
         "source": "vers_tpu_torch/csrc/topk_values.cu",
         "replaces": "vers_tpu/ops/pallas_topk.py:230",
         "launches": engine_launches["topk_values"]
                     + parallel_launches["topk_values"]
                     + bf16_launches["topk_values"],
         "launches_flat_engines": engine_launches["topk_values"],
         "launches_parallel": parallel_launches["topk_values"],
         "launches_phase8": bf16_launches["topk_values"],
         "max_abs_err": 0.0,
         "ms": c_rows[TOP_K]["ms"], "plain_ms": c_rows[TOP_K]["plain_ms"],
         "bound_ms": c_rows[TOP_K]["bound_ms"],
         "bound_by": c_rows[TOP_K]["bound_by"],
         "library_ms": c_rows[TOP_K]["library_ms"],
         "shape": f"({N_QUERIES}, {width}) bucket table, s={TOP_K}",
         "by_s": c_rows},
        {"name": "bucket_scan", "route": "cuda",
         "source": "vers_tpu_torch/csrc/bucket_scan.cu",
         "replaces": "vers_tpu/ops/pallas_bucket.py:109",
         "launches": engine_launches["bucket_scan"]
                     + bf16_launches["bucket_scan"],
         "launches_parallel": parallel_launches["bucket_scan"],
         "launches_phase8": bf16_launches["bucket_scan"],
         "max_abs_err": max(r["max_abs_err"] for r in d_rows.values()),
         "ms": d_rows[N_QUERIES]["ms"], "plain_ms": d_rows[N_QUERIES]["plain_ms"],
         "bound_ms": d_rows[N_QUERIES]["bound_ms"],
         "bound_by": d_rows[N_QUERIES]["bound_by"], "library_ms": None,
         "shape": f"Q={N_QUERIES} N={xd.shape[0]} d={DIM} span={span} "
                  f"W={width}",
         "by_q": d_rows},
        {"name": "beam_step", "route": "cuda",
         "source": "vers_tpu_torch/csrc/beam_step.cu",
         "replaces": None,  # the JAX package's step is plain jnp
         "launches": e_row["launches_hnsw"] + parallel_launches["beam_step"],
         "launches_by_phase": {"hnsw": e_row["launches_hnsw"],
                               "parallel": parallel_launches["beam_step"]},
         "launches_plain_by_phase": {
             "hnsw": 0, "parallel": parallel_launches["beam_step_plain"]},
         "library_ms": None, "ms_per": "step",
         **{k: v for k, v in e_row.items() if k != "launches_hnsw"}},
    ]
    log(f"flat engines: {json.dumps(engines)}")
    log(f"smoke wall time {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
