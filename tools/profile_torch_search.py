#!/usr/bin/env python3
"""Where the time goes in vers_tpu_torch's searches, on one CUDA card.

Builds the smoke run's configuration (``synthetic_gaussian`` corpus of
1M x 300 from seed 0, IVF k = 2048 with 2 restarts and 10 Lloyd
iterations, an RP-forest of 8 trees with ``max_node_size`` 100, 16384
queries, top_k = 10; HNSW as ``HNSWIndex.build_index_batched(12, 100,
32, 24, x)`` on the smoke run's HNSW corpus of 4096 clusters), then for
each search path -- IVF at nprobe 1, 2 and the adaptive 0, the forest
at ``probes_per_tree`` 1, 4 and the default auto depth, the exact flat
scan, the flat "bucket" (no rescore) and "approx" engines, and HNSW at
ef = 32 with the default inline beam and with the classic gather beam
on the first 2048 queries, and the sharded IVF (nprobe 2), forest (1
probe) and flat searches over a mesh of 4 shards on the card -- it
times ``--reps`` calls with CUDA events, profiles ``--reps`` more with
``torch.profiler``, and prints per call (every IVF, forest and HNSW
path, sharded or not, twice: as the package runs it, replaying its CUDA
graphs (``vers_tpu_torch.graphs``), and eagerly, "<path> eager", under
``graphs.disabled()``):

  * the wall time, unprofiled (every path timed before the first
    profiler run) and under the profiler (ms);
  * the device busy time: the union of the card's kernel and copy
    intervals, so overlapping or nested records count once (ms);
  * the device idle share: 1 - busy / profiled window, where the window
    runs from the first call's start to a final synchronize;
  * the device activities with the most time, by name;

and, for each graph-replayed IVF and forest path, the chained rate:
``--depth`` calls enqueued back to back and drained once (the pipelined
serving model of ``docs/SERVING.md``) against as many calls each
drained, on the host clock (ms a call). IVF's adaptive nprobe=0 runs
eagerly in the package, so it has no eager twin here.

``--traffic`` then replays traces of batch shapes through IVF (nprobe
2), the forest (1 probe) and HNSW (the inline beam), each call drained,
as the package runs them and eagerly, on one index each with its graphs
dropped before every trace: one shape (repeated, as a server that pads
its batches sends), 4 shapes and 8 shapes (drawn at random from
Q, Q/2, ... or Q, 7Q/8, ...), and a new shape at every call, with the
program's tracing on (``vers_tpu_torch.trace``). It prints each call's
outcome (eager, capture or replay, from the program's ``graph.*`` spans;
the hit rate is the share of replays), the trace's wall time both ways,
the median call of each outcome, and the pool bytes after the trace;
the 8-shape trace runs again with ``graphs.MAX_SITES`` halved. Every
time of ``--traffic`` is taken with tracing on, and so includes its
cost: about ten host spans and five stage-marker kernels a search
(``vers_tpu_torch/TRACING.md``); the other modes run with tracing off.

Usage, from the repository root:

    python3 tools/profile_torch_search.py [--n N] [--dim D] [--queries Q]
        [--clusters K] [--top-k K] [--reps R] [--top T] [--out PATH]
        [--paths PREFIX,...] [--hnsw-io] [--depth D] [--traffic]
        [--trace-calls N]

``--paths`` keeps the paths whose names start with one of the prefixes
(``hnsw`` alone builds only the HNSW index; ``sharded`` builds the IVF
index and the forest it shards); ``--hnsw-io`` also times
``save_index`` and ``load_index`` of the HNSW index (host clock).
``--out`` writes every path's numbers and all of its device activities
as JSON. Needs one CUDA card; exits 2 without one. Every path runs in
one process, and every index keeps its graphs to the end, as a server
would.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WINDOW = "profiled_calls"


def cuda_ms(torch, fn, reps):
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


def busy_us(spans):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_profile(events, reps, device_type):
    """Busy time, idle share and per-name totals of the device records
    inside the profiled window, per call."""
    window = next(e for e in events
                  if e.name == WINDOW and e.device_type != device_type)
    dev = [e for e in events
           if e.device_type == device_type and e.name != WINDOW
           and not e.name.startswith("Activity Buffer")]
    span = window.time_range.end - window.time_range.start
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(
        profiled_ms=span / reps / 1e3,
        busy_ms=busy / reps / 1e3,
        idle_share=1.0 - busy / span if span > 0 else None,
        activities=[dict(name=n, calls=c / reps, ms=t / reps / 1e3)
                    for n, (c, t) in top],
    )


def chained_ms(torch, fn, depth, rounds=3):
    """(ms a call with ``depth`` calls chained and one drain, ms a call
    each drained), host clock, the better of ``rounds`` rounds each,
    the two interleaved."""
    fn()
    fn()
    torch.cuda.synchronize()
    chained, synced = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(depth):
            fn()
        torch.cuda.synchronize()
        chained.append((time.perf_counter() - t0) / depth * 1e3)
        t0 = time.perf_counter()
        for _ in range(depth):
            fn()
            torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) / depth * 1e3)
    return min(chained), min(synced)


def traces(q_n, calls, seed=0):
    """Name -> the query counts of ``calls`` calls (see the module
    docstring)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    halves = [q_n >> i for i in range(4)]
    eighths = [q_n * i // 8 for i in range(8, 0, -1)]
    fresh = rng.choice(np.arange(q_n // 8, q_n + 1), size=calls,
                       replace=False)
    return {"one shape": [q_n] * calls,
            "4 shapes": [int(v) for v in rng.choice(halves, size=calls)],
            "8 shapes": [int(v) for v in rng.choice(eighths, size=calls)],
            "a new shape each call": [int(v) for v in fresh]}


def outcome_counts(trace):
    """Calls so far of each graph outcome span (``graphs.run``)."""
    spans = trace.snapshot()["spans"]
    return {k: spans.get(f"graph.{k}", {}).get("count", 0)
            for k in ("eager", "capture", "replay")}


def run_trace(torch, graphs, trace, cache, search, queries, counts):
    """One trace through ``search(q)`` as the package runs it, then
    eagerly, each call drained, with the program's tracing on: the
    outcome of each graph call from its ``graph.*`` spans (eager where
    any of its graphs ran eagerly, else capture where any captured,
    else replay), wall seconds both ways, the median ms of each outcome
    and of the eager calls, the pool bytes after it."""
    import statistics

    outcomes = []
    cache.invalidate()
    times = {"eager": [], "capture": [], "replay": [], "eager mode": []}
    walls = {}
    for mode in ("graph", "eager"):
        total = 0.0
        for n in counts:
            q = queries[:n]
            before = outcome_counts(trace)
            t0 = time.perf_counter()
            if mode == "graph":
                search(q)
            else:
                with graphs.disabled():
                    search(q)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            total += dt
            if mode == "graph":
                ran = outcome_counts(trace)
                outcomes.append(next(
                    (k for k in ("eager", "capture")
                     if ran[k] > before[k]), "replay"))
            key = outcomes[-1] if mode == "graph" else "eager mode"
            times[key].append(dt * 1e3)
        walls[mode] = total
    calls = len(counts)
    return dict(
        calls=calls, shapes=len(set(counts)),
        outcomes={k: outcomes.count(k) for k in ("eager", "capture", "replay")},
        hit_rate=outcomes.count("replay") / calls,
        graph_s=walls["graph"], eager_s=walls["eager"],
        median_ms={k: statistics.median(v) for k, v in times.items() if v},
        sites=len(cache.sites()), pool_bytes=cache.pool_bytes())


def traffic(torch, graphs, trace, searches, q_n, calls):
    """``run_trace`` of every trace (``traces``) through each of
    ``searches`` (name -> (search(q), its index's GraphCache, the
    queries)), with the program's tracing on (``trace.enable()``);
    returns name -> trace -> row."""
    out = {}
    for name, (search, cache, queries) in searches.items():
        n = min(q_n, queries.shape[0])
        rows = out[name] = {}
        for shapes, counts in traces(n, calls).items():
            rows[shapes] = run_trace(torch, graphs, trace, cache, search,
                                     queries, counts)
        default = graphs.MAX_SITES
        graphs.MAX_SITES = default // 2
        try:
            rows[f"8 shapes, MAX_SITES={default // 2}"] = run_trace(
                torch, graphs, trace, cache, search, queries,
                traces(n, calls)["8 shapes"])
        finally:
            graphs.MAX_SITES = default
        cache.invalidate()
        for shapes, r in rows.items():
            print(f"== traffic {name}, {shapes}: {r['calls']} calls of "
                  f"{r['shapes']} shapes, {r['outcomes']}, hit rate "
                  f"{r['hit_rate']:.3f}; graph {r['graph_s']:.3f} s, eager "
                  f"{r['eager_s']:.3f} s; median ms {r['median_ms']}; "
                  f"{r['sites']} sites, pool {r['pool_bytes'] / 1e9:.3f} GB",
                  flush=True)
    return out


def profile_path(torch, fn, reps, wall):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    out = device_profile(prof.events(), reps, DeviceType.CUDA)
    out["wall_ms"] = wall
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--queries", type=int, default=16384)
    ap.add_argument("--clusters", type=int, default=2048)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12,
                    help="device activities printed per path")
    ap.add_argument("--out", help="write all numbers as JSON here")
    ap.add_argument("--paths", default="",
                    help="comma-separated name prefixes of the paths to run")
    ap.add_argument("--hnsw-io", action="store_true",
                    help="also time the HNSW index's save_index + load_index")
    ap.add_argument("--depth", type=int, default=8,
                    help="calls chained before one drain (the chained rate)")
    ap.add_argument("--traffic", action="store_true",
                    help="also replay the traces of batch shapes")
    ap.add_argument("--trace-calls", type=int, default=48,
                    help="calls in each trace")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_search.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    import vers_tpu_torch as vt
    from vers_tpu_torch import graphs, trace
    from vers_tpu_torch.utils.data import synthetic_gaussian

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda:0")
    import numpy as np

    prefixes = [p for p in args.paths.split(",") if p]

    def wanted(name):
        return not prefixes or any(name.startswith(p) for p in prefixes)

    k = args.top_k
    paths = {}
    extra = {}
    if any(wanted(n) for n in ("ivf", "forest", "flat", "sharded")):
        x, q = synthetic_gaussian(args.n, args.dim, n_clusters=1024,
                                  n_queries=args.queries, seed=0,
                                  normalized=True, query_noise=0.5)
        qd = torch.from_numpy(q).to(dev)
    if wanted("ivf") or wanted("sharded"):
        ivf = vt.IVFFlatIndex.build_index(args.clusters, 2, 10, x, device=dev)
        ivf._ensure_layout()
        paths["ivf nprobe=1"] = lambda: ivf.search_batch_device(qd, k, 1)
        paths["ivf nprobe=2"] = lambda: ivf.search_batch_device(qd, k, 2)
        paths["ivf nprobe=0 (adaptive)"] = lambda: ivf.search_batch_device(qd, k, 0)
    if wanted("forest") or wanted("sharded"):
        forest = vt.ANNIndex.build_index(8, 100, x, np.arange(len(x)), device=dev)
        paths["forest probes_per_tree=1"] = lambda: forest.search_batch_device(qd, k, 1)
        paths["forest probes_per_tree=4"] = lambda: forest.search_batch_device(qd, k, 4)
        paths["forest auto probes"] = lambda: forest.search_batch_device(qd, k)
    if wanted("flat"):
        flat = vt.FlatIndex(x, device=dev)
        bucket = vt.FlatIndex(x, config=vt.FlatConfig(engine="bucket"), device=dev)
        approx = vt.FlatIndex(x, config=vt.FlatConfig(engine="approx"), device=dev)
        paths["flat exact"] = lambda: flat.search_batch_device(qd, k)
        paths["flat bucket"] = lambda: bucket.search_batch_device(qd, k)
        paths["flat approx"] = lambda: approx.search_batch_device(qd, k)
    if wanted("sharded"):
        from vers_tpu_torch.parallel import make_mesh

        mesh = make_mesh(4, device=dev)
        blocks = np.array_split(np.arange(len(x)), 4)
        sivf = vt.ShardedIVFFlatIndex(
            args.clusters, ivf._centroids, [x[b[0] : b[-1] + 1] for b in blocks],
            blocks, mesh=mesh)
        sivf._ensure_state()
        sforest = vt.ShardedANNIndex(forest, mesh=mesh)
        sflat = vt.ShardedFlatIndex(x, mesh=mesh)
        paths["sharded ivf nprobe=2"] = (
            lambda: sivf._search_batch_rows(qd, k, 2))
        paths["sharded forest probes_per_tree=1"] = (
            lambda: sforest._search_batch_rows(qd, k, 1))
        paths["sharded flat exact"] = lambda: sflat.search_batch_device(qd, k)
    if wanted("hnsw"):
        import dataclasses

        hx, hq = synthetic_gaussian(args.n, args.dim, n_clusters=4096,
                                    n_queries=args.queries, seed=0,
                                    normalized=True, query_noise=0.5)
        hqd = torch.from_numpy(hq).to(dev)
        t0 = time.perf_counter()
        hnsw = vt.HNSWIndex.build_index_batched(12, 100, 32, 24, hx, device=dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hnsw._ensure_device_cache()
        torch.cuda.synchronize()
        extra["hnsw_build"] = dict(build_s=build_s, **hnsw.build_seconds,
                                   cache_s=time.perf_counter() - t0,
                                   layers=hnsw.get_num_nodes_in_layers())
        print(f"hnsw build: {extra['hnsw_build']}", flush=True)
        classic = vt.HNSWIndex.from_numpy(
            hx, hnsw._pending_graph, 100, 32, 12, 24,
            config=dataclasses.replace(hnsw.config, nav_inline_dp=None),
            device=dev)
        hs = hqd[:2048]
        paths["hnsw ef=32 inline"] = lambda: hnsw.search_batch_device(hqd, k)
        paths["hnsw ef=32 classic, 2048 queries"] = (
            lambda: classic.search_batch_device(hs, k))
        if args.hnsw_io:
            path = Path(__file__).resolve().parent.parent / "vers_tpu_torch" / \
                "_build" / "profile_hnsw.index"
            path.parent.mkdir(parents=True, exist_ok=True)
            try:
                t0 = time.perf_counter()
                hnsw.save_index(str(path))
                save_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                vt.HNSWIndex.load_index(str(path), device=dev)
                load_s = time.perf_counter() - t0
                extra["hnsw_io"] = dict(save_s=save_s, load_s=load_s,
                                        mb=path.stat().st_size / 1e6)
            finally:
                path.unlink(missing_ok=True)
            print(f"hnsw save/load: {extra['hnsw_io']}", flush=True)
    def eager(fn):
        def run():
            with graphs.disabled():
                return fn()
        return run

    for name in [n for n in paths
                 if not n.startswith(("flat", "sharded flat", "ivf nprobe=0"))]:
        paths[f"{name} eager"] = eager(paths[name])
    torch.cuda.synchronize()

    def reps_of(name):
        return 1 if name in ("flat exact", "flat approx",
                             "sharded flat exact") else args.reps

    # every unprofiled wall time first: once the profiler has run,
    # its tracing stays attached to the process and every later launch
    # costs the host more, which a search of ~1000 launches shows
    walls = {name: cuda_ms(torch, fn, reps_of(name))
             for name, fn in paths.items()}
    for name, fn in paths.items():
        if (name.startswith(("ivf", "forest")) and not name.endswith("eager")
                and not name.startswith("ivf nprobe=0")):
            chained, synced = chained_ms(torch, fn, args.depth)
            extra.setdefault("chained", {})[name] = dict(
                depth=args.depth, chained_ms=chained, synced_ms=synced,
                chained_qps=args.queries / chained * 1e3)
            print(f"== {name}: {args.depth} calls chained {chained:.3f} ms a "
                  f"call ({args.queries / chained * 1e3:.0f} qps), each "
                  f"drained {synced:.3f} ms a call", flush=True)
    results = {}
    for name, fn in paths.items():
        reps = reps_of(name)
        t0 = time.perf_counter()
        r = profile_path(torch, fn, reps, walls[name])
        results[name] = r
        print(f"== {name}, Q={args.queries}: wall {r['wall_ms']:.3f} ms/call, "
              f"profiled {r['profiled_ms']:.3f} ms/call, device busy "
              f"{r['busy_ms']:.3f} ms/call, idle share {r['idle_share']:.3f} "
              f"({reps} calls; {time.perf_counter() - t0:.1f} s)", flush=True)
        for a in r["activities"][: args.top]:
            print(f"    {a['ms']:9.3f} ms  x{a['calls']:6.1f}  {a['name'][:90]}")
    if args.traffic:
        searches = {}
        if wanted("ivf"):
            searches["ivf nprobe=2"] = (
                lambda q: ivf.search_batch_device(q, k, 2), ivf._graphs, qd)
        if wanted("forest"):
            searches["forest probes_per_tree=1"] = (
                lambda q: forest.search_batch_device(q, k, 1),
                forest._graphs, qd)
        if wanted("hnsw"):
            searches["hnsw ef=32 inline"] = (
                lambda q: hnsw.search_batch_device(q, k), hnsw._graphs, hqd)
        trace.enable()
        try:
            extra["traffic"] = traffic(torch, graphs, trace, searches,
                                       args.queries, args.trace_calls)
        finally:
            trace.disable()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=smi, args=vars(args), paths=results, **extra),
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
