"""The HNSW system under test: ``vers_tpu_torch.HNSWIndex``.

One run: the configuration's corpus (from its ``corpus_seed``, padded on
the device to a multiple of 128 rows) and the pool of query batches
(from the run's seed), made on the device (``reference/data.py``); the
program's one-time costs of a process paid on a tiny index
(``warm_program``); with ``--trace 1`` the program's trace reset and
switched on (``vers_tpu_torch.trace``, where the program has one), so
that the build's span is recorded and every graph is captured with its
stage markers; ``HNSWIndex.build_index_device(num_layers,
ef_construction, ef, num_neighbours, corpus)`` on the device-resident
corpus with the default wave build (timed alone, then with the first
call of the cell drained: ``build_s``); the configuration's ``serving``
fields set on the index (in the published cell the defaults) and
``ef_search = ef``; the serving policy the index resolves checked
against the configuration's ``resolved`` one;
warm-up calls over the whole pool, so every graph of the search has been
captured and replayed; the window (``bench/traffic.py``), through
``search_batch_device`` (the queries on the device, ids and distances
back through pinned host buffers, one set a call in flight: the only
``queries`` this driver takes); then, with the window closed and the
memory peak read, the system freed and its outputs judged against the
plain reference (``reference/hnsw.py``).

The judge reads the graph the program serves from: each layer's padded
adjacency of the serving cache (``HNSWIndex._ensure_device_cache()``:
``adjs``, ``entry``, ``n1``) and each layer's members of the wave build
(``HNSWIndex._pending_graph``), to judge them and to run the plain search
over them; it recomputes everything else.

What this driver declares to the shared code and the tests:

- ``CHECKS``: ``dist_err``, ``stray_ids``, ``recall_gap``,
  ``graph_stray``, ``self_miss`` (``reference/hnsw.py`` says what each
  is); ``self_miss`` asks for ``SELF_ROWS`` rows drawn from the seed;
  ``graph_stray`` also counts each field of the served policy (the
  layer-0 cap, the inline width) that is not the configuration's
  ``resolved`` one, so a run that serves another deployment than the
  recorded one is not correct;
- ``TRAFFIC``: ``ef``, the search's beam width (``ef_search``), set by
  the sweep that picks the cell's operating point;
- ``FAULTS``: ``stale`` (an earlier call's answers), ``half`` (half a
  batch answered and repeated), ``altered`` (one answer's row changed),
  ``short_beam`` (the program's beam capped at 1 step:
  ``HNSWConfig.beam_steps=1``), ``random_edges`` (each layer-0 list's
  rows replaced by random rows before the serving cache is built);
- ``SYSTEMS``: ``program``, and ``control``: the plain search over the
  program's own graph in its place, on rows rounded to bf16, serving
  those distances (no f32 rescore): the lower precision the check must
  fail;
- ``STAGES``: the stage table of the program's markers on this path,
  the binned search's five, then ``route``, ``beam``, ``rescore`` and
  ``beam.end`` (markers 5-8): what the HNSW stage readers pass to
  ``bench/stages.stage_ms``.

``run.work`` holds, for each pool batch, the work of the routing scan as
``metrics/route_roofline.py`` counts it: the queries, the layer-1 rows
(``n1``), the width and the seeds (``route_seeds``, else min(ef, 8)).
``run.build_s`` is the build with the first call drained (logged; the
cell is not listed under ``build_s``, whose bound one build spreads too
wide for).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from perfbench.bench.record import Run
from perfbench.bench.stages import STAGES as BINNED_STAGES
from perfbench.bench.trace import Tracer
from perfbench.bench.traffic import closed_loop
from perfbench.drivers.ivfflat import _faulty, _log, _sync
from perfbench.reference import data as refdata
from perfbench.reference import hnsw as refhnsw

CHECKS = ("dist_err", "stray_ids", "recall_gap", "graph_stray", "self_miss")
TRAFFIC = ("ef",)
FAULTS = ("stale", "half", "altered", "short_beam", "random_edges")
SYSTEMS = ("program", "control")
STAGES = BINNED_STAGES + ("route", "beam", "rescore", "beam.end")
SELF_ROWS = 4096
clock = time.perf_counter


def tiny(config: dict) -> dict:
    """``config`` at the sizes of the CPU tests: 3000 rows of 24, 4
    layers, ef_construction 40, M 8, the inline beam forced at dp 16 and
    every list served at 12 at most, so the CPU runs take the cell's
    route: the scan router, the inline beam, the f32 rescore."""
    return dict(config, rows=3000, dim=24,
                hnsw=dict(config["hnsw"], num_layers=4, ef_construction=40,
                          num_neighbours=8),
                serving=dict(config["serving"], nav_inline_dp=16, max_degree=12),
                resolved=dict(config["resolved"], inline_dp=16, max_degree=12),
                generator=dict(config["generator"], clusters=16))


def _program_trace():
    """The program's trace module, or None where the program has none."""
    try:
        from vers_tpu_torch import trace
    except ImportError:
        return None
    return trace


class Program:
    """``vers_tpu_torch.HNSWIndex`` behind the calls the loop makes."""

    def __init__(self, cfg: dict, corpus: torch.Tensor, n: int, ef: int,
                 fault: str = None, seed: int = 0):
        from vers_tpu_torch import HNSWIndex

        h = cfg["hnsw"]
        self.index = HNSWIndex.build_index_device(
            h["num_layers"], h["ef_construction"], ef, h["num_neighbours"],
            corpus, n_valid=n)
        serving = dict(cfg["serving"], ef_search=ef)
        if fault == "short_beam":
            serving["beam_steps"] = 1
        self.index.config = dataclasses.replace(self.index.config, **serving)
        self.index.ef_search = ef
        if fault == "random_edges":
            mem, adj, dist = self.index._pending_graph[0]
            live = (adj >= 0) & np.isfinite(dist)
            rng = np.random.default_rng(seed % (1 << 63))
            adj = np.where(live, rng.integers(0, n, adj.shape), adj).astype(adj.dtype)
            self.index._pending_graph[0] = (mem, adj, dist)

    def search(self, q, k):
        return self.index.search_batch_device(q, k)

    def graph(self) -> dict:
        """The graph the index serves from: each layer's padded adjacency
        and members, the entry row, the layer-1 rows, the list width."""
        cache = self.index._ensure_device_cache()
        return dict(adjs=list(cache["adjs"]), entry=int(cache["entry"]),
                    members=[torch.from_numpy(np.asarray(m))
                             for m, _, _ in self.index._pending_graph],
                    n1=int(cache["n1"]), policy=cache["policy"],
                    seeds=getattr(self.index.config, "route_seeds", 0))


class Control:
    """The plain search over the program's own graph in the program's
    place, on rows rounded to bf16, serving those distances."""

    def __init__(self, cfg: dict, corpus: torch.Tensor, n: int, ef: int,
                 fault: str = None, seed: int = 0):
        prog = Program(cfg, corpus, n, ef, fault, seed)
        self._graph = prog.graph()
        del prog
        self.ef = ef
        self.ref = refhnsw.PlainHNSW(corpus, self._graph["adjs"],
                                     self._graph["entry"], precision="bf16")

    def search(self, q, k):
        d, i = self.ref.search(q, k, self.ef)
        return d.float(), i

    def graph(self) -> dict:
        return self._graph


def warm_program(device) -> None:
    """The program's one-time costs of a process, before the timed
    build: its kernel library and the card's libraries, by a build and a
    search of a tiny index."""
    from vers_tpu_torch import HNSWIndex

    x = refdata.normalize(torch.randn((1024, 8), generator=refdata.generator(
        1, device), device=device))
    HNSWIndex.build_index_device(3, 16, 16, 4, x).search_batch_device(x[:16], 4)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, system: str = "program", fault: str = None) -> Run:
    cfg, tr = cell.config, cell.traffic
    gen_cfg, h = cfg["generator"], cfg["hnsw"]
    batch, n_pool = tr["batch"], tr["pool_batches"]
    k, ef, depth = tr["top_k"], tr["ef"], tr["depth"]
    if tr["queries"] != "device":
        raise ValueError(f"queries {tr['queries']!r}: this driver serves "
                         "queries on the device")
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")

    x, queries = refdata.gaussian_clusters(
        refdata.generator(gen_cfg["corpus_seed"], device),
        refdata.generator(seed, device), cfg["rows"], cfg["dim"],
        gen_cfg["clusters"], batch * n_pool, cfg["normalized"],
        gen_cfg["query_noise"])
    n, d = x.shape
    corpus = torch.zeros((-(-n // 128) * 128, d), device=device)
    corpus[:n] = x
    del x
    pool = list(queries.split(batch))
    if system == "program":
        warm_program(device)
    program_trace = _program_trace() if trace else None
    if program_trace is not None:
        program_trace.reset()
        program_trace.enable()
    _sync(device)
    _log("data", clock() - t0)

    t = clock()
    sut = (Program if system == "program" else Control)(cfg, corpus, n, ef,
                                                        fault, seed)
    _sync(device)
    _log("build", clock() - t)
    split = getattr(getattr(sut, "index", None), "build_seconds", None)
    if split:
        _log(f"build: upload {split['upload_s']:.3f} s, waves "
             f"({split['waves']}) {split['waves_s']:.3f} s, graph to the host",
             split["graph_to_host_s"])
    search = sut.search
    if fault in ("stale", "half", "altered"):
        broken = _faulty(lambda q, k_, _: sut.search(q, k_), fault, n)

        def search(q, k_):
            return broken(q, k_, None)

    pinned = device.type == "cuda"
    slots = [(torch.empty((batch, k), dtype=torch.float32, pin_memory=pinned),
              torch.empty((batch, k), dtype=torch.int32, pin_memory=pinned))
             for _ in range(depth)]

    def issue(i):
        dist, ids = search(pool[i % n_pool], k)
        hd, hi = slots[i % depth]
        hd.copy_(dist, non_blocking=True)
        hi.copy_(ids.to(torch.int32), non_blocking=True)
        done = torch.cuda.Event() if pinned else None
        if done is not None:
            done.record()
        return done, hd, hi

    def collect(handle):
        done, hd, hi = handle
        if done is not None:
            done.synchronize()
        return hd, hi

    def never(i):
        return False

    closed_loop(issue, collect, depth, float("inf"), never, max_calls=1)
    build_s = clock() - t
    _log("build and first call", build_s)
    graph = sut.graph()
    r = cfg["resolved"]
    policy_stray = sum(a != b for a, b in zip(graph["policy"],
                                              (r["max_degree"], r["inline_dp"])))
    if policy_stray:
        print(f"perfbench: the serving policy {graph['policy']} is not the "
              f"configuration's ({r['max_degree']}, {r['inline_dp']})",
              file=sys.stderr, flush=True)
    # warm-up: the control has no graphs to capture
    closed_loop(issue, collect, depth, float("inf"), never,
                max_calls=tr["warmup_calls"] if system == "program" else 0)
    if trace and device.type == "cuda":
        Tracer.warm()
    _sync(device)

    # the kept calls: pool_batches in a row (each batch once), from an
    # offset drawn from the seed
    off = int(np.random.default_rng(seed % (1 << 63)).integers(n_pool))

    def keep(i):
        return off <= i < off + n_pool

    tracer = Tracer(tr["trace_start"] * seconds, tr["trace_calls"]) if trace else None
    setup_s = clock() - t0
    win = closed_loop(issue, collect, depth, seconds, keep, tracer=tracer,
                      min_calls=off + n_pool)
    _sync(device)
    if program_trace is not None:
        program_trace.disable()
    _log(f"setup {setup_s:.3f} s; window ({len(win.calls)} calls)",
         clock() - win.start)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    t = clock()

    served_d = np.empty((batch * n_pool, k), np.float32)
    served_i = np.empty((batch * n_pool, k), np.int64)
    for i, (dist, ids) in win.kept.items():
        b = (i % n_pool) * batch
        served_d[b:b + batch] = np.asarray(dist)
        served_i[b:b + batch] = np.asarray(ids)
    del sut, search, issue, collect
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    marks = [clock()]

    def mark(what):
        _sync(device)
        marks.append(clock())
        _log(what, marks[-1] - marks[-2])

    self_rows = torch.randperm(n, generator=refdata.generator(seed, device),
                               device=device)[:SELF_ROWS]
    caps = refhnsw.served_caps(h["num_layers"], h["num_neighbours"],
                               r["max_degree"])
    judged = refhnsw.judge(corpus, n, queries,
                           torch.from_numpy(served_d).to(device),
                           torch.from_numpy(served_i).to(device), k, ef,
                           graph["adjs"], graph["members"], caps,
                           graph["entry"], self_rows, log=mark)
    judged["graph_stray"] += policy_stray
    _log("check", clock() - t)

    work = None
    if trace:
        seeds = graph["seeds"] or min(ef, 8)
        work = [dict(q_n=q.shape[0], n1=graph["n1"], d=d, k=min(seeds, ef))
                for q in queries.split(batch)]
    return Run(batch=batch, window=win, setup_s=setup_s, build_s=build_s,
               judged=judged,
               trace=tracer.trace if tracer is not None else None, work=work,
               pool_batches=n_pool, memory_peak_bytes=memory_peak)
