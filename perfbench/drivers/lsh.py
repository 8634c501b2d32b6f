"""The random-hyperplane forest under test ("LSH" in the reference):
``vers_tpu_torch.ANNIndex``.

One run: the configuration's corpus (from its ``corpus_seed``) and the
pool of query batches (from the run's seed), made on the device
(``reference/data.py``); the program's one-time costs of a process paid
on a tiny index (``warm_program``); with ``--trace 1`` the program's
trace reset and switched on, so that the build's spans are recorded and
every graph is captured with its stage markers;
``ANNIndex.build_index(num_trees, max_node_size, corpus, arange(n),
config=LSHConfig(...), device=card)``, the corpus handed over from the
host as a user's is (timed alone, then with the first call of the cell
drained: ``build_s``); warm-up calls over the whole pool, so every graph
of the search has been captured and replayed; the window
(``bench/traffic.py``) through ``search_batch_device(q, k,
probes_per_tree=probes)`` (the queries on the device, ids and distances
back through pinned host buffers, one set a call in flight: the only
``queries`` this driver takes); then, with the window closed and the
memory peak read, the system freed and its answers judged against the
plain reference (``reference/forest.py``).

The judge reads the trees the program serves from through
``ANNIndex.forest_view()`` (hyperplanes, node tables, leaf membership
and sizes, each row's id), to judge them and to run the plain descent
over them; it recomputes everything else. A program without that view
cannot be judged: the run stops before its data is made.

What this driver declares to the shared code and the tests:

- ``CHECKS``: ``dist_err``, ``rank_gap``, ``stray_ids``, ``leaf_stray``,
  ``side_miss``, ``recall_gap`` (``reference/forest.py`` says what each
  is); ``side_miss`` asks for ``SELF_ROWS`` rows drawn from the seed,
  ``recall_gap`` compares on ``SAMPLE`` queries drawn from it;
- ``TRAFFIC``: ``probes``, each tree's probes a call
  (``probes_per_tree``; null: the program's default, the deficit rule);
- ``FAULTS``: ``stale`` (an earlier call's answers), ``half`` (only the
  first half of the trees searched), ``altered`` (every served distance
  raised by 1e-3), ``wrong_side`` (the first tree's root split inverted
  after the build), ``big_leaf`` (a build at four times the
  configuration's ``max_node_size``, served as the configuration's);
- ``SYSTEMS``: ``program``, and ``control``: the plain search over the
  program's own trees in its place, on rows rounded to bf16, serving
  those distances: the lower precision the check must fail;
- ``STAGES``: the stage table of the program's markers, the binned
  search's five, the HNSW search's four, then ``descend``, ``gather``,
  ``fold`` and ``forest.end`` (markers 9-12): what the forest's stage
  readers pass to ``bench/stages.stage_ms``.

``run.work`` holds, for each pool batch, kernel B's work as
``metrics/kernel_b_roofline.py`` counts it, from the plain descent's
probes: the live (query, tree, rank) pairs, the result rows, the
(pair, row) products over each pair's leaf and the rows of each tree's
distinct probed leaves, summed over the trees. ``run.build_s`` is the
build with the first call drained (logged; the cells are not listed
under ``build_s``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.bench.record import Run
from perfbench.bench.stages import STAGES as BINNED_STAGES
from perfbench.bench.trace import Tracer
from perfbench.bench.traffic import closed_loop
from perfbench.drivers.ivfflat import _faulty, _log, _sync
from perfbench.reference import data as refdata
from perfbench.reference import forest as refforest

CHECKS = ("dist_err", "rank_gap", "stray_ids", "leaf_stray", "side_miss",
          "recall_gap")
TRAFFIC = ("probes",)
FAULTS = ("stale", "half", "altered", "wrong_side", "big_leaf")
SYSTEMS = ("program", "control")
STAGES = BINNED_STAGES + ("route", "beam", "rescore", "beam.end",
                          "descend", "gather", "fold", "forest.end")
SELF_ROWS = 4096
SAMPLE = 4096
clock = time.perf_counter


def tiny(config: dict) -> dict:
    """``config`` at the sizes of the CPU tests: 3000 rows of 24, 4 trees,
    leaves under 32 rows (large against k = 10, as the published 100 is
    at 1M rows: under 16 rows most main leaves hold fewer than k, and the
    reference's rule takes branches that one probe a tree does not), 16
    clusters."""
    return dict(config, rows=3000, dim=24,
                lsh=dict(config["lsh"], num_trees=4, max_node_size=32),
                generator=dict(config["generator"], clusters=16))


def _program_trace():
    """The program's trace module, or None where the program has none."""
    try:
        from vers_tpu_torch import trace
    except ImportError:
        return None
    return trace


class Program:
    """``vers_tpu_torch.ANNIndex`` behind the calls the loop makes."""

    def __init__(self, cfg: dict, x: torch.Tensor, fault: str = None):
        from vers_tpu_torch import ANNIndex
        from vers_tpu_torch.config import LSHConfig

        lsh = cfg["lsh"]
        size = lsh["max_node_size"] * (4 if fault == "big_leaf" else 1)
        n = x.shape[0]
        self.index = ANNIndex.build_index(
            lsh["num_trees"], size, x.cpu().numpy(), np.arange(n),
            config=LSHConfig(num_trees=lsh["num_trees"], max_node_size=size,
                             seed=lsh["seed"]),
            device=x.device)
        self._view = None
        if fault == "wrong_side":
            tree = self.index._trees[0]
            tree.coeff[0] = -tree.coeff[0]
            tree.const[0] = -tree.const[0]
        elif fault == "half":
            self._view = self.index.forest_view()
            self.index._trees = self.index._trees[: lsh["num_trees"] // 2]
            self.index._sizes = None

    def search(self, q, k, probes):
        return self.index.search_batch_device(q, k, probes)

    def view(self):
        """The trees the configuration serves from, as the index holds
        them."""
        return self._view if self._view is not None else self.index.forest_view()


class Control:
    """The plain search over the program's own trees in the program's
    place, on rows rounded to bf16, serving those distances."""

    def __init__(self, cfg: dict, x: torch.Tensor, fault: str = None):
        prog = Program(cfg, x, fault)
        self._view = prog.view()
        del prog
        self.ref = refforest.Forest(self._view.trees, self._view.ids, x,
                                    precision="bf16")

    def search(self, q, k, probes):
        p, gate = probe_rule(self._view, k, probes)
        d, i = self.ref.search(q, k, p, gate)
        return d.float(), i

    def view(self):
        return self._view


def probe_rule(view, k: int, probes):
    """(probes a tree, the deficit gate's k or 0) for the traffic's
    ``probes``: as given, or (null) the program's default rule over the
    view's leaf sizes."""
    if probes is not None:
        return max(1, int(probes)), 0
    p = refforest.auto_probes([torch.tensor(t.leaf_sizes) for t in view.trees], k)
    return p, (k if p > 1 else 0)


def warm_program(device) -> None:
    """The program's one-time costs of a process, before the timed
    build: its kernel library and the card's libraries, by a build and a
    search of a tiny index."""
    from vers_tpu_torch import ANNIndex

    x = torch.randn((1024, 8), generator=refdata.generator(1, device), device=device)
    ANNIndex.build_index(2, 16, x.cpu().numpy(), np.arange(1024),
                         device=device).search_batch_device(x[:16], 4, 1)


def _altered(search):
    """``search`` with every served distance raised by 1e-3."""
    def broken(q, k, probes):
        d, i = search(q, k, probes)
        return d + 1e-3, i
    return broken


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, system: str = "program", fault: str = None) -> Run:
    from vers_tpu_torch import ANNIndex

    if not hasattr(ANNIndex, "forest_view"):
        raise RuntimeError("this program's ANNIndex has no forest_view(): "
                           "the check cannot read the trees it serves from")
    cfg, tr = cell.config, cell.traffic
    gen_cfg, lsh = cfg["generator"], cfg["lsh"]
    batch, n_pool = tr["batch"], tr["pool_batches"]
    k, probes, depth = tr["top_k"], tr["probes"], tr["depth"]
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
    sut = (Program if system == "program" else Control)(cfg, x, fault)
    _sync(device)
    build_index_s = clock() - t
    _log("build", build_index_s)
    split = getattr(getattr(sut, "index", None), "build_seconds", None)
    if split:
        _log(f"build: dedup on the host {split['dedup_host']:.3f} s, trees on "
             f"the device {split['trees_device']:.3f} s, tables on the host",
             split["tables_host"])
    search = sut.search
    if fault == "altered":
        search = _altered(search)
    elif fault == "stale":
        search = _faulty(search, fault, n)

    pinned = device.type == "cuda"
    slots = [(torch.empty((batch, k), dtype=torch.float32, pin_memory=pinned),
              torch.empty((batch, k), dtype=torch.int32, pin_memory=pinned))
             for _ in range(depth)]

    def issue(i):
        dist, ids = search(pool[i % n_pool], k, probes)
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
    view = sut.view()
    del sut, search, issue, collect
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    marks = [clock()]

    def mark(what):
        _sync(device)
        marks.append(clock())
        _log(what, marks[-1] - marks[-2])

    forest = refforest.Forest(view.trees, view.ids, x)
    p, gate = probe_rule(view, k, probes)
    mark(f"check: the trees ({forest.trees} trees, {forest.L} levels, leaves "
         f"up to {forest.span} rows; {p} probes a tree, gate {gate})")
    ids = torch.tensor(view.ids, device=device)
    self_rows = ids[torch.randperm(ids.shape[0], generator=refdata.generator(
        seed, device), device=device)[:SELF_ROWS]]
    sample = torch.randperm(queries.shape[0], generator=refdata.generator(
        seed + 1, device), device=device)[:SAMPLE]
    judged = refforest.judge(x, queries, torch.from_numpy(served_d).to(device),
                             torch.from_numpy(served_i).to(device), k, forest,
                             view.trees, p, gate, lsh["max_node_size"],
                             self_rows, sample, log=mark)
    work = None
    if trace:
        work = [refforest.scan_work(forest, forest.probes(q, p, gate), d, k)
                for q in pool]
        mark("check: kernel B's work")
    _log("check", clock() - t)
    return Run(batch=batch, window=win, setup_s=setup_s, build_s=build_s,
               build_index_s=build_index_s, judged=judged,
               trace=tracer.trace if tracer is not None else None, work=work,
               pool_batches=n_pool, memory_peak_bytes=memory_peak)
