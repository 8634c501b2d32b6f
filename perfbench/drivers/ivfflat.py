"""The IVFFlat system under test: ``vers_tpu_torch.IVFFlatIndex``.

One run: the configuration's corpus (from its ``corpus_seed``) and the
pool of query batches (from the run's seed) made on the device
(``reference/data.py``); the program's one-time costs of a process paid
on a tiny index (``warm_program``); ``IVFFlatIndex.build_index(nlist,
attempts, iterations, x)`` on the device-resident corpus (timed alone,
then with the first call of the cell drained: ``build_s``; the traffic's
``builds`` times in all, the others once the check is done); warm-up
calls over the whole pool, so every shape has run, captured and replayed
its CUDA graph; the window (``bench/traffic.py``); then, with the window
closed and the memory peak read, the system freed and its outputs judged
against the plain reference (``reference/ivf.py``).

Queries on the device go through ``search_batch_device`` and their ids
and distances come back through pinned host buffers, one set a call in
flight; queries on the host go through ``search_batch``. The judge reads
the index's centroids and each row's list to judge them and the served
answers, and recomputes everything else.

The build is judged against the plain reference's own build at f32
(``cost_gap``), which runs after the judge, from the run's seed.

``system="control"`` puts the plain reference at TF32 in the program's
place; ``fault`` breaks the build or the served answers (``FAULTS``);
the tests and ``calibrate.py`` use both, the benchmark's own runs
neither.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from perfbench.bench.record import Run
from perfbench.bench.trace import Tracer
from perfbench.bench.traffic import closed_loop
from perfbench.reference import data as refdata
from perfbench.reference import ivf as refivf

# What this driver declares to the shared code and the tests: the
# limits of its check (each a number of ``run``'s ``judged``), its
# traffic keys beyond ``bench/traffic.COMMON`` (``nprobe``, each call's
# lists to probe; ``builds``, the builds that ``build_s`` is the mean of),
# the faults ``run`` plants, and the systems it can put under test.
CHECKS = ("assign_gap", "dist_err", "rank_gap", "stray_ids", "cost_gap")
TRAFFIC = ("nprobe", "builds")
FAULTS = ("stale", "half", "altered", "no_lloyd")
SYSTEMS = ("program", "control")
clock = time.perf_counter


def tiny(config: dict) -> dict:
    """``config`` at the sizes of the CPU tests: 3000 rows of 24, 32
    lists, 16 clusters."""
    return dict(config, rows=3000, dim=24, ivf=dict(config["ivf"], nlist=32),
                generator=dict(config["generator"], clusters=16))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(what: str, seconds: float) -> None:
    print(f"perfbench: {what} {seconds:.3f} s", file=sys.stderr, flush=True)


class Program:
    """``vers_tpu_torch.IVFFlatIndex`` behind the calls the loop makes."""

    def __init__(self, cfg: dict, x: torch.Tensor, iterations: int):
        from vers_tpu_torch import IVFFlatIndex

        ivf = cfg["ivf"]
        self.index = IVFFlatIndex.build_index(ivf["nlist"], ivf["attempts"],
                                              iterations, x)
        self.enqueue_s = []
        inner = self.index.search_batch_device

        def timed(*args, **kw):  # the benchmark's span around the call
            t = clock()
            out = inner(*args, **kw)
            self.enqueue_s.append(clock() - t)
            return out

        # search_batch calls it too, so host calls are timed alike
        self.index.search_batch_device = timed

    def search_device(self, q, k, nprobe):
        return self.index.search_batch_device(q, k, nprobe)

    def search_host(self, q, k, nprobe):
        res = self.index.search_batch(q, k, nprobe)
        return res.distances, res.ids

    def state(self):
        """(centroids, each row's list) as the index holds them."""
        idx = self.index
        c = idx._centroids if idx._centroids is not None else idx._centroids_dev
        a = (idx._assignments if idx._assignments is not None
             else idx._assign_dev[: idx._n_valid])
        return torch.as_tensor(c).float(), torch.as_tensor(a).long()


class Control:
    """The plain reference at TF32 in the program's place."""

    def __init__(self, cfg: dict, x: torch.Tensor, iterations: int):
        ivf = cfg["ivf"]
        self.ref = refivf.PlainIVF.build(x, ivf["nlist"], ivf["attempts"],
                                         iterations, seed=0, precision="tf32")
        self.enqueue_s = []

    def search_device(self, q, k, nprobe):
        t = clock()
        out = self.ref.search(q, k, nprobe)
        self.enqueue_s.append(clock() - t)
        return out

    def search_host(self, q, k, nprobe):
        d, i = self.search_device(torch.as_tensor(q, device=self.ref.x.device),
                                  k, nprobe)
        return d.cpu().numpy(), i.cpu().numpy()

    def state(self):
        return self.ref.centroids, self.ref.lists


def warm_program(device) -> None:
    """The program's one-time costs of a process, before the timed
    build: its kernel library (built on a checkout's first run, loaded
    on every run) and the card's libraries, by a search of a tiny index."""
    from vers_tpu_torch import IVFFlatIndex

    x = torch.randn((1024, 8), generator=refdata.generator(1, device), device=device)
    IVFFlatIndex.build_index(4, 1, 2, x).search_batch_device(x[:16], 4, 1)


def _faulty(search, fault: str, n: int):
    """``search`` with its answers broken: ``stale`` hands back the last
    call's answers (its state unchanged), ``half`` answers the first half
    of the batch and repeats it for the rest, ``altered`` serves another
    row in the first query's first place. (``no_lloyd``, the build's
    state left unchanged, builds with no Lloyd step: see ``run``.)"""
    last = []

    def broken(q, k, nprobe):
        if fault == "half":
            h = (q.shape[0] + 1) // 2
            d, i = search(q[:h], k, nprobe)
            cat = np.concatenate if isinstance(d, np.ndarray) else torch.cat
            return cat([d, d])[: q.shape[0]], cat([i, i])[: q.shape[0]]
        d, i = search(q, k, nprobe)
        if fault == "stale":
            if last:
                d, i = last[0]
            last[:] = [(d, i)]
        elif fault == "altered":
            i = i.copy() if isinstance(i, np.ndarray) else i.clone()
            i[0, 0] = (i[0, 0] + 1) % n
        return d, i

    return broken


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, system: str = "program", fault: str = None) -> Run:
    cfg, tr = cell.config, cell.traffic
    gen_cfg = cfg["generator"]
    batch, n_pool = tr["batch"], tr["pool_batches"]
    k, nprobe, depth = tr["top_k"], tr["nprobe"], tr["depth"]
    on_host = tr["queries"] == "host"

    x, queries = refdata.gaussian_clusters(
        refdata.generator(gen_cfg["corpus_seed"], device),
        refdata.generator(seed, device), cfg["rows"], cfg["dim"],
        gen_cfg["clusters"], batch * n_pool, cfg["normalized"],
        gen_cfg["query_noise"])
    pool = list(queries.split(batch))
    if on_host:
        pool = [p.cpu().numpy() for p in pool]
    if system == "program":
        warm_program(device)
    _sync(device)
    _log("data", clock() - t0)

    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    ivf = cfg["ivf"]
    t = clock()
    sut = (Program if system == "program" else Control)(
        cfg, x, 0 if fault == "no_lloyd" else ivf["iterations"])
    _sync(device)
    build_index_s = clock() - t
    search = sut.search_host if on_host else sut.search_device
    if fault not in (None, "no_lloyd"):
        search = _faulty(search, fault, cfg["rows"])

    if on_host:
        def issue(i):
            return search(pool[i % n_pool], k, nprobe)

        def collect(answer):
            return answer
    else:
        pinned = device.type == "cuda"
        slots = [(torch.empty((batch, k), dtype=torch.float32, pin_memory=pinned),
                  torch.empty((batch, k), dtype=torch.int32, pin_memory=pinned))
                 for _ in range(depth)]

        def issue(i):
            d, ids = search(pool[i % n_pool], k, nprobe)
            hd, hi = slots[i % depth]
            ids = ids.to(torch.int32)
            hd.copy_(d, non_blocking=True)
            hi.copy_(ids, non_blocking=True)
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
    _log("build", build_index_s)
    _log("build and first call", build_s)
    closed_loop(issue, collect, depth, float("inf"), never,
                max_calls=tr["warmup_calls"])
    sut.enqueue_s.clear()
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
    _log(f"setup {setup_s:.3f} s; window ({len(win.calls)} calls)",
         clock() - win.start)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    t = clock()

    served_d = np.empty((batch * n_pool, k), np.float32)
    served_i = np.empty((batch * n_pool, k), np.int64)
    for i, (d, ids) in win.kept.items():
        b = (i % n_pool) * batch
        served_d[b:b + batch] = np.asarray(d)
        served_i[b:b + batch] = np.asarray(ids)
    centroids, lists = (s.to(device) for s in sut.state())
    enqueue_s = list(sut.enqueue_s)
    del sut, search, issue, collect
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    marks = [clock()]

    def mark(what):
        _sync(device)
        marks.append(clock())
        _log(what, marks[-1] - marks[-2])

    judged = refivf.judge(x, queries, centroids, lists,
                          torch.from_numpy(served_d).to(device),
                          torch.from_numpy(served_i).to(device), k, nprobe,
                          log=mark)
    judged["cost_gap"] = refivf.cost_gap(x, centroids, lists, ivf["nlist"],
                                         ivf["attempts"], ivf["iterations"], seed)
    mark("check: the build's cost")
    _log("check", clock() - t)

    # build_s and build_index_s are means over the cell's ``builds``: the
    # one that served the window and, with the check done, the rest, each
    # a new index from the same corpus with its first call drained, freed
    # before the next
    timed = [(build_index_s, build_s)]
    for j in range(1, tr["builds"]):
        t = clock()
        sut = (Program if system == "program" else Control)(
            cfg, x, 0 if fault == "no_lloyd" else ivf["iterations"])
        _sync(device)
        index_s = clock() - t
        if on_host:
            sut.search_host(pool[0], k, nprobe)
        else:
            [a.cpu() for a in sut.search_device(pool[0], k, nprobe)]
        timed.append((index_s, clock() - t))
        _log(f"build {j + 1} of {tr['builds']}", index_s)
        _log(f"build {j + 1} and first call", timed[-1][1])
        del sut
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    build_index_s, build_s = (sum(b) / len(timed) for b in zip(*timed))
    work = None
    if trace and nprobe > 0:
        sizes = torch.bincount(lists, minlength=centroids.shape[0])
        work = []
        for q in queries.split(batch):
            probes = refivf.sq_dist(q, centroids, "f32").topk(
                nprobe, largest=False).indices
            work.append(dict(live_rows=q.shape[0] * nprobe,
                             out_rows=q.shape[0] * nprobe,
                             scanned=int(sizes[probes].sum()),
                             probed_rows=int(sizes[probes.unique()].sum()),
                             d=cfg["dim"], k=k))
    return Run(batch=batch, window=win, setup_s=setup_s, build_s=build_s,
              build_index_s=build_index_s, enqueue_s=enqueue_s, judged=judged,
              trace=tracer.trace if tracer is not None else None, work=work,
              pool_batches=n_pool, memory_peak_bytes=memory_peak)
