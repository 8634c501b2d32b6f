"""A driver of another index, for the tests only: what a new
``drivers/<index>.py`` declares and runs, on a system small enough for
the CPU. The tests register it as ``perfbench.drivers.stubflat``.

The system under test scans the corpus in chunks of ``chunk_rows`` rows
(its own traffic key) and keeps the k nearest rows of each query. Its
check has limits of its own: ``dist_gap``, the widest gap between a
served distance and the exact distance of the row served beside it, and
``order_gap``, the widest excess of the i-th served row's exact distance
over the i-th nearest row's, both as shares of ``|q|^2 + mean |x|^2``
(f64). Its one fault, ``shifted``, serves the next row in the first
query's first place. It has no control and no traced slice.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.bench.record import Run
from perfbench.bench.traffic import closed_loop
from perfbench.reference import data as refdata

CHECKS = ("dist_gap", "order_gap")
TRAFFIC = ("chunk_rows",)
FAULTS = ("shifted",)
SYSTEMS = ("program",)


def tiny(config: dict) -> dict:
    return dict(config, rows=2000, dim=16,
                generator=dict(config["generator"], clusters=8))


def scan(x: torch.Tensor, q: torch.Tensor, k: int, chunk: int):
    """(squared distances, ids) of the k nearest rows, nearest first."""
    best_d = best_i = None
    for start in range(0, x.shape[0], chunk):
        part = x[start:start + chunk]
        d = (q * q).sum(1, keepdim=True) - 2 * q @ part.T + (part * part).sum(1)
        i = torch.arange(start, start + part.shape[0], device=x.device).expand_as(d)
        if best_d is not None:
            d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
        best_d, pick = d.topk(min(k, d.shape[1]), largest=False)
        best_i = i.gather(1, pick)
    return best_d, best_i


def judge(x, queries, served_d, served_i) -> dict:
    x64, q64 = x.double(), queries.double()
    exact = torch.cdist(q64, x64).square()
    scale = (q64 * q64).sum(1) + (x64 * x64).sum(1).mean()
    got = exact.gather(1, served_i)
    nearest = exact.topk(served_i.shape[1], largest=False).values
    dist_gap = (served_d.double() - got).abs().amax(1) / scale
    order_gap = (got.sort(1).values - nearest).clamp_min(0).amax(1) / scale
    return {"dist_gap": float(dist_gap.max()), "order_gap": float(order_gap.max())}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, system: str = "program", fault: str = None) -> Run:
    if system not in SYSTEMS or fault not in FAULTS + (None,):
        raise ValueError(f"no system {system!r} with fault {fault!r}")
    cfg, tr = cell.config, cell.traffic
    batch, n_pool, k = tr["batch"], tr["pool_batches"], tr["top_k"]
    x, queries = refdata.gaussian_clusters(
        refdata.generator(cfg["generator"]["corpus_seed"], device),
        refdata.generator(seed, device), cfg["rows"], cfg["dim"],
        cfg["generator"]["clusters"], batch * n_pool, cfg["normalized"],
        cfg["generator"]["query_noise"])
    pool = list(queries.split(batch))

    def issue(i):
        d, ids = scan(x, pool[i % n_pool], k, tr["chunk_rows"])
        if fault == "shifted":
            ids = ids.clone()
            ids[0, 0] = (ids[0, 0] + 1) % cfg["rows"]
        return d, ids

    def collect(answer):
        return answer

    closed_loop(issue, collect, tr["depth"], float("inf"), lambda i: False,
                max_calls=tr["warmup_calls"])
    off = int(np.random.default_rng(seed % (1 << 63)).integers(n_pool))
    setup_s = time.perf_counter() - t0
    win = closed_loop(issue, collect, tr["depth"], seconds,
                      lambda i: off <= i < off + n_pool, min_calls=off + n_pool)
    order = sorted(win.kept, key=lambda i: i % n_pool)
    served_d = torch.from_numpy(np.concatenate([win.kept[i][0] for i in order]))
    served_i = torch.from_numpy(np.concatenate([win.kept[i][1] for i in order]))
    return Run(batch=batch, window=win, setup_s=setup_s,
               judged=judge(x, queries, served_d, served_i), pool_batches=n_pool)
