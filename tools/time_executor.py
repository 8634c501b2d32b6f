#!/usr/bin/env python3
"""What running a mesh's shards at once costs the host, on one CUDA card.

``parallel/mesh.map_shards`` runs shard 0's body on the caller's thread
and every other shard's on a worker thread, each body holding the
mesh's host lock except while it waits for its stream. This times, on
a mesh of S shards of cuda:0:

  * one ``map_shards`` of S empty bodies (µs a call, the mean of 100
    calls after 10 warm-up calls), beside the same on a mesh of S CPU
    shards, which records and waits on no CUDA event: the difference is
    the events' share of the fixed cost;
  * 2000 tiny ops on the card (``y = y + 1`` on 64 floats) from each of
    S threads at once, without and with one lock around each thread's
    ops, beside one thread doing all S x 2000 (ms, wall clock, the card
    synchronised before and after). Each torch op lets go of the GIL,
    so threads that interleave op by op hand the interpreter over at
    every op; the lock is what ``Mesh.host`` does.

Prints one JSON line with the card's name and power limit.

Usage, from the repository root:

    python3 tools/time_executor.py [--shards S]

Needs one CUDA card; exits 2 without one.
"""

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_timing import card_line  # noqa: E402


def empty_map_us(map_shards, mesh, calls=100):
    def empty(s, dev):
        return None

    for _ in range(10):
        map_shards(mesh, empty)
    t0 = time.perf_counter()
    for _ in range(calls):
        map_shards(mesh, empty)
    return (time.perf_counter() - t0) / calls * 1e6


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_executor.py needs a CUDA card", file=sys.stderr)
        return 2
    from vers_tpu_torch.parallel.mesh import make_mesh, map_shards

    S = args.shards
    card = make_mesh(S, device="cuda:0")
    row = dict(card=card_line(), shards=S,
               empty_map_us=empty_map_us(map_shards, card),
               empty_map_cpu_us=empty_map_us(map_shards,
                                             make_mesh(S, device="cpu")))
    one = torch.zeros(64, device=card.lead)
    lock = threading.Lock()

    def ops(n=2000):
        y = one
        for _ in range(n):
            y = y + 1

    def locked_ops():
        with lock:
            ops()

    def wall_ms(fn, threads):
        ts = [threading.Thread(target=fn) for _ in range(threads)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    ops(10)
    row.update(one_thread_ms=wall_ms(lambda: [ops() for _ in range(S)], 1),
               threads_ms=wall_ms(ops, S),
               threads_one_lock_ms=wall_ms(locked_ops, S))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
