"""The mesh's executor (``parallel/mesh.map_shards``, the port's
``shard_map``) on an 8-shard CPU mesh, as the parity tests run it: one
host thread a shard (shard 0's the caller's), all at once, each holding
the mesh's host lock except where it waits (``core.host_released``).

- the results come back in shard order whatever order the bodies finish
  in, each body on a thread of its own, shard 0's the caller's
  (``current_shard`` names it);
- a body that raises makes the call raise after every body has joined,
  the lowest failing shard's exception first, and no merge runs;
- ``psum`` over the executor is bit-identical to the shard-order sum;
- the replica caches of the query-sharded forest and HNSW are filled by
  the caller, once a device, before the shards start;
- the kernels' launch counters count exactly under 8 threads;
- ``binned.captured_scans(shard=)`` records one shard's scans only.

The card's side (streams, events) is in ``tests/test_torch_cuda.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from vers_tpu_torch.core import count, host_released
from vers_tpu_torch.index.hnsw import HNSWIndex
from vers_tpu_torch.index.lsh import ANNIndex
from vers_tpu_torch.ops import binned, cuda_binned, cuda_bucket, cuda_topk
from vers_tpu_torch.ops.kmeans import partial_sums
from vers_tpu_torch.parallel import (
    ShardedANNIndex,
    ShardedHNSWIndex,
    make_mesh,
    shard_rows,
    sharded_lloyd_step,
    sharded_topk,
)
from vers_tpu_torch.parallel import hnsw as hnsw_mod
from vers_tpu_torch.parallel import lsh as lsh_mod
from vers_tpu_torch.parallel import search as search_mod
from vers_tpu_torch.parallel.kmeans import _psum_partials
from vers_tpu_torch.parallel.mesh import current_shard, map_shards

torch.set_num_threads(2)

S = 8
WAIT = 30.0  # seconds a body waits for another before the test fails


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(S, device="cpu")


def test_results_in_shard_order_when_bodies_finish_in_reverse(mesh):
    # shard s finishes only after shard s + 1 has: the reverse of shard
    # order, which also needs every body running at once
    done = [threading.Event() for _ in range(S)]
    finished = []

    def body(s, dev, tag):
        with host_released():
            if s + 1 < S:
                assert done[s + 1].wait(WAIT)
            time.sleep(0.01 * (S - s))  # and lower shards sleep longer
        finished.append(s)
        done[s].set()
        return s, tag, dev, current_shard(), threading.get_ident()

    out = map_shards(mesh, body, [f"t{s}" for s in range(S)])
    assert finished == list(range(S))[::-1]
    assert [o[:4] for o in out] == [
        (s, f"t{s}", torch.device("cpu"), s) for s in range(S)]
    # shard 0's body on the caller's thread, each other one on its own
    threads = [o[4] for o in out]
    assert threads[0] == threading.get_ident()
    assert len(set(threads)) == S
    assert current_shard() is None


def test_every_body_runs_at_once(mesh):
    barrier = threading.Barrier(S, timeout=WAIT)

    def body(s, dev):
        with host_released():
            return barrier.wait() >= 0

    assert map_shards(mesh, body) == [True] * S


def test_bodies_hold_the_host_between_waits(mesh):
    # at most one body runs outside host_released at any time
    inside, most = [0], [0]
    lock = threading.Lock()

    def body(s, dev):
        for _ in range(3):
            with lock:
                inside[0] += 1
                most[0] = max(most[0], inside[0])
            time.sleep(0.005)
            with lock:
                inside[0] -= 1
            with host_released():
                time.sleep(0.005)
        return s

    assert map_shards(mesh, body) == list(range(S))
    assert most[0] == 1
    assert not mesh.host.locked()


def test_lowest_failing_shard_raises_after_all_join(mesh):
    raised5 = threading.Event()
    finished = set()

    def body(s, dev):
        if s == 5:
            raised5.set()
            raise ValueError("shard 5")
        with host_released():
            if s == 2:  # fails after shard 5 has
                assert raised5.wait(WAIT)
                raise KeyError("shard 2")
            time.sleep(0.2)
        finished.add(s)
        return s

    with pytest.raises(KeyError, match="shard 2"):
        map_shards(mesh, body)
    assert finished == set(range(S)) - {2, 5}
    # the pool is whole again
    assert map_shards(mesh, lambda s, dev: s) == list(range(S))


def test_a_failing_shard_makes_the_search_raise_before_the_merge(
        mesh, monkeypatch):
    x = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    parts, counts = shard_rows(x, mesh)
    real = search_mod.distance_topk
    merged = []

    def scan(*a, **kw):
        if current_shard() == 3:
            raise RuntimeError("shard 3's scan")
        return real(*a, **kw)

    monkeypatch.setattr(search_mod, "distance_topk", scan)
    monkeypatch.setattr(search_mod, "merge_topk",
                        lambda *a: merged.append(a))
    with pytest.raises(RuntimeError, match="shard 3's scan"):
        sharded_topk(x[:5], parts, counts, 4, mesh)
    assert merged == []


def test_map_shards_checks_its_arguments(mesh):
    with pytest.raises(ValueError, match="7 per-shard arguments"):
        map_shards(mesh, lambda s, dev, a: a, list(range(7)))
    # shard 0's body runs on the caller's thread: it has no worker
    for s in (0, S):
        with pytest.raises(ValueError, match=f"shard {s} has no worker"):
            mesh.submit(s, print)

    def nested(s, dev):
        with pytest.raises(RuntimeError, match="inside a shard's body"):
            map_shards(mesh, lambda s2, dev2: s2)
        return s

    assert map_shards(mesh, nested) == list(range(S))


def test_psum_over_the_executor_is_the_shard_order_sum(mesh):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3001, 16)) * 100).astype(np.float32)
    parts, counts = shard_rows(x, mesh)
    c = torch.from_numpy(x[::300].copy())
    got = _psum_partials(parts, counts, c, mesh, 64)
    serial = [partial_sums(p, int(n), c, 64) for p, n in zip(parts, counts)]
    for j, g in enumerate(got):
        want = serial[0][j].clone()
        for part in serial[1:]:
            want = want + part[j]
        assert torch.equal(g, want), j
    new, cost = sharded_lloyd_step(parts, counts, c, mesh, chunk_size=64)
    again, cost2 = sharded_lloyd_step(parts, counts, c, mesh, chunk_size=64)
    assert torch.equal(new, again) and torch.equal(cost, cost2)


class _CountingDict(dict):
    def __init__(self):
        super().__init__()
        self.writes = []

    def __setitem__(self, key, value):
        self.writes.append((key, threading.get_ident()))
        super().__setitem__(key, value)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 16)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ["forest", "hnsw"])
def test_replica_caches_are_filled_once_a_device_by_the_caller(
        mesh, monkeypatch, rows, kind):
    if kind == "forest":
        base = ANNIndex.build_index(3, 24, rows, np.arange(len(rows)),
                                    device="cpu")
        sharded, mod = ShardedANNIndex(base, mesh=mesh), lsh_mod
    else:
        base = HNSWIndex.build_index(3, 16, 16, 4, rows, device="cpu")
        sharded, mod = ShardedHNSWIndex(base, mesh=mesh), hnsw_mod
    want = sharded.search_batch(rows[:40], 5)
    # the base seen on another device than the shards': every shard
    # searches a replica
    monkeypatch.setattr(mod, "normalize_device",
                        lambda d: torch.device("meta"))
    sharded._replicas = _CountingDict()
    for _ in range(2):
        got = sharded.search_batch(rows[:40], 5)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.distances, want.distances)
    assert sharded._replicas.writes == [
        (torch.device("cpu"), threading.get_ident())]


@pytest.mark.parametrize("module, counter, route", [
    (cuda_topk, "LAUNCHES_BY_ROUTE", "f32/highest"),
    (cuda_topk, "LAUNCHES_VALUES", None),
    (cuda_topk, "LARGE_K_PLAIN", None),
    (cuda_topk, "LARGE_K_PLAIN_VALUES", None),
    (cuda_binned, "LAUNCHES", None),
    (cuda_binned, "LARGE_K_PLAIN", None),
    (cuda_bucket, "LAUNCHES", None),
])
def test_launch_counters_count_exactly_under_threads(
        mesh, monkeypatch, module, counter, route):
    # each counter moves as its wrapper moves it: core.count on the
    # module's globals, or on kernel A's dict of counts by route
    n = 30_000
    monkeypatch.setattr(module, counter, 0 if route is None else {})

    def body(s, dev):
        with host_released():  # the 8 bodies count at once
            for _ in range(n):
                if route is None:
                    count(vars(module), counter)
                else:
                    count(module.LAUNCHES_BY_ROUTE, route)

    map_shards(mesh, body)
    got = getattr(module, counter) if route is None else module.launches()
    assert got == S * n


def test_captured_scans_of_one_shard(mesh, rows):
    base = ANNIndex.build_index(3, 24, rows, np.arange(len(rows)),
                                device="cpu")
    sharded = ShardedANNIndex(base, mesh=mesh)
    with binned.captured_scans() as every, \
            binned.captured_scans(shard=5) as fifth, \
            binned.captured_scans(only=(1,), shard=0) as first:
        sharded.search_batch(rows[: 64 * S], 5, 1)
    assert len(every) == S * 3 and len(fifth) == 3 and len(first) == 1
    # query shard 5's scans stack its own block of queries (and zero rows)
    q5 = {tuple(r) for r in rows[64 * 5: 64 * 6].tolist()}
    for args, _ in fifth:
        stacked = {tuple(r) for r in args[0].tolist() if any(r)}
        assert stacked and stacked <= q5
