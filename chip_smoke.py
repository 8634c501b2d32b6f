#!/usr/bin/env python3
"""Smoke run of vers_tpu_torch on one CUDA card, at full size.

Drives the port's main path once through the entry points a user
calls, at the reference dataset's shape (1M x 300 f32, k = 2048
clusters, 16384 queries; the corpus is ``synthetic_gaussian`` from a
seed, as bench.py makes it when the wiki file is absent):

  1. exact ground truth with ``FlatIndex`` (kernel A),
  2. ``IVFFlatIndex.build_index(2048, 2, 10, ...)``,
  3. ``search_batch`` over nprobe 1, 2, 4, 8 until recall@10 >= 0.95
     (kernel B), then the adaptive nprobe=0, ``search_approximate``,
     ``add`` + search for the added row, and a save/load round trip.

Both kernel launch counters are zeroed just before that run and must
have moved by its end. The packed-scan inputs of the main path's own
searches (each nprobe of the sweep, and the adaptive nprobe=0) are
captured as they pass. Then each kernel is held against its plain torch
version on the card at the main path's shapes (kernel A: all 16384
queries over the whole corpus, k = 10; kernel B: the captured scans),
tie-aware, distances within 1e-4, and both are timed with CUDA events.

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
K_CLUSTERS = 2048
DEVICE = "cuda:0"
TARGET_RECALL = 0.95
TOL = 1e-4  # distances: f32 sums in other orders, TF32 off
ROOT = Path(__file__).resolve().parent


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=3):
    """Mean milliseconds per call on the card's timeline, after one
    warm-up call."""
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


@contextlib.contextmanager
def captured_scans(binned):
    """Record the arguments of every packed-scan call the search path
    makes inside the block; the calls themselves go through unchanged."""
    calls = []
    scan = binned.packed_scan

    def record(*args, **kw):
        calls.append((args, kw))
        return scan(*args, **kw)

    binned.packed_scan = record
    try:
        yield calls
    finally:
        binned.packed_scan = scan


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    import vers_tpu_torch as vt
    from vers_tpu_torch.ops import _build, binned, cuda_binned, cuda_topk
    from vers_tpu_torch.ops.topk import fused_scan_topk
    from vers_tpu_torch.utils.data import synthetic_gaussian
    from vers_tpu_torch.utils.harness import search_exhaustive
    from vers_tpu_torch.utils.parity import assert_topk_match, max_abs_diff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device(DEVICE)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- build the kernels -------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info['seconds']:.2f} s) -> {_build.library_path().name}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # -- data --------------------------------------------------------
    t0 = time.perf_counter()
    x, q = synthetic_gaussian(N, DIM, n_clusters=1024, n_queries=N_QUERIES,
                              seed=0, normalized=True, query_noise=0.5)
    qd = torch.from_numpy(q).to(dev)
    log(f"data: {N} x {DIM} corpus, {N_QUERIES} queries "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- the main path, counted --------------------------------------
    cuda_topk.LAUNCHES = 0
    cuda_binned.LAUNCHES = 0

    flat = vt.FlatIndex(x, device=dev)
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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = vt.IVFFlatIndex.build_index(K_CLUSTERS, 2, 10, x, device=dev)
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
    for nprobe in (1, 2, 4, 8):
        with captured_scans(binned) as calls:
            res = ivf.search_batch(qd, TOP_K, nprobe=nprobe)
        scans[nprobe] = calls
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

    with captured_scans(binned) as calls:
        res0 = ivf.search_batch(qd, TOP_K, nprobe=0)
    scans[0] = calls
    ms0 = cuda_ms(torch, lambda: ivf.search_batch_device(qd, TOP_K, 0))
    log(f"ivf adaptive nprobe=0: recall@10 {vt.recall_at_k(res0.ids, truth.ids):.4f}, "
        f"{N_QUERIES / ms0 * 1e3:.0f} qps")

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
        loaded = vt.IVFFlatIndex.load_index(str(path), device=dev)
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

    launches = {"distance_topk": cuda_topk.LAUNCHES,
                "packed_scan": cuda_binned.LAUNCHES}
    log(f"kernel launches on the main path: {launches}")
    assert all(n > 0 for n in launches.values()), launches

    # -- each kernel against its plain version, on the card, at the --
    # -- main path's shapes ------------------------------------------
    xd = flat._store.data
    ka = cuda_topk.cuda_distance_topk(qd, xd, N, TOP_K)
    # the kernel is deterministic: the same call as the ground truth's
    assert np.array_equal(ka[1].cpu().numpy(), truth.ids)
    assert np.array_equal(ka[0].cpu().numpy(), truth.distances)
    pa = fused_scan_topk(qd, xd, N, TOP_K)
    assert_topk_match(ka[0], ka[1], pa[0], pa[1], rtol=0.0, atol=TOL)
    err_a = max_abs_diff(ka[0], pa[0])
    del ka, pa
    ms_a = cuda_ms(torch, lambda: cuda_topk.cuda_distance_topk(qd, xd, N, TOP_K),
                   reps=2)
    plain_a = cuda_ms(torch, lambda: fused_scan_topk(qd, xd, N, TOP_K), reps=1)
    log(f"kernel A vs plain, Q={N_QUERIES} over {N}: max |d| {err_a:g}, "
        f"{ms_a:.2f} ms vs {plain_a:.2f} ms")

    b_rows = {}
    for nprobe, calls in scans.items():
        assert len(calls) == 1, (nprobe, len(calls))
        args, kw = calls[0]
        kw = {k: v for k, v in kw.items() if k != "plain"}
        q_stack, qb, gb, corpus_padded = args[0], args[2], args[3], args[4]
        cuda_binned.check_work_items(qb, gb, q_stack.shape[0], kw["q_blk"],
                                     corpus_padded.shape[0],
                                     kw["chunk"] * kw["r_chunks"])
        kb = cuda_binned.cuda_packed_scan(*args, **kw)
        pb = cuda_binned.packed_scan_plain(*args, **kw)
        assert_topk_match(kb[0], kb[1], pb[0], pb[1], rtol=0.0, atol=TOL)
        err_b = max_abs_diff(kb[0], pb[0])
        del kb, pb
        ms_b = cuda_ms(torch, lambda: cuda_binned.cuda_packed_scan(*args, **kw))
        plain_b = cuda_ms(torch, lambda: cuda_binned.packed_scan_plain(*args, **kw),
                          reps=1)
        log(f"kernel B vs plain, main-path scan of nprobe={nprobe} "
            f"({q_stack.shape[0]} query rows, {qb.shape[0]} work items): "
            f"max |d| {err_b:g}, {ms_b:.3f} ms vs {plain_b:.2f} ms")
        b_rows[nprobe] = dict(rows=q_stack.shape[0], work_items=qb.shape[0],
                              max_abs_err=err_b, ms=ms_b, plain_ms=plain_b)
    del scans

    kernels = [
        {"name": "distance_topk", "route": "cuda",
         "source": "vers_tpu_torch/csrc/distance_topk.cu",
         "replaces": "vers_tpu/ops/pallas_topk.py:294",
         "launches": launches["distance_topk"], "max_abs_err": err_a,
         "ms": ms_a, "plain_ms": plain_a,
         "shape": f"Q={N_QUERIES} N={N} d={DIM} k={TOP_K}"},
        {"name": "packed_scan", "route": "cuda",
         "source": "vers_tpu_torch/csrc/packed_scan.cu",
         "replaces": "vers_tpu/ops/pallas_binned.py:235",
         "launches": launches["packed_scan"],
         "max_abs_err": max(r["max_abs_err"] for r in b_rows.values()),
         "ms": b_rows[operating]["ms"], "plain_ms": b_rows[operating]["plain_ms"],
         "shape": f"Q={N_QUERIES} nprobe={operating} k={TOP_K} of the "
                  f"{K_CLUSTERS}-cluster layout",
         "by_nprobe": b_rows},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
