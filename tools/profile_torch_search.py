#!/usr/bin/env python3
"""Where the time goes in vers_tpu_torch's searches, on one CUDA card.

Builds the smoke run's configuration (``synthetic_gaussian`` corpus of
1M x 300 from seed 0, IVF k = 2048 with 2 restarts and 10 Lloyd
iterations, 16384 queries, top_k = 10), then for each search path --
IVF at nprobe 1, 2 and the adaptive 0, and the exact flat scan -- it
times ``--reps`` calls with CUDA events, profiles ``--reps`` more with
``torch.profiler``, and prints per call:

  * the wall time, unprofiled and under the profiler (ms);
  * the device busy time: the union of the card's kernel and copy
    intervals, so overlapping or nested records count once (ms);
  * the device idle share: 1 - busy / profiled window, where the window
    runs from the first call's start to a final synchronize;
  * the device activities with the most time, by name.

Usage, from the repository root:

    python3 tools/profile_torch_search.py [--n N] [--dim D] [--queries Q]
        [--clusters K] [--top-k K] [--reps R] [--top T] [--out PATH]

``--out`` writes every path's numbers and all of its device activities
as JSON. Needs one CUDA card; exits 2 without one.
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


def profile_path(torch, fn, reps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    wall = cuda_ms(torch, fn, reps)
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
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_search.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    import vers_tpu_torch as vt
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
    x, q = synthetic_gaussian(args.n, args.dim, n_clusters=1024,
                              n_queries=args.queries, seed=0, normalized=True,
                              query_noise=0.5)
    qd = torch.from_numpy(q).to(dev)
    flat = vt.FlatIndex(x, device=dev)
    ivf = vt.IVFFlatIndex.build_index(args.clusters, 2, 10, x, device=dev)
    ivf._ensure_layout()
    torch.cuda.synchronize()

    k = args.top_k
    paths = {
        "ivf nprobe=1": lambda: ivf.search_batch_device(qd, k, 1),
        "ivf nprobe=2": lambda: ivf.search_batch_device(qd, k, 2),
        "ivf nprobe=0 (adaptive)": lambda: ivf.search_batch_device(qd, k, 0),
        "flat exact": lambda: flat.search_batch_device(qd, k),
    }
    results = {}
    for name, fn in paths.items():
        reps = 1 if name.startswith("flat") else args.reps
        t0 = time.perf_counter()
        r = profile_path(torch, fn, reps)
        results[name] = r
        print(f"== {name}, Q={args.queries}: wall {r['wall_ms']:.3f} ms/call, "
              f"profiled {r['profiled_ms']:.3f} ms/call, device busy "
              f"{r['busy_ms']:.3f} ms/call, idle share {r['idle_share']:.3f} "
              f"({reps} calls; {time.perf_counter() - t0:.1f} s)", flush=True)
        for a in r["activities"][: args.top]:
            print(f"    {a['ms']:9.3f} ms  x{a['calls']:6.1f}  {a['name'][:90]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=smi, args=vars(args), paths=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
