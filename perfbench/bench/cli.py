"""One run of one cell: set-up, the measured window, the check, and the
result as the last line of standard output.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (``BENCHMARK.json`` says which metrics a
cell reports; ``metrics/<name>.py`` reads each). ``correct`` is the
comparison of the cell's outputs with the plain reference, each number
within its limit (``workloads/<cell>.json``); the numbers and limits are
the result's last key and the last lines on standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from perfbench.bench.registry import Registry, driver, read_metrics

# top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "vers_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py",
                                 description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """The forbidden top-level names among the loaded modules, each
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, t0: float, registry: Registry = None, device=None,
         system: str = "program", fault: str = None, out=None, err=None) -> int:
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    reg = registry or Registry()
    cell = reg.cell(args.workload)

    import torch

    if device is None:
        chips = int(cell.entry["chips"])
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            print(f"perfbench: {args.workload} needs {chips} CUDA device(s), "
                  f"found {found}", file=err)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)

    run = driver(cell.config["index"]).run(
        cell, args.seed, args.seconds, bool(args.trace), device, t0,
        system=system, fault=fault)

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded in the measured process: {', '.join(bad)}",
              file=err)
        return 3

    metrics = read_metrics(reg.metrics(cell.name, bool(args.trace)), run)
    checks = {name: {"value": float(run.judged[name]), "limit": float(limit)}
              for name, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    calls = [c for c in run.window.calls if c[1] < run.window.end]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else device.type),
           "count": 1,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": correct, "attempted": run.batch * len(calls),
              "failed": 0, "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        lo, hi = run.trace.window
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = hi - lo
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    for name, c in checks.items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
