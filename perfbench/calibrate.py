#!/usr/bin/env python3
"""Readings for the limits of the check, many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--system program|control] [--fault NAME] [--seconds 2] \
        [--set KEY=VALUE ...] [--nprobe N] [--out FILE]

Runs the cell's whole run (set-up, a window of ``--seconds``, the check)
once a seed, in this process, with the system under test
(``program``) or the plain reference at TF32 in its place (``control``,
the lower precision that the check must fail), with ``--fault`` one of
the driver's ``FAULTS`` planted, and prints each seed's
checked numbers and end-to-end metrics, then the largest and smallest of
each number. ``--set KEY=VALUE`` (repeated; the value read as JSON)
runs the cell with that traffic parameter changed: the sweep that picks
a cell's operating point (IVF's ``nprobe``, or another driver's own
key). ``--nprobe N`` is short for ``--set nprobe=N``. Not part of a
benchmark run; needs a CUDA device.
"""

import argparse
import io
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.bench.cli import main as run_cell  # noqa: E402
from perfbench.bench.registry import Registry  # noqa: E402


class _Override(Registry):
    """The registry with some of each cell's traffic parameters changed."""

    def __init__(self, traffic: dict):
        super().__init__()
        self.traffic = traffic

    def cell(self, name):
        c = super().cell(name)
        unknown = sorted(set(self.traffic) - set(c.traffic))
        if unknown:
            raise KeyError(f"{name} has no traffic parameter {', '.join(unknown)}")
        c.traffic = dict(c.traffic, **self.traffic)
        return c


def setting(text: str):
    """``KEY=VALUE`` as (key, the value read as JSON)."""
    key, sep, value = text.partition("=")
    if not sep or not key:
        raise argparse.ArgumentTypeError(f"not KEY=VALUE: {text!r}")
    try:
        return key, json.loads(value)
    except json.JSONDecodeError as e:
        raise argparse.ArgumentTypeError(f"{key}: {value!r} is not JSON ({e})")


def parse(argv=None):
    """The arguments, with ``traffic``: the parameters changed, ``--set``
    and ``--nprobe`` together."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--system", default="program", choices=("program", "control"))
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=int, default=2)
    ap.add_argument("--set", type=setting, action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--nprobe", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    args.traffic = dict(args.set)
    if args.nprobe is not None:
        args.traffic["nprobe"] = args.nprobe
    return args


def main(argv=None):
    args = parse(argv)
    reg = _Override(args.traffic)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        buf = io.StringIO()
        t = time.perf_counter()
        rc = run_cell(["--workload", args.workload, "--seed", str(seed),
                       "--seconds", str(args.seconds)],
                      t, registry=reg, system=args.system, fault=args.fault, out=buf)
        if rc != 0:
            print(f"seed {seed}: exit {rc}", flush=True)
            continue
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        row = dict(seed=seed, system=args.system, fault=args.fault, traffic=args.traffic,
                   seconds=time.perf_counter() - t, correct=res["correct"],
                   checks={k: v["value"] for k, v in res["checks"].items()},
                   metrics={k: v["value"] for k, v in res["metrics"].items()},
                   device=res["device"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    if rows:
        for name in rows[0]["checks"]:
            vals = [r["checks"][name] for r in rows]
            print(f"{args.workload} {args.system} {args.fault or ''} {name}: max {max(vals)!r} "
                  f"min {min(vals)!r} over {len(vals)} seeds", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fp:
            for r in rows:
                fp.write(json.dumps(dict(r, workload=args.workload)) + "\n")


if __name__ == "__main__":
    main()
