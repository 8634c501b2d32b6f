#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the system under test (``vers_tpu_torch``), warms up every shape
the cell uses, measures for ``--seconds``, checks the outputs against
the plain reference, and prints one JSON line (see ``perfbench/README.md``).
Exits 2 without the CUDA devices the cell asks for.
"""

import time

T0 = time.perf_counter()  # set-up runs from here to the window's start

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
CACHE = ROOT / ".perfbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from perfbench.bench.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
