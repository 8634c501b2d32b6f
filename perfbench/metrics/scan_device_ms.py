"""scan_device_ms: device ms a call of the binned search's ``scan``
stage: kernel B's plan kernels and its scan (`packed_scan`). The union of the device records between the program's
``scan`` marker and the next one (markers left out), summed over the
traced slice, over its calls (``bench/stages.py``). None without the
program's markers."""

from perfbench.bench.stages import stage_ms

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/cuda_binned.py kernel B (stage scan)"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "scan")
