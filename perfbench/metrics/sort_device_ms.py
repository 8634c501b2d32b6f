"""sort_device_ms: device ms a call of the binned search's ``sort``
stage: the pair sort, the query gather, the bin counts and the work items. The union of the device records between the program's
``sort`` marker and the next one (markers left out), summed over the
traced slice, over its calls (``bench/stages.py``). None without the
program's markers."""

from perfbench.bench.stages import stage_ms

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/binned.py stage sort (pair sort, work items)"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "sort")
