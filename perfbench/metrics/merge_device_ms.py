"""merge_device_ms: device ms a call of the binned search's ``merge``
stage: the unsort, the masks and the merge of the probe ranks' results. The union of the device records between the program's
``merge`` marker and the next one (markers left out), summed over the
traced slice, over its calls (``bench/stages.py``). None without the
program's markers."""

from perfbench.bench.stages import stage_ms

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/binned.py stage merge (unsort, merge)"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "merge")
