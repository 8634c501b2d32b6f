"""fold_device_ms: device ms a call of the forest search's ``fold``
stage: each tree's top-k folded into the running answer by the dedup
merge (``merge_probe_results``). The union of the device records
between each ``fold`` marker and the next one (the next tree's
``gather``, or ``forest.end``; markers left out), summed over the trees,
over the traced slice's calls (``bench/stages.py``). None without the
program's forest markers."""

from perfbench.bench.stages import stage_ms
from perfbench.drivers.lsh import STAGES

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/forest_shared.py cross-tree dedup merge"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "fold", stages=STAGES)
