"""gather_device_ms: device ms a call of the forest search's ``gather``
stage: each tree's padded view of the shared corpus (and its squared
norms) gathered into the one reused buffer. The union of the device
records between each ``gather`` marker and the next one (that tree's
binned ``sort``; markers left out), summed over the trees, over the
traced slice's calls (``bench/stages.py``). None without the program's
forest markers."""

from perfbench.bench.stages import stage_ms
from perfbench.drivers.lsh import STAGES

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/forest_shared.py per-tree view gather"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "gather", stages=STAGES)
