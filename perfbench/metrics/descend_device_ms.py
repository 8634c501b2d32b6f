"""descend_device_ms: device ms a call of the forest search's ``descend``
stage: the multiprobe descent through every tree (one pass of the
levels for the main leaves, one for the flipped probes) and, at the
default probe count, the deficit gate. The union of the device records
between the program's ``descend`` marker and the next one (the first
tree's ``gather``; markers left out), over the traced slice's calls
(``bench/stages.py``). None without the program's forest markers."""

from perfbench.bench.stages import stage_ms
from perfbench.drivers.lsh import STAGES

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/rpforest.py multiprobe descent and deficit gate"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "descend", stages=STAGES)
