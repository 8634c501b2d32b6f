"""rescore_device_ms: device ms a call of the HNSW search's ``rescore``
stage: the f32 rescore of the whole beam and its top k, then the id
map. The union of the device records between the program's ``rescore``
marker and the next one (markers left out), summed over the traced
slice, over its calls (``bench/stages.py``). None without the program's
HNSW markers."""

from perfbench.bench.stages import stage_ms
from perfbench.drivers.hnsw import STAGES

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/beam.py f32 rescore of the beam"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "rescore", stages=STAGES)
