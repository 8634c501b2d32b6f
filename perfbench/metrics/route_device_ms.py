"""route_device_ms: device ms a call of the HNSW search's ``route``
stage: kernel A's scan of the layer-1 rows for the beam's seeds, the
queries' projection and the beam's start. The union of the device
records between the program's ``route`` marker and the next one (markers
left out), summed over the traced slice, over its calls
(``bench/stages.py``). None without the program's HNSW markers."""

from perfbench.bench.stages import stage_ms
from perfbench.drivers.hnsw import STAGES

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/beam.py routing scan (kernel A over the layer-1 rows) and the beam's start"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "route", stages=STAGES)
