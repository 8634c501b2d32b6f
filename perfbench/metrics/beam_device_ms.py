"""beam_device_ms: device ms a call of the HNSW search's ``beam`` stage:
the layer-0 beam's steps, replayed in graph chunks between the host's
reads of its stop flag. The union of the device records between the
program's ``beam`` marker and the next one (markers left out), summed
over the traced slice, over its calls (``bench/stages.py``). None
without the program's HNSW markers."""

from perfbench.bench.stages import stage_ms
from perfbench.drivers.hnsw import STAGES

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/beam_inline.py layer-0 beam (graph chunks of steps between flag reads)"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "beam", stages=STAGES)
