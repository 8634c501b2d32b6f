"""probe_device_ms: device ms a call of the binned search's ``probe``
stage: the centroid distances and their top-nprobe, or the adaptive walk's probes (`adaptive_probes`). The union of the device records between the program's
``probe`` marker and the next one (markers left out), summed over the
traced slice, over its calls (``bench/stages.py``). None without the
program's markers."""

from perfbench.bench.stages import stage_ms

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/binned.py stage probe"
MOVES = "qps"


def read(run):
    return stage_ms(run.trace, "probe")
