"""program_idle_ms: device idle ms a call in the traced slice whose
middle lies under one of the program's host spans (``vers/...``): the
idle that the program's own host work holds (``bench/stages.py``). None
without the program's spans."""

from perfbench.bench.stages import program_idle_ms

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "device idle held by the program's host work"
MOVES = "qps"


def read(run):
    return program_idle_ms(run.trace)
