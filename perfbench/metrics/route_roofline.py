"""route_roofline: the least time an H100 needs for the routing scans of
the traced calls (the frozen ``route_scan_bound``, kernel A's
bf16/default route, over the work the driver counts: each call's
queries, the layer-1 rows, the width and the seeds; whatever implements
the scan), as a share of the ``route`` stage's device time in those
calls."""

from perfbench.bench.stages import stage_ms
from perfbench.drivers.hnsw import STAGES
from perfbench.reference.route import route_scan_bound

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"
LAYER = "ops/beam.py routing scan (kernel A over the layer-1 rows) and the beam's start"
MOVES = "qps"


def read(run):
    t = run.trace
    if t is None or not t.calls or run.work is None:
        return None
    spent = stage_ms(t, "route", stages=STAGES)
    if not spent:
        return None
    least = sum(route_scan_bound(**run.work[i % run.pool_batches])["bound_ms"]
                for i in t.calls)
    return 100.0 * least / (spent * len(t.calls))
