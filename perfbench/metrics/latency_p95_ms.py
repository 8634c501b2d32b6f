"""latency_p95_ms: the 95th percentile, over every call issued in the
window, of the time from the call's issue until its results are on the
host (host clock)."""

from perfbench.bench.traffic import latencies, percentile

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"


def read(run):
    p = percentile(latencies(run.window), 0.95)
    return None if p is None else p * 1e3
