"""enqueue_us: the median over the window's calls of the benchmark's
span around each call into ``IVFFlatIndex.search_batch_device`` (also
when ``search_batch`` makes it), up to its return and before any wait
for the results."""

import statistics

SOURCE, UNIT, BETTER = "host_clock", "us", "lower"
LAYER = "index/ivfflat.py + graphs.py (the search call on the host)"
MOVES = "qps"


def read(run):
    return statistics.median(run.enqueue_s) * 1e6 if run.enqueue_s else None
