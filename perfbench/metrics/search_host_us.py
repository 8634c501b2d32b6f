"""search_host_us: the median over the traced slice of the program's
own span around each IVF search (``vers/ivf.search``: the whole
``search_batch_device`` call, inside the benchmark's ``enqueue``). None
without the program's spans."""

import statistics

from perfbench.bench.stages import spans

SOURCE, UNIT, BETTER = "host_clock", "us", "lower"
LAYER = "index/ivfflat.py + graphs.py (program span)"
MOVES = "qps"


def read(run):
    mine = spans(run.trace, "ivf.search")
    return statistics.median(e - s for _, s, e in mine) * 1e6 if mine else None
