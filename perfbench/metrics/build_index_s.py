"""build_index_s: the benchmark's span around ``IVFFlatIndex.build_index``
alone, ending in a synchronise: k-means, the final assignment and the
host's lists; the mean over the builds that ``build_s`` averages."""

SOURCE, UNIT, BETTER = "host_clock", "s", "lower"
LAYER = "ops/kmeans.py + index/ivfflat.build_index (build)"
MOVES = "build_s"


def read(run):
    return run.build_index_s
