"""layout_build_s: the seconds the program spent building its search
layouts in the run: the totals of its spans ``ivf.layout`` (the
cluster-major layout, at the first search after the build) and
``layout.padded`` (kernel B's group-padded layout), from the program's
``trace.snapshot()`` after the window. On the IVF path the two do not
nest. None where the program has no trace or recorded no layout."""

SOURCE, UNIT, BETTER = "host_clock", "s", "lower"
LAYER = "index/ivfflat.py + ops/cuda_binned.py layout build"
MOVES = "build_s"

SPANS = ("ivf.layout", "layout.padded")


def seconds(snapshot_spans: dict):
    """The layout spans' total seconds in ``snapshot()["spans"]``."""
    mine = [snapshot_spans[n]["total_ns"] for n in SPANS if n in snapshot_spans]
    return sum(mine) * 1e-9 if mine else None


def read(run):
    try:
        from vers_tpu_torch import trace
    except ImportError:  # a program without a trace
        return None
    return seconds(trace.snapshot()["spans"])
