"""hnsw_build_s: the seconds of the program's HNSW build in the run: the
total of its span ``hnsw.build`` (``HNSWIndex.build_index_device``'s
wave build and the graph's copy to the host), from the program's
``trace.snapshot()`` after the window. None where the program has no
trace or recorded no build."""

SOURCE, UNIT, BETTER = "program_span", "s", "lower"
LAYER = "ops/hnsw_build.py wave build (index/hnsw.py build_index_device)"
MOVES = "setup_s"


def seconds(snapshot_spans: dict):
    """``hnsw.build``'s total seconds in ``snapshot()["spans"]``."""
    build = snapshot_spans.get("hnsw.build")
    return None if build is None else build["total_ns"] * 1e-9


def read(run):
    try:
        from vers_tpu_torch import trace
    except ImportError:  # a program without a trace
        return None
    return seconds(trace.snapshot()["spans"])
