"""forest_build_s: the seconds of the program's forest build in the run:
the total of its span ``lsh.build`` (``ANNIndex.build_index``: the
duplicate rows dropped on the host, the trees built on the device, their
tables copied to the host), from the program's ``trace.snapshot()``
after the window. None where the program has no trace or recorded no
forest build."""

SOURCE, UNIT, BETTER = "program_span", "s", "lower"
LAYER = "ops/rpforest.py tree build (index/lsh.py build_index)"
MOVES = "setup_s"


def seconds(snapshot_spans: dict):
    """``lsh.build``'s total seconds in ``snapshot()["spans"]``."""
    build = snapshot_spans.get("lsh.build")
    return None if build is None else build["total_ns"] * 1e-9


def read(run):
    try:
        from vers_tpu_torch import trace
    except ImportError:  # a program without a trace
        return None
    return seconds(trace.snapshot()["spans"])
