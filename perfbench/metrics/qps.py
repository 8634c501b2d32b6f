"""qps: queries whose results reached the host inside the window, over
the window's seconds (host clock)."""

from perfbench.bench.traffic import served_in_window

SOURCE, UNIT, BETTER = "host_clock", "queries/s", "higher"


def read(run):
    w = run.window
    return served_in_window(w, run.batch) / (w.end - w.start)
