"""device_idle_share: the share of the traced slice in which no kernel
or copy ran on the card: 1 - busy / window."""

SOURCE, UNIT, BETTER = "device_trace", "%", "lower"
LAYER = "device"
MOVES = "qps"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    lo, hi = t.window
    return 100.0 * (1.0 - t.busy_s() / (hi - lo)) if hi > lo else None
