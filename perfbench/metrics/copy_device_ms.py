"""copy_device_ms: device busy time a call in the traced slice spent in
copies and sets (the union of the memcpy and memset records): the CUDA
graphs' input copies and output clones, the results brought to the host,
a host cell's queries sent up, and an eager path's copies."""

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = ("copies: memcpy and memset (graphs.py's input and output copies, "
         "results to the host, host queries up, eager copies)")
MOVES = "qps"

COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.device:
        return None
    if not any(any(k in n for k in COPIES) for n, _, _ in t.device):
        return None
    return t.busy_s(COPIES) / len(t.calls) * 1e3
