"""kernel_b_roofline: the least time an H100 needs for kernel B's work
in the traced calls (the frozen ``packed_scan_bound`` over the work the
benchmark counts: the sizes of each query's probed lists under the
index's centroids, whatever implements the scan), as a share of kernel
B's device time in those calls."""

from perfbench.reference.peaks import packed_scan_bound

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"
LAYER = "ops/cuda_binned.py kernel B"
MOVES = "qps"

KERNEL_B = ("packed_scan_kernel", "plan_cost_kernel", "plan_order_kernel")


def read(run):
    t = run.trace
    if t is None or not t.calls or run.work is None:
        return None
    spent = t.busy_s(KERNEL_B)
    if spent <= 0:
        return None
    least = sum(packed_scan_bound(**run.work[i % run.pool_batches])["bound_ms"]
                for i in t.calls) * 1e-3
    return 100.0 * least / spent
