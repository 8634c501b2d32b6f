"""binned_device_ms: device busy time a call in the traced slice (the
union of the kernel records), less kernel B's kernels and every copy
and set: the probe matmul, the pair sort, the work items, the unsort and
the merge. Copies are ``copy_device_ms``'s."""

SOURCE, UNIT, BETTER = "device_trace", "ms", "lower"
LAYER = "ops/binned.py (probe matmul, pair sort, work items, unsort, merge)"
MOVES = "qps"

# kernel B's kernels (ops/cuda_binned.py, csrc/packed_scan.cu): the
# scan and the two plan kernels its wrapper launches ahead of it
KERNEL_B = ("packed_scan_kernel", "plan_cost_kernel", "plan_order_kernel")
# copies and sets, as records of their own or as the driver's copy kernels
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.device:
        return None
    return (t.busy_s() - t.busy_s(KERNEL_B + COPIES)) / len(t.calls) * 1e3
