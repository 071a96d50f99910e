"""Kernel A's device time (the profiler's `bitset_scan_kernel` events)
over the return steps of the histories the window checked, counted by
the benchmark from the histories (an invalid one up to its failing
op), in microseconds."""

from portbench.devtrace import kernel_seconds
from portbench.metrics._kernel_a import window_work

KERNEL = "bitset_scan_kernel"


def read(run):
    t = kernel_seconds(run, KERNEL)
    steps = window_work(run)[0]
    if t is None or not steps:
        return None
    return t / steps * 1e6
