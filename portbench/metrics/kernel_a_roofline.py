"""Kernel A's share of its roofline, in percent: the least time the
card needs for the work the window's histories need
(metrics/_kernel_a.py; INT32 word operations at the card's INT32 rate
or bytes at 3.35 TB/s, whichever bounds it), over the profiler's
kernel-A time."""

from portbench.devtrace import kernel_seconds
from portbench.metrics._kernel_a import window_work
from portbench.metrics.kernel_a_us_per_step import KERNEL
from portbench.peaks import least_seconds


def read(run):
    t = kernel_seconds(run, KERNEL)
    if t is None or run.card is None:
        return None
    _steps, ops, nbytes = window_work(run)
    if not ops:
        return None
    least, _by = least_seconds(ops, nbytes, run.card)
    return least / t * 100.0
