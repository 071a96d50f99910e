"""The card's idle share of the traced window: 1 - the union of
kernel, copy and memset intervals in the profiler's trace over the
window's length."""


def read(run):
    if run.devtrace is None or run.devtrace["window_s"] <= 0:
        return None
    return 1.0 - run.devtrace["busy_s"] / run.devtrace["window_s"]
