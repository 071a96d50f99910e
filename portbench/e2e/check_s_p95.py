"""The 95th percentile (nearest rank) of every check's time in the
window, from its submission to its verdict, in seconds. A check that
failed counts at its own time."""

import math


def read(run):
    times = sorted(r.t1 - r.t0 for r in run.records)
    if not times:
        return None
    return times[math.ceil(0.95 * len(times)) - 1]
