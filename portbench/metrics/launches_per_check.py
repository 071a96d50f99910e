"""Kernel launches (the program's LAUNCH_STATS, exact re-runs included)
over the checks the window answered."""


def read(run):
    n = sum(1 for r in run.records if r.verdict is not None)
    if not n or "launches" not in run.counters:
        return None
    return run.counters["launches"] / n
