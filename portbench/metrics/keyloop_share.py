"""The share of the window in IndependentChecker's own work: the self
time of the program's `independent.check`, `independent.split` and
`independent.key` spans (the split by key, the per-key loop around
each key's check, its options and results files),
clipped to the window, over its length (metrics/_spans.py)."""

from portbench.metrics._spans import self_share

SPANS = ("independent.check", "independent.split", "independent.key")


def read(run):
    return self_share(run, SPANS)
