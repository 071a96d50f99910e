"""The share of the window in LinearizableChecker.check outside its
named stages: the self time of the program's `linearizable.check`
spans (the tier plan, the collect and an exact re-run's preparation;
not the host's wait on the card, which `sync_wait_share` reads),
clipped to the window, over its length (metrics/_spans.py)."""

from portbench.metrics._spans import self_share

SPANS = ("linearizable.check",)


def read(run):
    return self_share(run, SPANS)
