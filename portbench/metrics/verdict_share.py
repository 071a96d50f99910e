"""The share of the window in building each verdict: the self time of
the program's `verdict` spans (checker/linearizable.py: the bitset
verdict, the failure report, the sentry's report and the failure's
rendering),
clipped to the window, over its length (metrics/_spans.py)."""

from portbench.metrics._spans import self_share

SPANS = ("verdict",)


def read(run):
    return self_share(run, SPANS)
