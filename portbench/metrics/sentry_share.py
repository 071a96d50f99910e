"""The share of the window in the history sentry: the self time of the
program's `sentry` spans (history/sentry.py validate_history),
clipped to the window, over its length (metrics/_spans.py)."""

from portbench.metrics._spans import self_share

SPANS = ("sentry",)


def read(run):
    return self_share(run, SPANS)
