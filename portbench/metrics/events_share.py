"""The share of the window in encoding each key's history as events:
the self time of the program's `history_to_events` spans
(checker/events.py),
clipped to the window, over its length (metrics/_spans.py)."""

from portbench.metrics._spans import self_share

SPANS = ("history_to_events",)


def read(run):
    return self_share(run, SPANS)
