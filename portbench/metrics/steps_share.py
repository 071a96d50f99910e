"""The share of the window in turning events into return steps: the
self time of the program's `events_to_steps` spans (checker/events.py,
the native csrc/wgl_prep.cc pass or numpy),
clipped to the window, over its length (metrics/_spans.py)."""

from portbench.metrics._spans import self_share

SPANS = ("events_to_steps",)


def read(run):
    return self_share(run, SPANS)
