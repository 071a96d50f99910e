"""The share of the window in preparing and enqueueing each launch:
the self time of the program's `launch_prep` spans
(checker/wgl_bitset.py: the segment plan, packing, the pinned upload,
record_use and the kernel enqueue),
clipped to the window, over its length (metrics/_spans.py)."""

from portbench.metrics._spans import self_share

SPANS = ("launch_prep",)


def read(run):
    return self_share(run, SPANS)
