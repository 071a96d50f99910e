"""`ops_per_s` (e2e/ops_per_s.py) read per layer in the keyed cell: the
host's speed swings within and between its runs, so it spreads too
widely there to stand end to end (PERF.md §2). In a traced run it
includes the cost of tracing."""

from portbench.e2e.ops_per_s import read  # noqa: F401
