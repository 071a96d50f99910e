"""`kernel_a_roofline` (metrics/kernel_a_roofline.py) in the keyed cell,
where it moves `check_s_p95`: the keyed cell's `ops_per_s` spreads
too widely between runs to stand end to end there (PERF.md §2)."""

from portbench.metrics.kernel_a_roofline import read  # noqa: F401
