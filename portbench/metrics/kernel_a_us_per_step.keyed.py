"""`kernel_a_us_per_step` (metrics/kernel_a_us_per_step.py) in the keyed
cell, where it moves `check_s_p95`: the keyed cell's `ops_per_s`
spreads too widely between runs to stand end to end there (PERF.md
§2)."""

from portbench.metrics.kernel_a_us_per_step import read  # noqa: F401
