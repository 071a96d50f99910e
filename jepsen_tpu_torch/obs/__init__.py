"""obs: the flight-recorder observability plane of the port.

A copy of jepsen_tpu.obs's single-process half. The recorder marks
every plane crossing the engine makes (launches, host syncs, coalesced
batches, collect trains, checkpoint saves, chaos retries) as spans and
instants, and exports them as industry-standard artifacts:

- ``obs.trace``: process-wide per-thread ring-buffer recorder
  (``span(...)`` context manager + ``instant(...)`` events, disabled
  by default: the off path is one attribute check, safe in hot paths)
- ``obs.export``: Chrome-trace/Perfetto JSON + JSONL sinks
- ``obs.profiler``: ``xla_trace(dir)``, a torch.profiler capture of the
  host and the card (the reference's jax.profiler capture)
- ``obs.snapshot``: the ONE consolidated ``engine_snapshot()`` behind
  the CLI's engine stats and the daemon's ``/stats`` (imported
  explicitly: it imports the checker modules, which import
  ``obs.trace`` for emission)
- ``obs.prom``: the Prometheus text exposition behind the daemon's
  ``/metrics``, every ``*_STATS`` surface plus span histograms and the
  per-tenant and quarantine labelled families (imported explicitly)
- ``obs.trend``: the bench trend ledger's reader and per-trajectory
  regression gate behind ``cli perf-trend`` (stdlib only)

Not ported yet: the pod-wide trace merge (``obs.podtrace``), which
belongs to the pod layer.
"""

from jepsen_tpu_torch.obs.trace import (  # noqa: F401
    TRACER,
    disable,
    enable,
    instant,
    reset,
    span,
    spans,
    trace_stats,
)
from jepsen_tpu_torch.obs.export import (  # noqa: F401
    chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
