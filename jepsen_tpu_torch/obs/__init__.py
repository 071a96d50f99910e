"""obs: the flight-recorder observability plane of the port.

The counterpart of jepsen_tpu.obs. The recorder
marks every plane crossing the engine makes (launches, host syncs,
coalesced batches, collect trains, checkpoint saves, chaos retries)
and the host stages of a check (the keyed split and per-key loop, the
sentry, the event and step encodings, launch preparation, the verdict)
as spans and instants, each with its id and the span that caused it,
and exports them as industry-standard artifacts:

- ``obs.trace``: process-wide per-thread ring-buffer recorder
  (``span(...)`` context manager + ``instant(...)`` events, disabled
  by default: the off path is one attribute check, safe in hot paths;
  under a torch.profiler capture each span is also a profiler
  annotation, on the device trace's clock)
- ``obs.export``: Chrome-trace/Perfetto JSON + JSONL sinks
- ``obs.podtrace``: the pod-wide trace: each member persists its ring
  into the ``JEPSEN_TPU_TRACE_DIR`` seam, and ``merge_pod_trace``
  rebases every member onto one clock-aligned timeline with the
  ``init_pod`` handshake's offsets and emits one multi-process
  Perfetto trace (stdlib only)
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

planelint Family C (JT301-JT305, ``jepsen_tpu_torch.analysis``) holds
the emission discipline: spans close via a context manager, nothing
emits under a plane lock or inside a per-device or per-member loop.
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
from jepsen_tpu_torch.obs.podtrace import (  # noqa: F401
    ENV_TRACE_DIR,
    merge_pod_trace,
    persist_member_trace,
)
