"""Checker-as-a-service: a long-lived multi-tenant analysis daemon (the
single-daemon half of jepsen_tpu.service).

One warm daemon owns the process-wide dispatch plane of its device (the
CUDA card by default) and serves history-check requests from many
concurrent clients over stdlib HTTP/JSON on a local socket, coalescing
ACROSS tenants: the plane's bucket keying already coalesces same-shape
submitters, and the daemon's hold window gives concurrent requests time
to meet in one bucket, so two tenants sharing a kernel shape pay one
launch.

The robustness surface:

- admission control (``admission.py``): bounded in-flight queue,
  payload size caps, and history-sentry validation at the door with a
  per-tenant strict/repair policy.
- per-tenant fairness + backpressure: 429 shedding past the queue
  bound, per-tenant in-flight caps, and per-request deadlines (the
  plane itself runs under ``DispatchPlane(launch_deadline_s=...)``).
- per-tenant isolation of the resilience machinery (``tenants.py``):
  plane faults and oracle fallbacks attribute to the submitting tenant
  (dispatch's tenant tags ride the chaos guard labels), and a tenant
  whose submissions keep faulting trips ITS OWN breaker in the chaos
  quarantine registry, never the card's.
- graceful drain (``drain.py``): SIGTERM stops admission (503), lets
  in-flight checks finish inside a bounded budget, and relies on the
  checkpoint sink's per-segment durability for anything longer.
- the control audit log (``audit.py``): one JSONL record per request.

``client.py`` is the stdlib client library.

Not ported yet: the fleet (membership, the front door, supervision,
the fleet nemesis and its invariant gate).
"""

from jepsen_tpu_torch.service.admission import (
    AdmissionControl,
    AdmissionError,
)
from jepsen_tpu_torch.service.client import CheckerClient, ServiceError
from jepsen_tpu_torch.service.server import CheckerDaemon
from jepsen_tpu_torch.service.tenants import TenantLedger

__all__ = [
    "AdmissionControl",
    "AdmissionError",
    "CheckerClient",
    "CheckerDaemon",
    "ServiceError",
    "TenantLedger",
]
