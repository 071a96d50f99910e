"""Checker-as-a-service: a long-lived multi-tenant analysis daemon and
the fleet of them (the port of jepsen_tpu.service).

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

The fleet puts N daemons behind one address: a file-backed membership
registry and a consistent hash ring over tenants (``membership.py``),
the front door with its durable intent journal, work-stealing, hand-off
of a dead member's checks and gray-failure hedging (``frontdoor.py``),
restart-budgeted respawn with epoch fencing (``supervisor.py``), a
seeded fault schedule against live members (``nemesis.py``) and the
invariant gate over the whole exercise (``invariants.py``):
``run_fleet_drill`` is the `cli fleet-drill` entry point. Members
spawn through ``pod/launcher.py``; on one card each member process owns
its own plane (its own CUDA context and stream).
"""

from jepsen_tpu_torch.service.admission import (
    AdmissionControl,
    AdmissionError,
)
from jepsen_tpu_torch.service.client import CheckerClient, ServiceError
from jepsen_tpu_torch.service.frontdoor import FleetFrontDoor
from jepsen_tpu_torch.service.invariants import InvariantMonitor
from jepsen_tpu_torch.service.membership import FleetRegistry, HashRing
from jepsen_tpu_torch.service.nemesis import (
    FleetChaosPlan,
    FleetFault,
    FleetNemesis,
    run_fleet_drill,
)
from jepsen_tpu_torch.service.server import CheckerDaemon
from jepsen_tpu_torch.service.supervisor import (
    FleetSupervisor,
    SupervisionPolicy,
)
from jepsen_tpu_torch.service.tenants import TenantLedger

__all__ = [
    "AdmissionControl",
    "AdmissionError",
    "CheckerClient",
    "CheckerDaemon",
    "FleetChaosPlan",
    "FleetFault",
    "FleetFrontDoor",
    "FleetNemesis",
    "FleetRegistry",
    "FleetSupervisor",
    "HashRing",
    "InvariantMonitor",
    "ServiceError",
    "SupervisionPolicy",
    "TenantLedger",
    "run_fleet_drill",
]
