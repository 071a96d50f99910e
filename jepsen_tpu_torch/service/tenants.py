"""Per-tenant ledger: stats attribution, policy, and the fault breaker
(a copy of jepsen_tpu.service.tenants).

Every request the daemon serves is attributed to a tenant (the
``tenant`` field of the request; "default" when anonymous). The ledger
keeps each tenant's view of the shared plane separate — admissions,
sheds, hostile rejections, verdicts, resilience events, durable
resumes — so one tenant's fault storm shows up in ITS row and nobody
else's. That is the isolation contract the acceptance test pins: a
hostile tenant's sentry rejections, oversized payloads, and device
faults must not perturb a clean tenant's verdicts or ledger.

The breaker rides the chaos quarantine registry under a
``tenant:<name>`` pseudo-label (chaos.TENANT_PREFIX): dispatch-level
attributed faults (tenant tags on the guard labels) and service-level
degraded verdicts both count against the same label, and once the
count crosses the threshold the tenant is quarantined — admission
sheds its requests with 429s until an operator resets the resilience
ledger. No device is named by a tenant label, so the breaker never
reads as the card's quarantine: tenants and the card fail
independently.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from jepsen_tpu_torch.checker import chaos

#: anonymous requests attribute here
DEFAULT_TENANT = "default"

#: one ledger row per tenant (all zero at first sight)
_ROW = {
    "accepted": 0,            # admitted past the door
    "completed": 0,           # verdict delivered (any validity)
    "shed": 0,                # 429s: queue bound / in-flight cap
    "shed_quarantined": 0,    # 429s: breaker-tripped tenant
    "rejected_payload": 0,    # 413s: payload over the cap
    "hostile": 0,             # sentry strict refusals (HTTP 422)
    "repaired": 0,            # sentry repairs applied at the door
    "valid": 0,               # verdicts by validity
    "invalid": 0,
    "errors": 0,              # 500s: check raised
    "deadline_timeouts": 0,   # 504s: request deadline expired
    "oracle_fallbacks": 0,    # plane degradations attributed here
    "plane_faults": 0,
    "faults": 0,              # breaker feed: degraded verdicts et al.
    "durable_checks": 0,
    "durable_resumes": 0,     # resumed past segment 0 on resubmit
    "durable_replays": 0,     # finished checkpoint answered launch-free
    "stream_chunks": 0,       # POST /check/stream chunks appended
    "stream_deadline_misses": 0,  # appends past their deadline budget
}

#: stream append latency reservoir size per tenant (enough for a p99
#: over the recent window without unbounded growth)
_LAT_CAP = 512


class TenantLedger:
    """Thread-safe per-tenant accounting + policy + breaker."""

    def __init__(
        self,
        strict_default: bool = False,
        quarantine_after: int = 5,
    ):
        #: door policy when a request does not name one: strict tenants
        #: get HistorySentryError -> 422 instead of a silent repair
        self.strict_default = strict_default
        self.quarantine_after = max(int(quarantine_after), 1)
        self._lock = threading.Lock()
        self._rows: Dict[str, dict] = {}
        self._policy: Dict[str, bool] = {}  # tenant -> strict?
        self._first_seen: Dict[str, float] = {}
        #: per-tenant stream append latency samples (ms), ring-capped
        self._stream_lat: Dict[str, list] = {}

    # -- rows ----------------------------------------------------------

    def _row(self, tenant: str) -> dict:
        row = self._rows.get(tenant)
        if row is None:
            row = self._rows[tenant] = dict(_ROW)
            self._first_seen[tenant] = time.time()
        return row

    def note(self, tenant: str, key: str, n: int = 1) -> None:
        with self._lock:
            self._row(tenant)[key] += n

    def note_stream_latency(self, tenant: str, ms: float) -> None:
        """One stream append's wall latency into the tenant's SLO
        reservoir (ring-capped at _LAT_CAP samples: the p99 tracks the
        recent window, not all history)."""
        with self._lock:
            self._row(tenant)  # latency implies existence
            lat = self._stream_lat.setdefault(tenant, [])
            lat.append(float(ms))
            if len(lat) > _LAT_CAP:
                del lat[: len(lat) - _LAT_CAP]

    # -- policy --------------------------------------------------------

    def set_policy(self, tenant: str, strict: bool) -> None:
        with self._lock:
            self._policy[tenant] = bool(strict)
            self._row(tenant)  # policy implies existence

    def strict(self, tenant: str,
               override: Optional[bool] = None) -> bool:
        """The door policy for one request: an explicit request-level
        override wins, then the tenant's configured policy, then the
        daemon default."""
        if override is not None:
            return bool(override)
        with self._lock:
            return self._policy.get(tenant, self.strict_default)

    # -- the breaker ---------------------------------------------------

    def label(self, tenant: str) -> str:
        return chaos.TENANT_PREFIX + tenant

    def note_fault(self, tenant: str) -> bool:
        """One breaker strike (a degraded verdict, a plane fault, a
        chaos-attributed failure already lands via dispatch's tenant
        tags — this entry is for service-level evidence). True when
        this strike trips the quarantine."""
        self.note(tenant, "faults")
        return chaos.note_device_failure(
            self.label(tenant), self.quarantine_after
        )

    def quarantined(self, tenant: str) -> bool:
        return chaos.is_quarantined(self.label(tenant))

    # -- dispatch-plane observer (plane.fault_observer) ----------------

    def observe_plane(self, tenant: str, kind: str) -> None:
        """Wired as DispatchPlane.fault_observer: per-future ladder
        events attribute to their submitting tenant."""
        key = (
            "oracle_fallbacks" if kind == "oracle_fallback"
            else "plane_faults"
        )
        self.note(tenant, key)
        # Ladder events are breaker evidence too: a tenant whose every
        # check degrades is indistinguishable from a fault storm.
        self.note_fault(tenant)

    # -- views ---------------------------------------------------------

    def snapshot(self) -> dict:
        """{tenant: row} plus breaker state — the /stats block. Rows
        with stream traffic gain ``stream_p99_ms`` computed from the
        latency reservoir (0.0 until samples arrive)."""
        with self._lock:
            rows = {t: dict(r) for t, r in self._rows.items()}
            p99 = {
                t: _percentile(lat, 0.99)
                for t, lat in self._stream_lat.items()
                if lat
            }
        quarantined = set(chaos.quarantined_tenants())
        for t, r in rows.items():
            if r["stream_chunks"] or t in p99:
                r["stream_p99_ms"] = p99.get(t, 0.0)
            r["quarantined"] = t in quarantined
            with self._lock:
                r["strict"] = self._policy.get(t, self.strict_default)
        return rows


def _percentile(samples, q: float) -> float:
    """Nearest-rank percentile over a small reservoir (no numpy: the
    ledger must stay importable service-side without device deps)."""
    s = sorted(samples)
    k = min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))
    return round(float(s[k]), 3)
