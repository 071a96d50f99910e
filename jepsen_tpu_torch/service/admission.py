"""Admission control: the daemon's door (a copy of
jepsen_tpu.service.admission).

Every check request passes here BEFORE any host prep or device work:

- payload cap: a Content-Length over ``max_payload_bytes`` is refused
  (413) without reading the body — an oversized tenant cannot make the
  daemon buffer its payload, let alone encode it.
- bounded queue: at most ``max_inflight`` checks in flight across all
  tenants; past that, requests shed with 429 (backpressure the client
  library turns into bounded retry). A queue would only hide the
  latency — shedding keeps the tail honest.
- per-tenant in-flight cap: at most ``per_tenant_inflight`` of the
  global budget per tenant, so one chatty tenant saturating the plane
  still leaves headroom for everyone else (the fairness floor).
- breaker gate: a tenant quarantined by the fault breaker
  (tenants.TenantLedger / chaos.quarantined_tenants) sheds at the door
  with 429 — its fault storm stops reaching the plane entirely.
- drain gate: a draining daemon refuses new checks with 503 while
  in-flight ones finish.

Admission state is a pair of counters under one lock; ``admit`` either
raises AdmissionError (carrying the HTTP status + machine-readable
reason) or returns a token whose ``release()`` MUST run when the check
resolves (the server's finally block).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from jepsen_tpu_torch.service.tenants import TenantLedger

#: default caps — sized for a single-host daemon fronting one card
DEFAULT_MAX_INFLIGHT = 64
DEFAULT_PER_TENANT_INFLIGHT = 16
DEFAULT_MAX_PAYLOAD_BYTES = 32 << 20


class AdmissionError(Exception):
    """Refusal at the door: ``status`` is the HTTP code the server
    responds with, ``reason`` a machine-readable slug for the body."""

    def __init__(self, status: int, reason: str, detail: str = ""):
        self.status = status
        self.reason = reason
        self.detail = detail
        super().__init__(f"{status} {reason}" +
                         (f": {detail}" if detail else ""))


class _Token:
    __slots__ = ("_ctl", "tenant", "_released")

    def __init__(self, ctl: "AdmissionControl", tenant: str):
        self._ctl = ctl
        self.tenant = tenant
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ctl._release(self.tenant)


class AdmissionControl:
    def __init__(
        self,
        ledger: TenantLedger,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
        per_tenant_inflight: int = DEFAULT_PER_TENANT_INFLIGHT,
        max_payload_bytes: int = DEFAULT_MAX_PAYLOAD_BYTES,
    ):
        self.ledger = ledger
        self.max_inflight = max(int(max_inflight), 1)
        self.per_tenant_inflight = max(int(per_tenant_inflight), 1)
        self.max_payload_bytes = int(max_payload_bytes)
        self._lock = threading.Lock()
        self._inflight = 0
        self._per_tenant: Dict[str, int] = {}
        self._draining = threading.Event()
        self._idle = threading.Condition(self._lock)

    # -- gates ---------------------------------------------------------

    def check_payload(self, tenant: str,
                      content_length: Optional[int]) -> None:
        """The 413 gate — called BEFORE the body is read."""
        if content_length is None:
            raise AdmissionError(
                411, "length-required",
                "checks must carry Content-Length",
            )
        if content_length > self.max_payload_bytes:
            self.ledger.note(tenant, "rejected_payload")
            raise AdmissionError(
                413, "payload-too-large",
                f"{content_length} bytes > cap "
                f"{self.max_payload_bytes}",
            )

    def admit(self, tenant: str) -> _Token:
        """Pass every gate or raise; the token's release() is owed."""
        if self._draining.is_set():
            raise AdmissionError(
                503, "draining", "daemon is draining; resubmit",
            )
        if self.ledger.quarantined(tenant):
            self.ledger.note(tenant, "shed_quarantined")
            raise AdmissionError(
                429, "tenant-quarantined",
                f"tenant {tenant!r} tripped the fault breaker",
            )
        with self._lock:
            if self._inflight >= self.max_inflight:
                self.ledger.note(tenant, "shed")
                raise AdmissionError(
                    429, "queue-full",
                    f"{self._inflight} checks in flight "
                    f">= bound {self.max_inflight}",
                )
            mine = self._per_tenant.get(tenant, 0)
            if mine >= self.per_tenant_inflight:
                self.ledger.note(tenant, "shed")
                raise AdmissionError(
                    429, "tenant-inflight-cap",
                    f"tenant {tenant!r} holds {mine} of "
                    f"{self.per_tenant_inflight} slots",
                )
            self._inflight += 1
            self._per_tenant[tenant] = mine + 1
        self.ledger.note(tenant, "accepted")
        return _Token(self, tenant)

    def _release(self, tenant: str) -> None:
        with self._lock:
            self._inflight -= 1
            n = self._per_tenant.get(tenant, 1) - 1
            if n <= 0:
                self._per_tenant.pop(tenant, None)
            else:
                self._per_tenant[tenant] = n
            self._idle.notify_all()

    # -- drain ---------------------------------------------------------

    def start_drain(self) -> None:
        self._draining.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until no checks are in flight (the drain's bounded
        wait). True = drained clean; False = budget expired with work
        still in flight (durable checks resume from their
        checkpoints after restart)."""
        deadline = (
            None if timeout_s is None
            else timeout_s + _monotonic()
        )
        with self._lock:
            while self._inflight > 0:
                remaining = (
                    None if deadline is None
                    else deadline - _monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=remaining)
            return True

    # -- views ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "inflight": self._inflight,
                "per_tenant_inflight": dict(self._per_tenant),
                "max_inflight": self.max_inflight,
                "per_tenant_cap": self.per_tenant_inflight,
                "max_payload_bytes": self.max_payload_bytes,
                "draining": self._draining.is_set(),
            }


def _monotonic() -> float:
    import time

    return time.monotonic()
