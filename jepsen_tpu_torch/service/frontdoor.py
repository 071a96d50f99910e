"""The fleet front door: one address in front of N checker daemons (the
port of jepsen_tpu.service.frontdoor).

Tenants shard across the fleet by consistent hashing on the tenant id
(``service/membership.py``): every request for tenant T lands on the
same member while membership is stable, so T's admission ledger,
breaker strikes, and stream state live in exactly one place —
member-local ledgers stay authoritative, the front door never
second-guesses an admission verdict. Two stances:

- ``mode="proxy"`` (default): thin forwarding proxy. The door reads
  the request once, journals a durable *intent* record for /check
  bodies (tmp+rename under ``<fleet_dir>/intents/``), forwards to the
  owner, relays the answer, then retires the intent. The journal plus
  ``check_id_for`` content identity is the zero-loss story: if the
  owner dies mid-check the door declares the death (quarantine
  ladder) and replays the SAME bytes to the next member on the ring —
  same bytes, same check id, same checkpoint file under the shared
  store root, so a durable check RESUMES from the dead member's last
  verified frontier instead of restarting.
- ``mode="redirect"``: 307 + ``Location`` to the owner. Zero relay
  cost, the client re-POSTs (307 preserves method/body); pair with a
  client that follows redirects (``service/client.py`` does).

Work-stealing rides the same path: the member-local admission door
answering 429 means the owner's queue is full — the check is queued-
but-unstarted, so the front door forwards it to the owner's ring
successors instead (a *steal*: the hot tenant's overflow runs on idle
members instead of shedding). 503 (owner draining) steals the same
way. Only when EVERY alive member sheds does the client see 429/503 —
with a ``Retry-After`` header, so the fleet client's jittered backoff
honors the fleet's own estimate instead of stampeding.

Streams are sticky (no steal): a stream's incremental frontier lives
on its owner, so /check/stream follows the ring and fails over only
on owner death — a durable stream replayed from the start resumes
from its persisted frontier on the new owner, same as solo restarts.

Gray failures get their own ladder, distinct from death: a forward
that TIMES OUT (connection accepted, reply never came — SIGSTOP, GC
stall, asymmetric partition) marks the member SUSPECT and hedges the
same bytes onto the ring successor without declaring death; only
refused/reset (nothing listening) takes the ``note_member_death``
quarantine path. Every forward feeds a per-member latency EWMA +
error-rate EWMA, and a member whose error rate stays above the
threshold is proactively DRAINED from routing for a cooldown, then
re-probed — slow-but-alive members leave the hot path within
~2× the health window instead of poisoning every request that hashes
to them (the dominant production failure class per the gray-failure
literature, PAPERS.md).

The door itself keeps NO tenant state: everything it knows is
re-derivable from the fleet dir + quarantine ledger, so the door is
restartable and (because intents are durable) its death mid-flight
loses nothing either — ``recover_intents`` replays orphans on start.
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import os
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.service.membership import FleetRegistry, MemberInfo

log = logging.getLogger("jepsen_tpu_torch.service.fleet")

#: statuses meaning "the member's admission door shed this" — the
#: steal trigger (429 queue/tenant caps, 503 draining)
SHED = (429, 503)

#: what the door tells an all-shed client to wait (seconds)
RETRY_AFTER_S = 1

#: per-forward socket timeout: covers the member's full check wall
#: time in proxy mode (durable checks can run many segments)
DEFAULT_FORWARD_TIMEOUT_S = 120.0

#: gray-failure health defaults: a member whose error-rate EWMA sits
#: at/above the threshold after at least MIN_SAMPLES observations is
#: proactively drained from routing for a cooldown (2× the window by
#: default), then re-probed.
DEFAULT_HEALTH_WINDOW_S = 30.0
DEFAULT_DEGRADE_ERR_RATE = 0.5
DEFAULT_DEGRADE_MIN_SAMPLES = 3

#: error-rate / latency EWMA smoothing per observation
_HEALTH_ALPHA = 0.4


def _fleet_counters() -> dict:
    return {
        "routed": 0,        # requests that reached routing
        "proxied": 0,       # forwarded + relayed in proxy mode
        "redirects": 0,     # 307s sent in redirect mode
        "steals": 0,        # shed by owner, accepted by a successor
        "handoffs": 0,      # owner died mid-flight, replayed onward
        "member_deaths": 0, # deaths this door declared
        "suspects": 0,      # timeouts treated as gray, NOT death
        "hedges": 0,        # suspect retried on a ring successor
        "degraded_evictions": 0,  # proactive drains of gray members
        "exhausted": 0,     # every alive member shed or died
        "intents_recovered": 0,
    }


class FleetFrontDoor:
    """The routing tier (module docstring). Construct with the same
    ``fleet_dir`` the members announce into; ``serve_forever`` from a
    thread or the `cli.py fleet` foreground."""

    def __init__(
        self,
        fleet_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        mode: str = "proxy",
        forward_timeout_s: float = DEFAULT_FORWARD_TIMEOUT_S,
        ttl_s: Optional[float] = None,
        health_window_s: float = DEFAULT_HEALTH_WINDOW_S,
        degrade_err_rate: float = DEFAULT_DEGRADE_ERR_RATE,
        degrade_min_samples: int = DEFAULT_DEGRADE_MIN_SAMPLES,
        degrade_cooldown_s: Optional[float] = None,
    ):
        if mode not in ("proxy", "redirect"):
            raise ValueError(f"unknown front-door mode: {mode!r}")
        self.mode = mode
        self.forward_timeout_s = float(forward_timeout_s)
        kw = {} if ttl_s is None else {"ttl_s": ttl_s}
        self.registry = FleetRegistry(fleet_dir, **kw)
        self.intent_dir = os.path.join(fleet_dir, "intents")
        os.makedirs(self.intent_dir, exist_ok=True)
        self._stats_lock = threading.Lock()
        self._counters = _fleet_counters()
        #: gray-failure health plane: per-member latency EWMA +
        #: error-rate EWMA, guarded by _health_lock. A member whose
        #: error rate stays at/above ``degrade_err_rate`` is drained
        #: from routing (``_degraded``: member_id -> evicted-at) for
        #: ``degrade_cooldown_s``, then re-probed.
        self.health_window_s = float(health_window_s)
        self.degrade_err_rate = float(degrade_err_rate)
        self.degrade_min_samples = int(degrade_min_samples)
        self.degrade_cooldown_s = float(
            2.0 * health_window_s
            if degrade_cooldown_s is None else degrade_cooldown_s
        )
        self._health_lock = threading.Lock()
        self._health: Dict[int, dict] = {}
        self._degraded: Dict[int, float] = {}
        self.started_at = time.time()
        handler = type(
            "FleetHandler", (_FleetHandler,), {"door": self}
        )
        self.httpd = ThreadingHTTPServer((host, port), handler,
                                         bind_and_activate=False)
        # The listen backlog: the stdlib's 5 makes the connects of a
        # burst past it wait for a SYN retransmit (a second on Linux),
        # as the daemon's did (service/server.py). The door has no
        # in-flight bound of its own, so it takes the system's most.
        self.httpd.request_queue_size = socket.SOMAXCONN
        try:
            self.httpd.server_bind()
            self.httpd.server_activate()
        except BaseException:
            self.httpd.server_close()
            raise
        self.host, self.port = self.httpd.server_address[:2]

    # -- lifecycle -----------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def serve_forever(self) -> None:
        log.info(
            "fleet front door (%s) on %s over %s",
            self.mode, self.url, self.registry.fleet_dir,
        )
        self.httpd.serve_forever(poll_interval=0.1)

    def shutdown(self) -> None:
        self.httpd.shutdown()

    def close(self) -> None:
        try:
            self.httpd.server_close()
        except OSError:
            pass

    def __enter__(self) -> "FleetFrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._counters[key] += n

    # -- the durable intent journal ------------------------------------

    def _intent_path(self, tenant: str, body: bytes) -> str:
        from jepsen_tpu_torch.service.server import check_id_for

        slug = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in tenant
        )
        return os.path.join(
            self.intent_dir,
            f"{slug}-{check_id_for('intent', body)}.json",
        )

    def journal_intent(
        self, tenant: str, path: str, body: bytes
    ) -> str:
        """Durably record 'this check was accepted by the fleet'
        BEFORE any member sees it. Content-keyed, so a client retry
        of the same bytes overwrites (idempotent) instead of piling
        up. Retired by ``retire_intent`` once a member answered."""
        from jepsen_tpu_torch.store import atomic_write_text

        p = self._intent_path(tenant, body)
        atomic_write_text(p, json.dumps({
            "tenant": tenant,
            "path": path,
            "body_b64": base64.b64encode(body).decode(),
            "ts": time.time(),
        }))
        return p

    def retire_intent(self, intent_path: Optional[str]) -> None:
        if not intent_path:
            return
        try:
            os.unlink(intent_path)
        except OSError:
            pass

    def recover_intents(self) -> List[Tuple[int, dict]]:
        """Replay every orphaned intent (accepted by a door that died
        before a member answered) through the current fleet. Returns
        the (status, verdict) per intent; zero-loss means none are
        silently dropped — an intent that still cannot run stays
        journaled for the next recovery pass."""
        out: List[Tuple[int, dict]] = []
        try:
            names = sorted(os.listdir(self.intent_dir))
        except OSError:
            return out
        for name in names:
            p = os.path.join(self.intent_dir, name)
            try:
                with open(p, encoding="utf-8") as f:
                    d = json.load(f)
                body = base64.b64decode(d["body_b64"])
                tenant, req_path = d["tenant"], d["path"]
            except (OSError, ValueError, KeyError):
                continue  # torn journal file: not an intent
            status, obj, _ = self.dispatch(
                tenant, req_path, body, journal=False
            )
            if status < 500 and status not in SHED:
                self.retire_intent(p)
                self._bump("intents_recovered")
            out.append((status, obj))
        return out

    # -- gray-failure health -------------------------------------------

    def note_member_latency(
        self, member_id: int, elapsed_s: float, ok: bool
    ) -> None:
        """Feed one forward's outcome into the member's health score.
        Timeouts feed ``ok=False`` with the full timeout as latency —
        the EWMA pair is exactly what distinguishes slow-but-alive
        (gray) from healthy. Crossing the degradation threshold drains
        the member from routing (eviction instant fired OUTSIDE the
        health lock)."""
        mid = int(member_id)
        evicted = False
        with self._health_lock:
            row = self._health.setdefault(mid, {
                "ewma_ms": None, "err_rate": 0.0, "samples": 0,
            })
            ms = elapsed_s * 1000.0
            row["ewma_ms"] = (
                ms if row["ewma_ms"] is None
                else (1 - _HEALTH_ALPHA) * row["ewma_ms"]
                + _HEALTH_ALPHA * ms
            )
            row["err_rate"] = (
                (1 - _HEALTH_ALPHA) * row["err_rate"]
                + _HEALTH_ALPHA * (0.0 if ok else 1.0)
            )
            row["samples"] += 1
            row["last_ts"] = time.time()
            if (
                mid not in self._degraded
                and row["samples"] >= self.degrade_min_samples
                and row["err_rate"] >= self.degrade_err_rate
            ):
                self._degraded[mid] = time.monotonic()
                evicted = True
        if evicted:
            self._bump("degraded_evictions")
            log.warning(
                "member %d persistently degraded (gray); draining "
                "from routing for %.1fs", mid, self.degrade_cooldown_s,
            )
            obs_trace.instant(
                "member_degraded", kind="fleet", member=mid,
            )

    def _routable(
        self, order: List[MemberInfo]
    ) -> List[MemberInfo]:
        """Drop degraded-drained members from a route order; expired
        cooldowns are re-admitted on probation (health row reset, so
        stale error history cannot instantly re-evict a recovered
        member). Falls back to the full order rather than routing
        nowhere when EVERY member is drained."""
        now = time.monotonic()
        with self._health_lock:
            for mid, t in list(self._degraded.items()):
                if now - t >= self.degrade_cooldown_s:
                    del self._degraded[mid]
                    self._health.pop(mid, None)
            drained = set(self._degraded)
        if not drained:
            return order
        kept = [m for m in order if m.member_id not in drained]
        return kept or order

    def health_snapshot(self) -> dict:
        """Per-member health rows + the currently-drained set (the
        invariant monitor's gray-eviction evidence)."""
        with self._health_lock:
            return {
                "window_s": self.health_window_s,
                "err_threshold": self.degrade_err_rate,
                "cooldown_s": self.degrade_cooldown_s,
                "rows": {
                    str(mid): dict(row)
                    for mid, row in self._health.items()
                },
                "degraded": sorted(self._degraded),
            }

    # -- forwarding ----------------------------------------------------

    def _forward(
        self, member: MemberInfo, tenant: str, path: str,
        body: bytes,
    ) -> Tuple[int, dict]:
        """One POST relayed to one member. Raises OSError-family on a
        dead member (the caller's death/hand-off trigger)."""
        u = urllib.parse.urlparse(member.url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port, timeout=self.forward_timeout_s
        )
        try:
            conn.request("POST", path, body=body, headers={
                "Content-Type": "application/json",
                "Content-Length": str(len(body)),
                "X-Tenant": tenant,
            })
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            obj = json.loads(raw) if raw else {}
        except ValueError:
            obj = {"error": "bad-upstream-json"}
        return resp.status, obj

    def _fetch_member_json(
        self, member: MemberInfo, path: str, timeout_s: float = 5.0
    ) -> Optional[dict]:
        u = urllib.parse.urlparse(member.url)
        try:
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=timeout_s
            )
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                raw = resp.read()
            finally:
                conn.close()
            return json.loads(raw)
        except (OSError, ValueError):
            return None

    def dispatch(
        self, tenant: str, path: str, body: bytes,
        journal: bool = True,
    ) -> Tuple[int, dict, Optional[int]]:
        """Route one POST through the fleet: (status, response obj,
        serving member id). Owner first; shed → steal to successors;
        dead → quarantine + hand off the same bytes onward. Streams
        (path /check/stream) are sticky: owner or fail-over only,
        never stolen — their incremental state is member-local."""
        self._bump("routed")
        order = self._routable(self.registry.route_order(tenant))
        if not order:
            return 503, {
                "error": "fleet-empty",
                "detail": "no alive members in the fleet",
            }, None
        sticky = path.endswith("/stream")
        intent = None
        if journal and not sticky:
            intent = self.journal_intent(tenant, path, body)
        shed_status, shed_obj = None, None
        for i, member in enumerate(order):
            t0 = time.monotonic()
            try:
                status, obj = self._forward(
                    member, tenant, path, body
                )
            except (socket.timeout, TimeoutError):
                # SUSPECT, not dead: the member accepted the
                # connection but never answered inside the forward
                # budget — the gray-failure signature (SIGSTOP, GC
                # stall, asymmetric partition). Declaring death here
                # is the classic mistake (a slow member quarantined
                # fleet-wide on one slow reply); instead the health
                # EWMA takes the strike — persistent grayness drains
                # the member — and the SAME bytes hedge onto the ring
                # successor, safe because check_id_for content-hash
                # identity makes the duplicate submission idempotent
                # (same checkpoint file, convergent verdict).
                log.warning(
                    "member %d timed out (suspect); hedging onward",
                    member.member_id,
                )
                self.note_member_latency(
                    member.member_id,
                    time.monotonic() - t0, ok=False,
                )
                self._bump("suspects")
                if i + 1 < len(order):
                    self._bump("hedges")
                continue
            except OSError:
                # Refused/reset: the owner (or a successor) is DEAD
                # on the wire — nothing is listening. One declaration
                # ejects it fleet-wide, and the SAME bytes move to
                # the next ring member — content-hash identity turns
                # this into a checkpoint resume for durable checks.
                log.warning(
                    "member %d dead on the wire; handing off",
                    member.member_id,
                )
                self.registry.note_member_death(member.member_id)
                self._bump("member_deaths")
                if i + 1 < len(order):
                    self._bump("handoffs")
                continue
            self.note_member_latency(
                member.member_id, time.monotonic() - t0, ok=True,
            )
            if status in SHED and not sticky:
                # Member-local admission is authoritative: the owner
                # shed, so the check is queued-but-unstarted there.
                # Steal it to the next successor instead of shedding
                # the whole fleet.
                shed_status, shed_obj = status, obj
                continue
            if i > 0 and shed_status is not None:
                self._bump("steals")
            if status < 500 and status not in SHED:
                self.retire_intent(intent)
            obj["fleet_member"] = member.member_id
            return status, obj, member.member_id
        self._bump("exhausted")
        if shed_status is not None:
            # every alive member shed: relay the last member verdict,
            # stamped with the fleet's own backoff estimate
            shed_obj["fleet_exhausted"] = True
            return shed_status, shed_obj, None
        self.retire_intent(intent)  # unroutable, not re-runnable
        return 503, {
            "error": "fleet-unavailable",
            "detail": "all members dead or unreachable",
        }, None

    # -- observability -------------------------------------------------

    def fleet_stats(self) -> dict:
        """The per-member /stats rollup: each alive member's completed
        checks, verdicts, host syncs and kernel launches, summed
        fleet-wide, plus the door's own routing counters, the
        membership snapshot and the health plane."""
        members = {}
        rollup = {
            "completed": 0, "valid": 0, "invalid": 0,
            "host_syncs": 0, "launches": 0,
        }
        for m in self.registry.alive_members():
            s = self._fetch_member_json(m, "/stats")
            if s is None:
                continue
            tenants = s.get("tenants") or {}
            completed = sum(
                int(row.get("completed", 0))
                for row in tenants.values()
            )
            valid = sum(
                int(row.get("valid", 0)) for row in tenants.values()
            )
            invalid = sum(
                int(row.get("invalid", 0))
                for row in tenants.values()
            )
            launch = s.get("launch") or {}
            row = {
                "url": m.url,
                "completed": completed,
                "valid": valid,
                "invalid": invalid,
                "host_syncs": int(launch.get("host_syncs", 0)),
                "launches": int(launch.get("launches", 0)),
                "draining": bool(s.get("draining")),
                "uptime_s": s.get("uptime_s"),
            }
            members[str(m.member_id)] = row
            rollup["completed"] += completed
            rollup["valid"] += valid
            rollup["invalid"] += invalid
            rollup["host_syncs"] += row["host_syncs"]
            rollup["launches"] += row["launches"]
        with self._stats_lock:
            counters = dict(self._counters)
        return {
            "mode": self.mode,
            "uptime_s": time.time() - self.started_at,
            "door": counters,
            "members": members,
            "rollup": rollup,
            "membership": self.registry.snapshot(),
            "health": self.health_snapshot(),
        }


class _FleetHandler(BaseHTTPRequestHandler):
    door: FleetFrontDoor  # bound by FleetFrontDoor.__init__
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet
        pass

    def _send_json(
        self, code: int, obj: dict, headers: Optional[dict] = None
    ) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _tenant(self) -> str:
        from jepsen_tpu_torch.service.tenants import DEFAULT_TENANT

        t = (self.headers.get("X-Tenant") or "").strip()
        return t or DEFAULT_TENANT

    def do_GET(self):  # noqa: N802 (stdlib API)
        d = self.door
        if self.path == "/healthz":
            self._send_json(200, {
                "ok": True,
                "role": "frontdoor",
                "mode": d.mode,
                "members_alive": len(d.registry.alive_members()),
                "uptime_s": time.time() - d.started_at,
            })
            return
        if self.path == "/fleet":
            self._send_json(200, d.registry.snapshot())
            return
        if self.path == "/stats":
            self._send_json(200, d.fleet_stats())
            return
        self._send_json(404, {"error": "not-found"})

    def do_POST(self):  # noqa: N802 (stdlib API)
        d = self.door
        if self.path not in ("/check", "/check/stream"):
            self._send_json(404, {"error": "not-found"})
            return
        tenant = self._tenant()
        cl = self.headers.get("Content-Length")
        if cl is None:
            self._send_json(411, {"error": "length-required"})
            return
        body = self.rfile.read(int(cl))
        if d.mode == "redirect":
            member = d.registry.route(tenant)
            d._bump("routed")
            if member is None:
                self._send_json(
                    503, {"error": "fleet-empty"},
                    headers={"Retry-After": str(RETRY_AFTER_S)},
                )
                return
            d._bump("redirects")
            # 307 preserves method + body; the fleet client re-POSTs
            # the same bytes at the owner (same check id — durable
            # identity survives the extra hop).
            self._send_json(
                307,
                {"redirect": member.url + self.path,
                 "fleet_member": member.member_id},
                headers={"Location": member.url + self.path},
            )
            return
        status, obj, _mid = d.dispatch(tenant, self.path, body)
        headers = (
            {"Retry-After": str(RETRY_AFTER_S)}
            if status in SHED else None
        )
        d._bump("proxied")
        self._send_json(status, obj, headers=headers)
