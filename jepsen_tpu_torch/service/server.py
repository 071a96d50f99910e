"""The checker daemon: stdlib HTTP/JSON over a local socket (the port of
jepsen_tpu.service.server).

One long-lived process owns the warm dispatch plane of its device
(checker.dispatch.default_plane: the CUDA card unless the daemon is
built with ``device="cpu"``) and serves history-check requests from
many concurrent clients. Handler threads submit through the shared
plane inside a tenant context, then HOLD briefly before resolving
(``coalesce_hold_s``) so concurrent same-shape requests — from
different tenants — meet in one dispatch bucket and ride ONE stacked
kernel launch: the cross-tenant coalescing the bucket keying already
supports within a process, now offered across processes. The hold is
the daemon's; the plane's own ``coalesce_wait_s`` only ages buckets on
its prep worker, which the daemon's plane does not run.

Endpoints::

    POST /check    {"model", "history": [op...], "durable", "strict",
                    "deadline_s", "init_value"}  (tenant: X-Tenant)
    POST /check/stream
                   {"stream_id", "ops": [op...], "final", "model",
                    "init_value", "durable", "restart",
                    "persist_every", "gc_window", "deadline_s"} —
                   chunked streaming check: each chunk appends to a
                   per-(tenant, stream_id) StreamingCheck on the
                   daemon's plane and launches only the new tail;
                   non-final chunks answer 202 with provisional
                   status, the final chunk answers 200 with the
                   definite verdict
    GET  /stats    dispatch + launch + mesh + resilience +
                   checkpoint + streaming + txn-graph + trace
                   snapshots, plus the
                   tenant-ledger and admission ones
    GET  /metrics  Prometheus text exposition, including per-tenant
                   labeled gauge families reconciled from the live
                   TenantLedger rows
    GET  /trace    drain the live flight-recorder ring as validated
                   Chrome-trace JSON (empty trace when the recorder
                   is disabled); each GET returns the events since
                   the previous one
    GET  /healthz  liveness + drain state

Models: ``cas-register`` and ``register`` (the plane's bitset or
segmented path, coalesced), ``unordered-queue`` (the per-value batch:
LinearizableChecker.check on the daemon's device, one kernel-B launch
over the values, on the plane's stream) and ``txn-graph``
(TxnGraphChecker.check_async on the plane's graph bucket).

Every request — GET or POST, admitted or shed — lands exactly once in
the structured JSONL audit log (``service/audit.py``): tenant,
admission verdict, HTTP status, wall seconds, and the device launches
attributed to the request window. Size-rotated, fsync'd before the
response leaves.

HTTP status mapping (the analyze exit-code contract, served):

    200  verdict delivered ("valid?" true/false = exit 0/1)
    400  malformed request (bad JSON / missing history)
    411  missing Content-Length
    413  payload over the admission cap
    422  hostile history under a strict sentry policy   (= exit 3)
    429  shed: queue bound / tenant cap / tenant breaker
    500  analysis error                                  (= exit 2)
    503  draining — resubmit after restart
    504  request deadline_s expired (the check still completes and
         warms the caches; only the response is abandoned)

On the card a check the plane cannot run answers 500: the card's plane
fails its riders with the PlaneFault instead of answering from the host
oracle (a daemon built with ``degrade=True``, and every CPU daemon,
answers from the oracle with ``degraded`` on the verdict, as the
reference does).

Durable checks (``"durable": true``) run through the checkpoint sink
keyed by a content-derived check id: every verified segment boundary
persists into the store before the next launches, so a SIGKILL
mid-check loses nothing — a resubmission of the SAME history (same id,
any client, after any restart, either package's daemon over the same
store) resumes at the last durable frontier and the verdict carries
the resume evidence in its "checkpoint" block.

Graceful drain: ``drain()`` (wired to SIGTERM by ``cli.py daemon``)
stops admission (new checks see 503), waits up to ``drain_s`` for
in-flight checks to resolve, then stops the serve loop. In-flight
durable checks that outlive the budget are safe by construction —
their last verified boundary is already on disk.

Fleet membership (``fleet_dir``): the daemon announces its URL into the
fleet dir after the bind and heartbeats until it drains
(service/membership.py); its owner tag (``member-<id>``, or
``member-<id>e<epoch>`` from epoch 1) is stamped into the durable
checkpoints it writes, so a hand-off resume names the member it came
from. A heartbeat that finds a higher epoch in the member's own file
(a supervisor respawned a replacement) drains the daemon.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from jepsen_tpu_torch.checker import chaos, dispatch
from jepsen_tpu_torch.device import on_stream, resolve_device
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.sentry import (
    HistorySentryError,
    validate_history,
)
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.service.admission import (
    DEFAULT_MAX_INFLIGHT,
    DEFAULT_MAX_PAYLOAD_BYTES,
    DEFAULT_PER_TENANT_INFLIGHT,
    AdmissionControl,
    AdmissionError,
)
from jepsen_tpu_torch.service.audit import AuditLog, default_audit_path
from jepsen_tpu_torch.service.tenants import DEFAULT_TENANT, TenantLedger
from jepsen_tpu_torch.store import Store, op_from_json

log = logging.getLogger("jepsen_tpu_torch.service")

#: default local port (0 = ephemeral, the tests' mode)
DEFAULT_PORT = 8008

#: default hold between submit and resolve — the coalescing window.
#: Cheap against a launch train's host sync; 0 disables.
DEFAULT_COALESCE_HOLD_S = 0.005


def check_id_for(model: str, body: bytes) -> str:
    """Content-derived durable-check identity: the same history +
    model from any client, before or after a daemon restart, maps to
    the same checkpoint file — that is what makes resubmission resume
    instead of restart."""
    h = hashlib.sha256()
    h.update(model.encode())
    h.update(b"|")
    h.update(body)
    return h.hexdigest()[:16]


def _jsonable(v: Any):
    """Verdicts carry numpy scalars, tuples, and sets; the wire gets
    plain JSON (tuples/sets as lists, non-str keys stringified)."""
    if isinstance(v, dict):
        return {
            (k if isinstance(k, str) else str(k)): _jsonable(x)
            for k, x in v.items()
        }
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(
            (_jsonable(x) for x in v),
            key=lambda e: json.dumps(e, sort_keys=True, default=str),
        )
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            return v.item()  # numpy scalar
        except Exception:  # noqa: BLE001
            pass
    if hasattr(v, "tolist"):
        return v.tolist()  # numpy array
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class CheckerDaemon:
    """The long-lived multi-tenant analysis daemon (module docstring).

    Parameters mirror the `cli.py daemon` flags. ``device``: None runs
    on the CUDA card (raising at construction without one); "cpu" runs
    every kernel's plain version. ``degrade``: the plane's (None: on
    for the CPU, off for the card). The daemon takes ownership of the
    process-wide default plane of its device: construction resets the
    default planes and rebuilds this one with the daemon's model,
    launch deadline and owner tag. With ``own_plane=False`` it shares
    the default plane already built on its device instead (N daemons
    in one process, as the in-process fleets of the tests run).
    ``fleet_dir``, ``member_id`` and ``member_epoch`` (default
    $JEPSEN_TPU_FLEET_EPOCH) make it a fleet member (module
    docstring)."""

    def __init__(
        self,
        root: str = "store",
        host: str = "127.0.0.1",
        port: int = DEFAULT_PORT,
        model: str = "cas-register",
        device=None,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
        per_tenant_inflight: int = DEFAULT_PER_TENANT_INFLIGHT,
        max_payload_bytes: int = DEFAULT_MAX_PAYLOAD_BYTES,
        strict_default: bool = False,
        tenant_quarantine_after: int = 5,
        coalesce_hold_s: float = DEFAULT_COALESCE_HOLD_S,
        launch_deadline_s: Optional[float] = None,
        degrade: Optional[bool] = None,
        drain_s: float = 10.0,
        audit_path: Optional[str] = None,
        audit_max_bytes: int = 4 * 1024 * 1024,
        fleet_dir: Optional[str] = None,
        member_id: Optional[int] = None,
        member_epoch: Optional[int] = None,
        own_plane: bool = True,
    ):
        # no card and no "cpu": fail before any socket or file exists
        self.device = resolve_device(device)
        self.root = root
        self.model = model
        self.coalesce_hold_s = max(float(coalesce_hold_s), 0.0)
        self.drain_s = drain_s
        self.store = Store(root)
        # The control audit plane: one record per request, durable
        # before the response leaves (service/audit.py).
        self.audit = AuditLog(
            audit_path or default_audit_path(root),
            max_bytes=audit_max_bytes,
        )
        self.ledger = TenantLedger(
            strict_default=strict_default,
            quarantine_after=tenant_quarantine_after,
        )
        self.admission = AdmissionControl(
            self.ledger,
            max_inflight=max_inflight,
            per_tenant_inflight=per_tenant_inflight,
            max_payload_bytes=max_payload_bytes,
        )
        #: fleet identity (None when solo), tagged into durable
        #: checkpoint state so a hand-off resume is attributable
        if fleet_dir is not None and member_id is None:
            member_id = 0
        if member_epoch is None:
            member_epoch = int(
                os.environ.get("JEPSEN_TPU_FLEET_EPOCH", "0") or 0
            )
        self.member_id = member_id
        self.member_epoch = int(member_epoch)
        self.fleet_dir = fleet_dir
        self._registry = None
        #: the nemesis's reply gate (service/nemesis.py ResponseGate):
        #: when set, every response passes through it, the in-process
        #: fleet's stall/delay/drop seam. None in production.
        self.chaos_gate = None
        # epoch 0 keeps the plain owner tag; a supervised respawn's
        # owner carries its epoch, so a hand-off back to a resurrected
        # member id still reads as a distinct owner
        owner = None
        if member_id is not None:
            owner = (
                f"member-{member_id}" if not self.member_epoch
                else f"member-{member_id}e{self.member_epoch}"
            )
        if own_plane:
            # Own the process-wide plane of the device, with its mesh
            # (the ambient one: every healthy slot of the device's type
            # under the mesh policy): the memo and compile caches live
            # for the daemon's life; every tenant's checks share them.
            dispatch.reset_default_plane()
            self.plane = dispatch.default_plane(
                self.device,
                model=model,
                degrade=degrade,
                launch_deadline_s=launch_deadline_s,
                owner=owner,
            )
            self.plane.fault_observer = self.ledger.observe_plane
        else:
            # N daemons in one process share the default plane already
            # built on the device (a reset would orphan every sibling's
            # plane); the owner is stamped on the sinks in handle_check.
            self.plane = dispatch.default_plane(self.device)
        self._owner = owner
        self.started_at = time.time()
        #: live streaming checks, keyed (tenant, stream_id) — each
        #: holds a checker/streaming.py StreamingCheck that chunked
        #: POST /check/stream requests append into.
        self._streams: dict = {}
        self._streams_lock = threading.Lock()
        self._drained = threading.Event()
        handler = type(
            "Handler", (_Handler,), {"daemon_obj": self}
        )
        self.httpd = ThreadingHTTPServer((host, port), handler,
                                         bind_and_activate=False)
        # The listen backlog: the stdlib's 5 makes the connects of a
        # burst past it wait for a SYN retransmit (a second on Linux)
        # and miss the coalescing hold. Every request the admission
        # bound lets in gets a slot.
        self.httpd.request_queue_size = max(self.admission.max_inflight, 5)
        try:
            self.httpd.server_bind()
            self.httpd.server_activate()
        except BaseException:
            self.httpd.server_close()
            raise
        self.host, self.port = self.httpd.server_address[:2]
        if fleet_dir is not None:
            # Announce AFTER the bind (the URL in the member file must
            # be connectable the moment a router reads it), then
            # heartbeat until drain/close.
            from jepsen_tpu_torch.service.membership import FleetRegistry

            self._registry = FleetRegistry(
                fleet_dir, member_id=member_id, url=self.url,
                epoch=self.member_epoch,
            )
            self._registry.announce()
            self._registry.start_heartbeat(on_fenced=self._on_fenced)

    # -- lifecycle -----------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def serve_forever(self) -> None:
        log.info("checker daemon serving on %s (store=%s)",
                 self.url, self.root)
        self.httpd.serve_forever(poll_interval=0.1)

    def _on_fenced(self) -> None:
        """The heartbeat found a HIGHER epoch in this member's own
        registry row: a supervisor respawned a replacement while this
        incarnation was stalled or presumed dead. Re-claiming ownership
        would double-own checks already handed off, so drain: stop
        admitting, finish what is in flight (durable frontiers are safe
        either way), get off the port."""
        log.warning(
            "member %s (epoch %d) fenced by a newer incarnation; "
            "draining", self.member_id, self.member_epoch,
        )
        obs_trace.instant(
            "member_fenced", kind="fleet",
            member=self.member_id, epoch=self.member_epoch,
        )
        self.drain()

    def drain(self, signum: Optional[int] = None) -> bool:
        """Graceful drain: stop admitting, wait (bounded) for
        in-flight checks, stop the serve loop. Idempotent; safe from
        any thread except the one inside serve_forever. Returns True
        when every in-flight check resolved inside the budget."""
        if self._drained.is_set():
            return True
        log.info(
            "drain requested%s: admission closed, waiting up to "
            "%.1fs for in-flight checks",
            f" (signal {signum})" if signum else "", self.drain_s,
        )
        if self._registry is not None:
            # Routers skip draining members at once (no TTL wait). A
            # FENCED member must not touch the row at all: it belongs
            # to the replacement now (announce would raise).
            from jepsen_tpu_torch.service.membership import MemberFenced

            try:
                self._registry.announce(draining=True)
            except (OSError, MemberFenced):
                pass
        self.admission.start_drain()
        clean = self.admission.wait_idle(self.drain_s)
        if not clean:
            log.warning(
                "drain budget expired with checks in flight; durable "
                "checks resume from their last checkpoint on restart"
            )
        self._drained.set()
        self.httpd.shutdown()
        return clean

    def close(self) -> None:
        """Release the socket. The default plane stays up (it is
        process-wide); tests that cycle daemons reset it themselves."""
        if self._registry is not None:
            self._registry.retire()
        try:
            self.httpd.server_close()
        except OSError:
            pass
        self.audit.close()

    def __enter__(self) -> "CheckerDaemon":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the check pipeline (called from handler threads) --------------

    def stats(self) -> dict:
        from jepsen_tpu_torch.obs.snapshot import engine_snapshot

        # the consolidated engine snapshot (dispatch/launch/resilience/
        # checkpoint/streaming/txn_graph/trace) plus the service-only
        # surfaces layered on top
        out = {
            **engine_snapshot(),
            "tenants": self.ledger.snapshot(),
            "admission": self.admission.snapshot(),
            "uptime_s": time.time() - self.started_at,
            "draining": self.admission.draining,
        }
        if self.member_id is not None:
            # the fleet identity block: the front door's /stats rollup
            # keys its per-member rows on it
            out["member"] = {
                "member_id": self.member_id,
                "epoch": self.member_epoch,
                "fleet_dir": self.fleet_dir,
                "url": self.url,
                "pid": os.getpid(),
            }
        return out

    def checkpoint_path(self, tenant: str, check_id: str) -> str:
        return self.store.service_checkpoint_path(tenant, check_id)

    def handle_check(self, tenant: str, body: bytes) -> tuple:
        """(status, response dict) for one admitted check request.
        The admission token is already held by the caller."""
        try:
            req = json.loads(body)
            ops = req["history"]
            if not isinstance(ops, list):
                raise TypeError("history must be a list of ops")
            history = History(
                [op_from_json(d) for d in ops], indexed=True
            )
        except HistorySentryError:
            raise
        except Exception as e:  # noqa: BLE001 - malformed request
            return 400, {"error": "bad-request", "detail": str(e)}
        model = req.get("model", self.model)
        durable = bool(req.get("durable"))
        deadline_s = req.get("deadline_s")

        # Sentry at the door, per-tenant policy: strict tenants get a
        # 422 refusal (the exit-code-3 analog); repair tenants get a
        # repaired history plus the report in their verdict. Either
        # way nothing unvalidated ever reaches the encoder.
        strict = self.ledger.strict(tenant, req.get("strict"))
        try:
            history, hreport = validate_history(history, strict=strict)
        except HistorySentryError as e:
            self.ledger.note(tenant, "hostile")
            # Breaker evidence: a tenant spamming hostile histories
            # eventually sheds at the door without sentry work.
            self.ledger.note_fault(tenant)
            return 422, {
                "error": "hostile-history",
                "classes": _jsonable(e.classes),
                "detail": str(e),
            }
        if hreport is not None and not hreport.get("clean"):
            self.ledger.note(tenant, "repaired")

        check_id = check_id_for(model, body)

        def run() -> dict:
            from jepsen_tpu_torch.checker.linearizable import (
                LinearizableChecker,
            )

            if model == "txn-graph":
                # Transactional dependency-graph path: no durable
                # checkpoint seam (graph checks are single-launch),
                # but the submit/hold/resolve window still coalesces
                # concurrent tenants' adjacency batches.
                from jepsen_tpu_torch.checker.txn_graph import (
                    TxnGraphChecker,
                )

                tg = TxnGraphChecker(plane=self.plane)
                with dispatch.tenant_context(tenant):
                    resolver = tg.check_async({}, history)
                    if self.coalesce_hold_s:
                        time.sleep(self.coalesce_hold_s)
                    return resolver()

            if model == "unordered-queue":
                # The per-value batch (LinearizableChecker.check's queue
                # route): one kernel-B launch over the values, on the
                # plane's stream. The reference's daemon submits the
                # whole history as one stream instead, which past the
                # packed envelope the host oracle answers.
                queue = LinearizableChecker(
                    model=model,
                    init_value=req.get("init_value"),
                    device=self.device,
                    sentry=False,  # the door already validated
                )
                with dispatch.tenant_context(tenant), \
                        on_stream(self.plane.stream):
                    return queue.check({}, history)

            checker = LinearizableChecker(
                model=model,
                init_value=req.get("init_value"),
                plane=self.plane,
                sentry=False,  # the door already validated
            )
            with dispatch.tenant_context(tenant):
                if durable:
                    from jepsen_tpu_torch.checker.checkpoint import (
                        CheckpointSink,
                    )

                    self.ledger.note(tenant, "durable_checks")
                    seg_env = os.environ.get("JEPSEN_TPU_SEG_MIN_LEN")
                    sink = CheckpointSink(
                        self.checkpoint_path(tenant, check_id),
                        seg_min_len=int(seg_env) if seg_env else None,
                        owner=self._owner,
                    )
                    out = checker.check({}, history, checkpoint=sink)
                    if sink.resumed_from > 0:
                        self.ledger.note(tenant, "durable_resumes")
                    if sink.replayed:
                        self.ledger.note(tenant, "durable_replays")
                    return out
                # The coalescing window: submit, hold, resolve — a
                # concurrent same-shape request lands in the same
                # bucket during the hold and shares the launch.
                resolver = checker.check_async({}, history)
                if self.coalesce_hold_s:
                    time.sleep(self.coalesce_hold_s)
                return resolver()

        try:
            with obs_trace.span("check", kind="service", tenant=tenant,
                                model=model, durable=durable,
                                deadline_s=deadline_s):
                if deadline_s is not None:
                    out = chaos.run_with_deadline(run, float(deadline_s))
                else:
                    out = run()
        except chaos.DeadlineExceeded:
            self.ledger.note(tenant, "deadline_timeouts")
            return 504, {
                "error": "deadline-exceeded",
                "deadline_s": deadline_s,
                "check_id": check_id,
            }
        except Exception as e:  # noqa: BLE001 - the exit-2 analog
            log.exception("check failed (tenant=%s)", tenant)
            self.ledger.note(tenant, "errors")
            return 500, {"error": "check-failed", "detail": str(e)}
        self.ledger.note(tenant, "completed")
        self.ledger.note(
            tenant, "valid" if out.get("valid?") else "invalid"
        )
        out = _jsonable(out)
        out["tenant"] = tenant
        out["check_id"] = check_id
        return 200, out

    def handle_stream(self, tenant: str, body: bytes) -> tuple:
        """(status, response dict) for one chunk of a streaming check.

        Request: {"stream_id": str, "ops": [op...], "final": bool,
                  "model"?, "init_value"?, "durable"?, "restart"?,
                  "deadline_s"?, "persist_every"?, "gc_window"?}.
        Chunks append into one per-(tenant, stream_id) StreamingCheck
        — routed through the shared dispatch plane's "stream" bucket,
        so concurrent same-shape streams coalesce their tails into
        stacked launches (checker/streaming.py module docstring).
        Non-final chunks answer 202 with the provisional status; a
        final chunk answers 200 with the definite verdict and drops the
        handle.

        "durable" persists the stream frontier under the service
        checkpoint root (batched every ``persist_every`` appends), so
        a daemon restart resumes the stream when the client replays it
        from the start. "gc_window" bounds the stream's retained state
        O(window) via frontier GC. "deadline_s" is the per-append SLO
        budget: a chunk that lands over budget still answers (the
        verdict is already computed — aborting would poison the
        stream) but counts a stream_deadline_misses strike in the
        tenant ledger and carries "deadline_miss": true; append wall
        latency feeds the tenant's stream_p99_ms reservoir either
        way."""
        from jepsen_tpu_torch.checker.streaming import StreamingCheck

        try:
            req = json.loads(body)
            stream_id = str(req.get("stream_id") or "").strip()
            if not stream_id:
                raise ValueError("stream_id is required")
            ops = [op_from_json(d) for d in req.get("ops", [])]
            final = bool(req.get("final"))
            restart = bool(req.get("restart"))
            deadline_s = req.get("deadline_s")
            if deadline_s is not None:
                deadline_s = float(deadline_s)
        except Exception as e:  # noqa: BLE001 - malformed request
            return 400, {"error": "bad-request", "detail": str(e)}
        key = (tenant, stream_id)
        with self._streams_lock:
            if restart:
                # The client is replaying the stream from op 0: drop
                # any existing handle so the replay builds a coherent
                # history instead of appending after a poisoned prefix;
                # a DURABLE stream still resumes launch-free from its
                # persisted frontier when the replayed prefix hashes
                # identically.
                self._streams.pop(key, None)
            ent = self._streams.get(key)
            if ent is None:
                path = None
                if req.get("durable"):
                    self.ledger.note(tenant, "durable_checks")
                    path = self.store.service_checkpoint_path(
                        tenant, "stream-" + stream_id
                    ).replace("checkpoint.json", "stream.json")
                sc = StreamingCheck(
                    model=req.get("model", self.model),
                    init_value=req.get("init_value"),
                    device=self.device,
                    path=path,
                    plane=self.plane,
                    hold_s=self.coalesce_hold_s,
                    persist_every=int(req.get("persist_every", 1)),
                    gc_window=req.get("gc_window"),
                )
                ent = (sc, threading.Lock())
                self._streams[key] = ent
        sc, sc_lock = ent
        t0 = time.monotonic()
        try:
            with dispatch.tenant_context(tenant):
                # Single-writer per STREAM: concurrent chunks of one
                # stream serialize on the stream's own lock. The
                # registry lock is released first, so one stream's
                # launch never stalls another tenant's streams.
                with sc_lock:
                    status = sc.append(ops) if ops else sc.status()
                    # planelint: disable=JT202 reason=sc.result is the stream verdict computation, not a Future wait; the per-stream lock is held across it BY DESIGN (single-writer: only the same stream's next chunk contends)
                    out = sc.result() if final else None
        except Exception as e:  # noqa: BLE001 - the exit-2 analog
            log.exception("stream chunk failed (tenant=%s)", tenant)
            self.ledger.note(tenant, "errors")
            with self._streams_lock:
                self._streams.pop(key, None)
            return 500, {"error": "check-failed", "detail": str(e)}
        self.ledger.note(tenant, "stream_chunks")
        # Per-append SLO accounting: every chunk's wall latency feeds
        # the tenant p99 reservoir; over-budget chunks strike the
        # deadline-miss counter (surfaced on /stats and /metrics).
        elapsed_ms = (time.monotonic() - t0) * 1000.0
        self.ledger.note_stream_latency(tenant, elapsed_ms)
        missed = (
            deadline_s is not None
            and elapsed_ms > deadline_s * 1000.0
        )
        if missed:
            self.ledger.note(tenant, "stream_deadline_misses")
        if not final:
            status = _jsonable(status)
            status["tenant"] = tenant
            status["stream_id"] = stream_id
            if missed:
                status["deadline_miss"] = True
            return 202, status
        with self._streams_lock:
            self._streams.pop(key, None)
        if sc.resumed:
            self.ledger.note(tenant, "durable_resumes")
        self.ledger.note(tenant, "completed")
        self.ledger.note(
            tenant, "valid" if out.get("valid?") else "invalid"
        )
        out = _jsonable(out)
        out["tenant"] = tenant
        out["stream_id"] = stream_id
        if missed:
            out["deadline_miss"] = True
        return 200, out


def _launch_count() -> int:
    """Live device-launch counter, for attributing launches to a
    request window in the audit log. Under concurrent requests the
    windows overlap, so attribution is an upper bound per record —
    the audit plane documents cost, the ledger owns exact accounting."""
    from jepsen_tpu_torch.device import launch_stats_snapshot

    return int(launch_stats_snapshot()["launches"])


def _json_body(code: int, obj: dict) -> tuple:
    return code, json.dumps(obj).encode(), "application/json"


class _Handler(BaseHTTPRequestHandler):
    daemon_obj: CheckerDaemon  # bound by CheckerDaemon.__init__
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet
        pass

    def _gate_allows_reply(self) -> bool:
        """The nemesis's reply gate (service/nemesis.py): requests are
        accepted and processed normally; only the reply is delayed,
        stalled or dropped. A gray member looks alive at the TCP layer
        while starving its callers, which is what the front door's
        suspect ladder must detect."""
        g = self.daemon_obj.chaos_gate
        if g is None:
            return True
        if g.apply() == "drop":
            self.close_connection = True
            return False
        return True

    def _send_json(self, code: int, obj: dict) -> None:
        if not self._gate_allows_reply():
            return
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _tenant(self) -> str:
        t = (self.headers.get("X-Tenant") or "").strip()
        return t or DEFAULT_TENANT

    def _send_text(self, code: int, body: bytes, ctype: str) -> None:
        if not self._gate_allows_reply():
            return
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        d = self.daemon_obj
        tenant = self._tenant()
        t0 = time.perf_counter()
        l0 = _launch_count()
        code, body, ctype = self._route_get(d)
        # GET endpoints are unmetered (no admission gate), but they
        # still appear exactly once in the control audit plane —
        # durable before the response leaves.
        d.audit.record(
            tenant=tenant, path=self.path, admission="open",
            status=code, wall_s=time.perf_counter() - t0,
            launches=_launch_count() - l0,
        )
        self._send_text(code, body, ctype)

    def _route_get(self, d: CheckerDaemon) -> tuple:
        """(status, body bytes, content type) for one GET."""
        if self.path == "/healthz":
            return _json_body(200, {
                "ok": True,
                "draining": d.admission.draining,
                "uptime_s": time.time() - d.started_at,
            })
        if self.path == "/stats":
            return _json_body(200, _jsonable(d.stats()))
        if self.path == "/metrics":
            from jepsen_tpu_torch.obs.prom import prometheus_text

            # tenants= adds the per-tenant labeled gauge families —
            # the exposition reconciles exactly with the live ledger
            body = prometheus_text(
                tenants=d.ledger.snapshot()
            ).encode()
            return 200, body, "text/plain; version=0.0.4"
        if self.path == "/trace":
            from jepsen_tpu_torch.obs.export import (
                chrome_trace,
                validate_chrome_trace,
            )

            # Drain the live ring: lower everything recorded so far,
            # validate against the Chrome-trace schema (an export
            # Perfetto can't load is a 500, not a silent download),
            # then reset the ring so the next GET returns only what
            # happened since. Events emitted between the snapshot and
            # the reset are dropped — the ring already drops on
            # overflow, and the loss is bounded by the handler's wall.
            events = obs_trace.TRACER.spans()
            obj = chrome_trace(events)
            errors = validate_chrome_trace(obj)
            if errors:
                return _json_body(500, {
                    "error": "trace-invalid", "detail": errors[:5],
                })
            obs_trace.TRACER.reset()
            obj["metadata"] = {
                "events": len(events),
                "enabled": obs_trace.TRACER.enabled,
            }
            return _json_body(200, obj)
        return _json_body(404, {"error": "not-found"})

    def do_POST(self):  # noqa: N802 (stdlib API)
        d = self.daemon_obj
        tenant = self._tenant()
        t0 = time.perf_counter()
        l0 = _launch_count()
        admission = "rejected"
        status = 500
        obj: dict = {"error": "internal"}
        try:
            if self.path not in ("/check", "/check/stream"):
                admission, status = "open", 404
                obj = {"error": "not-found"}
                return
            cl = self.headers.get("Content-Length")
            # per-request root span: tenant + path up front, admission
            # verdict and response status attached as they're decided
            with obs_trace.span("request", kind="service",
                                tenant=tenant, path=self.path) as sp:
                try:
                    d.admission.check_payload(
                        tenant, int(cl) if cl is not None else None
                    )
                    token = d.admission.admit(tenant)
                except AdmissionError as e:
                    admission, status = e.reason, e.status
                    sp.set(admission=e.reason, status=e.status)
                    obj = {"error": e.reason, "detail": e.detail}
                    return
                admission = "admitted"
                sp.set(admission="admitted")
                try:
                    body = self.rfile.read(int(cl))
                    if self.path == "/check/stream":
                        status, obj = d.handle_stream(tenant, body)
                    else:
                        status, obj = d.handle_check(tenant, body)
                except Exception as e:  # noqa: BLE001 - last resort
                    log.exception("unhandled service error")
                    status, obj = 500, {
                        "error": "internal", "detail": str(e),
                    }
                finally:
                    token.release()
                sp.set(status=status)
        finally:
            # Exactly one audit record per request, whatever path the
            # handler took (shed at the door, crashed, or answered) —
            # durable BEFORE the response leaves, so a reader who saw
            # the response is guaranteed to find the record.
            d.audit.record(
                tenant=tenant, path=self.path, admission=admission,
                status=status, wall_s=time.perf_counter() - t0,
                launches=_launch_count() - l0,
            )
            self._send_json(status, obj)
