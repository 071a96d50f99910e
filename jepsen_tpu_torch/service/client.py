"""Stdlib client for the checker daemon — and for the fleet (a copy of
jepsen_tpu.service.client, over the port's store op JSON).

One ``CheckerClient`` speaks to one address as one tenant. ``check()``
serializes a history (a History, a list of Ops, or already-encoded
dicts) through the store's canonical op JSON, POSTs it with the
tenant header, and returns the verdict dict — raising ServiceError
for every non-200, with JITTERED bounded exponential backoff on the
two retryable refusals (429 shed, 503 draining): backpressure the
daemon emits becomes polite retry here, not a hot loop, and the
jitter decorrelates a thundering herd of clients retrying into a
recovering member at the same instant. When the response carries a
``Retry-After`` header (the fleet front door's all-members-loaded
estimate, or any member's own), that wait wins over the computed
backoff — the server knows its recovery horizon better than the
client's doubling schedule does.

Fleet-aware: a 307/308 answer (the front door's ``mode="redirect"``
stance) is followed to its ``Location`` — method + body preserved, so
the re-POST carries the same bytes and lands the same durable check
id at the owner. Redirect hops are bounded and not charged against
the retry budget; a retryable refusal AFTER a redirect retries at the
ORIGINAL address (the front door re-routes — the shed member's load
is exactly why the ring should pick again).

The tests and chip_smoke.py's service phases use it as the
tenant-side half of every service scenario.
"""

from __future__ import annotations

import http.client
import json
import random
import time
import urllib.parse
from typing import Any, Iterable, Optional

from jepsen_tpu_torch.service.tenants import DEFAULT_TENANT

#: refusals worth retrying — shed (429) and draining (503)
RETRYABLE = frozenset({429, 503})

#: fleet redirect statuses worth following (method/body-preserving)
REDIRECT = frozenset({307, 308})

#: redirect-chain bound — a routing loop fails fast, not forever
MAX_REDIRECTS = 4

#: how many times a stream replays itself from op 0 after losing its
#: sticky owner before giving up (each replay needs the fleet to hold
#: still long enough for every chunk to land on ONE member)
MAX_STREAM_REPLAYS = 3


class ServiceError(Exception):
    """A non-200 daemon response: carries the HTTP ``status``, the
    machine-readable ``reason`` slug, and the decoded ``body``."""

    def __init__(self, status: int, reason: str, body: Optional[dict]):
        self.status = status
        self.reason = reason
        self.body = body or {}
        detail = self.body.get("detail", "")
        super().__init__(
            f"{status} {reason}" + (f": {detail}" if detail else "")
        )


def encode_history(history: Iterable) -> list:
    """History | list[Op] | list[dict] -> wire ops (store op JSON)."""
    from jepsen_tpu_torch.store import op_to_json

    ops = getattr(history, "ops", history)
    return [o if isinstance(o, dict) else op_to_json(o) for o in ops]


class CheckerClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8008,
        tenant: str = DEFAULT_TENANT,
        timeout_s: float = 120.0,
        retries: int = 3,
        backoff_s: float = 0.05,
    ):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.timeout_s = timeout_s
        self.retries = max(int(retries), 0)
        self.backoff_s = backoff_s

    # -- transport -----------------------------------------------------

    def _request(
        self, method: str, path: str, body: Optional[bytes] = None,
        host: Optional[str] = None, port: Optional[int] = None,
    ) -> tuple:
        """(status, decoded json, response headers) for one HTTP
        round trip; a fresh connection per request keeps the client
        free of pooled-socket state across daemon restarts (the drain
        tests kill daemons). host/port override the constructor's for
        one hop — the redirect-following leg."""
        conn = http.client.HTTPConnection(
            host or self.host,
            self.port if port is None else port,
            timeout=self.timeout_s,
        )
        try:
            headers = {"X-Tenant": self.tenant}
            if body is not None:
                headers["Content-Type"] = "application/json"
                headers["Content-Length"] = str(len(body))
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            try:
                obj = json.loads(raw) if raw else {}
            except ValueError:
                obj = {"detail": raw.decode(errors="replace")}
            return resp.status, obj, dict(resp.getheaders())
        finally:
            conn.close()

    @staticmethod
    def _retry_after(headers: dict) -> Optional[float]:
        """The server's own backoff estimate, when parseable (the
        delta-seconds form; HTTP-date is not worth a date parser on a
        localhost control plane)."""
        for k, v in headers.items():
            if k.lower() == "retry-after":
                try:
                    return max(float(v), 0.0)
                except (TypeError, ValueError):
                    return None
        return None

    def _roundtrip(self, method: str, path: str,
                   body: Optional[bytes] = None) -> dict:
        delay = self.backoff_s
        target = (None, None, path)  # (host, port, path) overrides
        hops = 0
        attempt = 0
        while True:
            host, port, p = target
            status, obj, headers = self._request(
                method, p, body, host=host, port=port
            )
            if status in REDIRECT and hops < MAX_REDIRECTS:
                loc = headers.get("Location") or headers.get(
                    "location"
                )
                if loc:
                    # Follow the fleet's routing answer: same method,
                    # same bytes, the owner's address. Not charged as
                    # a retry — nothing was refused.
                    u = urllib.parse.urlparse(loc)
                    target = (
                        u.hostname or host,
                        u.port if u.port is not None else port,
                        u.path or p,
                    )
                    hops += 1
                    continue
            if 200 <= status < 300:
                # 200 = verdict; 202 = a stream chunk's provisional
                # status — both are answers, not refusals
                return obj
            if status in RETRYABLE and attempt < self.retries:
                ra = self._retry_after(headers)
                if ra is not None:
                    # honor the server's estimate, decorrelated with
                    # up to 25% jitter ON TOP (never below it)
                    wait = ra * random.uniform(1.0, 1.25)
                else:
                    # full-jitter exponential: mean half the doubling
                    # schedule, zero synchronization between clients
                    wait = random.uniform(0.0, delay)
                time.sleep(wait)
                delay *= 2
                attempt += 1
                # a shed AFTER a redirect retries at the original
                # address: the front door should re-route (the owner
                # that shed is exactly the member to avoid)
                target = (None, None, path)
                hops = 0
                continue
            raise ServiceError(
                status, obj.get("error", "error"), obj
            )

    # -- API -----------------------------------------------------------

    def check(
        self,
        history,
        model: Optional[str] = None,
        durable: bool = False,
        strict: Optional[bool] = None,
        deadline_s: Optional[float] = None,
        init_value: Any = None,
    ) -> dict:
        req: dict = {"history": encode_history(history)}
        if model is not None:
            req["model"] = model
        if durable:
            req["durable"] = True
        if strict is not None:
            req["strict"] = strict
        if deadline_s is not None:
            req["deadline_s"] = deadline_s
        if init_value is not None:
            req["init_value"] = init_value
        body = json.dumps(req).encode()
        return self._roundtrip("POST", "/check", body)

    def stream(
        self,
        stream_id: str,
        model: Optional[str] = None,
        init_value: Any = None,
        durable: bool = False,
        persist_every: Optional[int] = None,
        gc_window: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> "ClientStream":
        """Open a client-side streaming check. The returned
        ``ClientStream`` survives the sticky owner dying mid-stream:
        it re-resolves ownership through the front door and replays
        the stream from op 0 on the new owner (durable streams resume
        launch-free from their persisted frontier)."""
        return ClientStream(
            self, stream_id, model=model, init_value=init_value,
            durable=durable, persist_every=persist_every,
            gc_window=gc_window, deadline_s=deadline_s,
        )

    def stats(self) -> dict:
        return self._roundtrip("GET", "/stats")

    def health(self) -> dict:
        return self._roundtrip("GET", "/healthz")


class ClientStream:
    """One streaming check, fleet-failover-aware.

    Before this class, stream stickiness broke PERMANENTLY when the
    sticky member died mid-stream: the front door fails the next
    chunk over to the ring successor, which has never seen the
    stream — a mid-stream chunk lands COLD there and either errors or
    (worse) silently judges a history missing its prefix. The client
    is the only party holding the full op sequence, so recovery lives
    here: every appended chunk is buffered, and when an append's
    answer comes back from a DIFFERENT member than the sticky owner
    (or the append fails with a member-death-shaped error), the
    stream replays itself from op 0 at the new owner with
    ``restart=true`` on the first chunk (dropping any poisoned
    partial state server-side). A durable stream's replayed prefix
    hashes identically, so the new owner resumes from the persisted
    frontier instead of re-launching — the solo daemon-restart resume
    protocol, now riding fleet fail-over automatically."""

    def __init__(
        self,
        client: CheckerClient,
        stream_id: str,
        model: Optional[str] = None,
        init_value: Any = None,
        durable: bool = False,
        persist_every: Optional[int] = None,
        gc_window: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ):
        self.client = client
        self.stream_id = str(stream_id)
        self.model = model
        self.init_value = init_value
        self.durable = bool(durable)
        self.persist_every = persist_every
        self.gc_window = gc_window
        self.deadline_s = deadline_s
        #: wire-encoded chunks appended so far — the replay buffer
        self._sent: list = []
        #: the sticky member id (None until the first fleet answer,
        #: and always None against a solo daemon)
        self._member: Optional[int] = None
        #: replays performed (surfaced for tests/observability)
        self.replays = 0
        self._done = False

    def _payload(
        self, ops: list, final: bool, restart: bool = False
    ) -> bytes:
        req: dict = {
            "stream_id": self.stream_id, "ops": ops, "final": final,
        }
        if self.model is not None:
            req["model"] = self.model
        if self.init_value is not None:
            req["init_value"] = self.init_value
        if self.durable:
            req["durable"] = True
        if self.persist_every is not None:
            req["persist_every"] = self.persist_every
        if self.gc_window is not None:
            req["gc_window"] = self.gc_window
        if self.deadline_s is not None:
            req["deadline_s"] = self.deadline_s
        if restart:
            req["restart"] = True
        return json.dumps(req).encode()

    def append(self, chunk, final: bool = False) -> dict:
        """Append one chunk (History | list[Op] | list[dict]);
        returns the provisional status (non-final) or the definite
        verdict (final). Transparently replays through the door when
        the sticky owner is lost mid-stream."""
        if self._done:
            raise RuntimeError(
                f"stream {self.stream_id!r} already finished"
            )
        ops = encode_history(chunk)
        try:
            out = self.client._roundtrip(
                "POST", "/check/stream",
                self._payload(ops, final),
            )
        except (ServiceError, OSError) as e:
            retriable = (
                isinstance(e, OSError)
                or e.status in (500, 503)
            )
            if not (retriable and self._sent):
                raise
            # member-death-shaped failure mid-stream: re-resolve the
            # owner through the door and replay from op 0
            out = self._replay(ops, final)
        else:
            m = out.get("fleet_member")
            if self._member is None:
                self._member = m
            elif m != self._member:
                # the sticky owner died and the door failed this
                # chunk over: it landed COLD on the successor —
                # discard that answer and re-prime the new owner
                # with the whole stream
                out = self._replay(ops, final)
        self._sent.append(ops)
        if final:
            self._done = True
        return out

    def finish(self, chunk=()) -> dict:
        """Final append: returns the definite verdict."""
        return self.append(chunk, final=True)

    def _replay(self, ops: list, final: bool) -> dict:
        last_err: Optional[Exception] = None
        for _ in range(MAX_STREAM_REPLAYS):
            self.replays += 1
            try:
                out, members = self._replay_pass(ops, final)
            except (ServiceError, OSError) as e:
                last_err = e
                continue
            if len(members) > 1:
                # a member died DURING the replay: head and tail
                # landed on different owners — replay again
                continue
            self._member = members.pop() if members else None
            return out
        if last_err is not None:
            raise last_err
        raise ServiceError(
            503, "stream-replay-failed",
            {"detail": "fleet membership would not hold still"},
        )

    def _replay_pass(self, ops: list, final: bool) -> tuple:
        """One full replay: every buffered chunk then the current
        one, restart=true on the first so the new owner drops any
        poisoned partial stream before rebuilding. Returns (last
        response, set of serving member ids)."""
        chunks = list(self._sent) + [ops]
        members: set = set()
        out: dict = {}
        for i, chunk in enumerate(chunks):
            is_last = i == len(chunks) - 1
            out = self.client._roundtrip(
                "POST", "/check/stream",
                self._payload(
                    chunk, final and is_last, restart=(i == 0)
                ),
            )
            m = out.get("fleet_member")
            if m is not None:
                members.add(m)
        return out, members
