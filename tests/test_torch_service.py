"""The port's checker daemon (jepsen_tpu_torch.service) against the JAX
package's (jepsen_tpu.service), on the CPU.

Both daemons run in this process on ephemeral ports: the port's with
device="cpu", the reference's with interpret=True. Each request goes
to both as the SAME bytes, and the test compares what comes back:
verdicts normalized as tests/test_service.py's ``_strip`` does (method,
wall_s and the transport fields aside), HTTP statuses and error
reasons, tenant-ledger rows and audit-record fields. Every daemon is
torn down as tests/test_service.py's ``running_daemon`` does (drain,
shutdown, close, reset of the default plane and the resilience
ledger).

Departure pinned here: the port's daemon checks an unordered-queue
request through the per-value batch (LinearizableChecker.check), so
its verdict equals the reference's LinearizableChecker.check verdict;
the reference's daemon submits the joint stream instead (same
validity). The reference's compile cost (interpret mode, 10-20 s a
new shape) is paid once per shape: every register request here is a
100-op history at W=4. Tolerance: exact equality."""

import http.client
import json
import os
import random
import threading
import time
from contextlib import contextmanager

import pytest

from jepsen_tpu.checker import chaos as r_chaos
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker.linearizable import (
    LinearizableChecker as RLinearizableChecker,
)
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.service.audit import read_audit_log as r_read_audit
from jepsen_tpu.service.client import CheckerClient as RClient
from jepsen_tpu.service.server import CheckerDaemon as RDaemon
from jepsen_tpu.store import op_from_json as r_op_from_json

from jepsen_tpu_torch import device as t_dev
from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker import chaos as t_chaos
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.service.audit import read_audit_log
from jepsen_tpu_torch.service.client import (
    CheckerClient,
    ServiceError,
    encode_history,
)
from jepsen_tpu_torch.service.server import CheckerDaemon, _jsonable

pytestmark = pytest.mark.service

HOSTILE_OPS = [
    {"type": "invoke", "f": "read", "value": None, "process": 0,
     "index": 0},
    {"type": "ok", "f": "read", "value": 1, "process": 0, "index": 1},
    {"type": "ok", "f": "read", "value": 2, "process": 0, "index": 2},
]


def register(seed, n_ops=100):
    """tests/test_service.py's _register: clean same-shape histories
    (p_crash=0, fixed n_ops: one 64-bucket, so any two coalesce)."""
    return sim.gen_register_history(
        random.Random(seed), n_ops=n_ops, n_procs=4, p_crash=0.0
    )


def strip(out):
    """Verdict minus transport + per-run fields, normalized through the
    wire encoding (tests/test_service.py's _strip)."""
    out = json.loads(json.dumps(_jsonable(out)))
    return {
        k: v for k, v in out.items()
        if k not in ("method", "wall_s", "tenant", "check_id",
                     "checkpoint", "degraded", "race_winner")
    }


def body_of(ops, **req):
    return json.dumps({"history": encode_history(ops), **req}).encode()


def ref_history(ops):
    """The same ops as a reference History (through the wire JSON)."""
    return RHistory([r_op_from_json(d) for d in encode_history(ops)],
                    indexed=True)


def _serve(daemon):
    t = threading.Thread(target=daemon.serve_forever, daemon=True)
    t.start()
    return t


def _teardown(daemon, t, reset):
    daemon.admission.start_drain()
    daemon.httpd.shutdown()
    t.join(timeout=10)
    daemon.close()
    reset()


def _reset_port():
    t_dp.reset_default_plane()
    t_chaos.reset_resilience()


def _reset_ref():
    r_dp.reset_default_plane()
    r_chaos.reset_resilience()


@contextmanager
def port_daemon(tmp_path, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("root", str(tmp_path / "port-store"))
    d = CheckerDaemon(port=0, **kw)
    t = _serve(d)
    try:
        yield d
    finally:
        _teardown(d, t, _reset_port)


@contextmanager
def ref_daemon(tmp_path, **kw):
    kw.setdefault("interpret", True)
    kw.setdefault("root", str(tmp_path / "ref-store"))
    d = RDaemon(port=0, **kw)
    t = _serve(d)
    try:
        yield d
    finally:
        _teardown(d, t, _reset_ref)


@contextmanager
def both_daemons(tmp_path, **kw):
    with port_daemon(tmp_path, **kw) as p, ref_daemon(tmp_path, **kw) as r:
        yield p, r


def post(d, path, body, tenant="default", headers=None,
         content_length=True):
    """(status, decoded json) of one raw POST: the same bytes to
    either package's daemon."""
    conn = http.client.HTTPConnection("127.0.0.1", d.port, timeout=300)
    try:
        conn.putrequest("POST", path)
        conn.putheader("X-Tenant", tenant)
        conn.putheader("Content-Type", "application/json")
        if content_length:
            conn.putheader("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            conn.putheader(k, v)
        conn.endheaders()
        if content_length:
            conn.send(body)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, (json.loads(raw) if raw else {})
    finally:
        conn.close()


def get(d, path, tenant="default"):
    conn = http.client.HTTPConnection("127.0.0.1", d.port, timeout=60)
    try:
        conn.request("GET", path, headers={"X-Tenant": tenant})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def rows(d):
    """Ledger rows without the latency-derived field (a clock reading)."""
    return {t: {k: v for k, v in r.items() if k != "stream_p99_ms"}
            for t, r in d.ledger.snapshot().items()}


# -- roundtrip verdict parity --------------------------------------------


@pytest.mark.parametrize("case", ("valid", "invalid"))
def test_roundtrip_register_parity(tmp_path, case):
    """POST /check of a valid and an invalid cas-register history: the
    port's served verdict equals the reference daemon's and both
    checkers' local ones; the ledger rows equal."""
    h = register(101)
    if case == "invalid":
        h = sim.corrupt_history(register(103), random.Random(55))
    body = body_of(h, model="cas-register")
    with both_daemons(tmp_path) as (p, r):
        sp, outp = post(p, "/check", body, tenant="alice")
        sr, outr = post(r, "/check", body, tenant="alice")
        assert sp == sr == 200
        assert outp["tenant"] == "alice"
        assert outp["check_id"] == outr["check_id"]
        assert strip(outp) == strip(outr)
        assert outp["valid?"] is (case == "valid")
        assert rows(p) == rows(r)
        assert rows(p)["alice"]["valid" if case == "valid"
                                else "invalid"] == 1
    local = LinearizableChecker(device="cpu").check({}, h)
    assert strip(outp) == strip(local)


def test_roundtrip_queue_parity(tmp_path):
    """model unordered-queue: the port serves the per-value batch's
    verdict, equal to the reference's LinearizableChecker.check on the
    same history; the reference daemon (joint stream) agrees on
    validity."""
    h = sim.gen_queue_history(random.Random(7), n_ops=60, n_procs=3,
                              n_values=4, p_crash=0.0)
    bad = sim.overdraw_queue_history(h, 2)
    for hist, valid in ((h, True), (bad, False)):
        body = body_of(hist, model="unordered-queue")
        with both_daemons(tmp_path) as (p, r):
            sp, outp = post(p, "/check", body, tenant="q")
            sr, outr = post(r, "/check", body, tenant="q")
        assert sp == sr == 200
        assert outp["valid?"] is outr["valid?"] is valid
        assert outp["method"].startswith("per-value:")
        ref_local = RLinearizableChecker(
            "unordered-queue", interpret=True
        ).check({}, ref_history(hist))
        assert strip(outp) == strip(ref_local)


def test_roundtrip_txn_graph_parity(tmp_path):
    """model txn-graph: the plane's graph bucket on both daemons."""
    for anomaly in (None, "g1c"):
        h = sim.gen_txn_graph_history(random.Random(66), n_txns=60,
                                      anomaly=anomaly)
        body = body_of(h, model="txn-graph")
        with both_daemons(tmp_path) as (p, r):
            sp, outp = post(p, "/check", body, tenant="g")
            sr, outr = post(r, "/check", body, tenant="g")
            assert rows(p) == rows(r)
        assert sp == sr == 200
        assert outp["valid?"] is (anomaly is None)
        assert strip(outp) == strip(outr)


# -- HTTP statuses --------------------------------------------------------

_STATUS_CASES = {
    "bad-json": (dict(), "/check", b"{not json", {}, 400),
    "no-history": (dict(), "/check", b"{}", {}, 400),
    "history-not-list": (dict(), "/check", b'{"history": 3}', {}, 400),
    "stream-no-id": (dict(), "/check/stream", b'{"ops": []}', {}, 400),
    "not-found": (dict(), "/nope", b"{}", {}, 404),
    "no-length": (dict(), "/check", b"{}", {"content_length": False}, 411),
    "too-large": (dict(max_payload_bytes=64), "/check", b"x" * 128, {},
                  413),
    "hostile-strict": (dict(), "/check",
                       json.dumps({"history": HOSTILE_OPS,
                                   "strict": True}).encode(), {}, 422),
    "hostile-tenant-policy": (dict(strict_default=True), "/check",
                              json.dumps({"history": HOSTILE_OPS}).encode(),
                              {}, 422),
}


@pytest.mark.parametrize("case", sorted(_STATUS_CASES))
def test_status_parity(tmp_path, case):
    """Statuses, error reasons and ledger rows of requests refused
    before any check runs equal the reference daemon's; each request
    lands once in each audit log with the same fields."""
    kw, path, body, opts, want = _STATUS_CASES[case]
    with both_daemons(tmp_path, **kw) as (p, r):
        outs = [post(d, path, body, tenant="t1", **opts) for d in (p, r)]
        assert outs[0][0] == outs[1][0] == want
        assert outs[0][1].get("error") == outs[1][1].get("error")
        if want == 422:
            assert outs[0][1]["classes"] == outs[1][1]["classes"]
        assert rows(p) == rows(r)
        recs = [read_audit_log(p.audit.path), r_read_audit(r.audit.path)]
    for a, b in zip(*recs):
        for k in ("tenant", "path", "admission", "status", "launches"):
            assert a[k] == b[k], k
    assert len(recs[0]) == len(recs[1]) == 1


@pytest.mark.parametrize("gate", ("queue-full", "tenant-inflight-cap",
                                  "draining"))
def test_admission_gate_parity(tmp_path, gate):
    """429 past the global bound and the tenant cap, 503 while
    draining: held slots stand in for in-flight checks, so the gates
    are deterministic; the statuses and rows equal the reference's."""
    body = body_of(register(301))
    with both_daemons(tmp_path, max_inflight=2,
                      per_tenant_inflight=1) as (p, r):
        outs = []
        for d in (p, r):
            held = []
            if gate == "queue-full":
                held = [d.admission.admit("a"), d.admission.admit("b")]
            elif gate == "tenant-inflight-cap":
                held = [d.admission.admit("t1")]
            else:
                d.admission.start_drain()
            outs.append(post(d, "/check", body, tenant="t1"))
            for tok in held:
                tok.release()
        want = 503 if gate == "draining" else 429
        assert outs[0][0] == outs[1][0] == want
        assert outs[0][1]["error"] == outs[1][1]["error"] == gate
        assert rows(p) == rows(r)


def test_strict_policy_and_repair(tmp_path):
    """The default policy repairs a hostile history and checks it; a
    strict override refuses
    with 422 and the class census; a strict tenant policy refuses
    without the override (tests/test_service.py's case, on the port)."""
    with port_daemon(tmp_path) as d:
        c = CheckerClient(port=d.port, tenant="mallory", retries=0)
        out = c.check(HOSTILE_OPS)
        assert "valid?" in out
        assert d.ledger.snapshot()["mallory"]["repaired"] == 1
        with pytest.raises(ServiceError) as ei:
            c.check(HOSTILE_OPS, strict=True)
        assert ei.value.status == 422
        assert ei.value.reason == "hostile-history"
        assert ei.value.body["classes"]
        d.ledger.set_policy("mallory", strict=True)
        with pytest.raises(ServiceError) as ei:
            c.check(HOSTILE_OPS)
        assert ei.value.status == 422


def test_deadline_maps_to_504_and_releases_the_slot(tmp_path):
    with port_daemon(tmp_path) as d:
        c = CheckerClient(port=d.port, tenant="impatient", retries=0)
        with pytest.raises(ServiceError) as ei:
            c.check(register(303), deadline_s=1e-4)
        assert ei.value.status == 504
        assert ei.value.body["check_id"]
        assert d.ledger.snapshot()["impatient"]["deadline_timeouts"] == 1
        deadline = time.time() + 60
        while d.admission.snapshot()["inflight"] and time.time() < deadline:
            time.sleep(0.05)
        assert d.admission.snapshot()["inflight"] == 0


# -- cross-tenant coalescing ----------------------------------------------


def test_cross_tenant_coalescing_fewer_launches_than_requests(tmp_path):
    """Four tenants' same-shape checks, started together behind a
    barrier under a generous hold, meet in one bucket: fewer launches
    than requests, verdicts equal to the solo checks', every tenant's
    ledger row counted. The exact count (one) is the chip phase's."""
    tenants = ["t0", "t1", "t2", "t3"]
    hists = [register(201 + i) for i in range(len(tenants))]
    solo = [LinearizableChecker(device="cpu").check({}, h) for h in hists]
    with port_daemon(tmp_path, coalesce_hold_s=2.0) as d:
        t_dev.reset_launch_stats()
        outs = [None] * len(tenants)
        gate = threading.Barrier(len(tenants))

        def go(i):
            gate.wait()
            outs[i] = CheckerClient(port=d.port, tenant=tenants[i],
                                    retries=0).check(hists[i])

        ts = [threading.Thread(target=go, args=(i,))
              for i in range(len(tenants))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        launches = t_dev.launch_stats_snapshot()["launches"]
        assert 1 <= launches < len(tenants)
        assert [strip(o) for o in outs] == [strip(o) for o in solo]
        snap = d.ledger.snapshot()
        for t in tenants:
            assert snap[t]["completed"] == 1 and snap[t]["valid"] == 1


def _connects_within(port, n, timeout_s=0.25):
    """How many of n simultaneous connects complete within timeout_s
    while the server accepts none (each completed connect sits in the
    listen queue)."""
    import socket

    socks, ok = [], 0
    try:
        for _ in range(n):
            sk = socket.socket()
            sk.settimeout(timeout_s)
            socks.append(sk)
            try:
                sk.connect(("127.0.0.1", port))
                ok += 1
            except OSError:
                pass
    finally:
        for sk in socks:
            sk.close()
    return ok


def test_listen_backlog_admits_a_burst(tmp_path):
    """A repair: the reference's daemon listens with the stdlib's
    backlog of 5, so past about 5 simultaneous connects a client's SYN
    is dropped and retried a second later (its request then misses the
    coalescing hold). The port's daemon listens with its in-flight
    bound: 12 connects complete while no request is accepted yet."""
    p = CheckerDaemon(port=0, device="cpu", max_inflight=64,
                      root=str(tmp_path / "p"))
    r = RDaemon(port=0, interpret=True, root=str(tmp_path / "r"))
    try:
        assert p.httpd.request_queue_size == 64
        assert _connects_within(p.port, 12) == 12
        assert _connects_within(r.port, 12) < 12
    finally:
        for d in (p, r):
            d.close()
        _reset_port()
        _reset_ref()


# -- the audit log ----------------------------------------------------------


def test_audit_one_record_per_request_parity(tmp_path):
    """A 200, a 400, a 413 and a GET /stats on both daemons: one record
    each, in order, with equal tenant, path, admission and status; a
    check's record counts its launches, a refused one none."""
    ok = body_of(register(306))
    reqs = [("alice", ok, 200), ("bob", b"{not json", 400),
            ("mallory", b"x" * (128 << 10), 413)]
    recs = []
    with both_daemons(tmp_path, max_payload_bytes=64 << 10) as (p, r):
        for d in (p, r):
            for tenant, body, want in reqs:
                assert post(d, "/check", body, tenant=tenant)[0] == want
            assert get(d, "/stats")[0] == 200
        recs = [read_audit_log(p.audit.path), r_read_audit(r.audit.path)]
        assert os.path.dirname(p.audit.path).endswith(".service")
    assert len(recs[0]) == len(recs[1]) == 4
    for a, b in zip(*recs):
        assert set(a) == set(b)
        for k in ("tenant", "path", "admission", "status"):
            assert a[k] == b[k]
        assert (a["launches"] > 0) == (b["launches"] > 0)
    assert recs[0][0]["launches"] >= 1 and recs[0][0]["wall_s"] > 0


# -- the copied modules, unit by unit -------------------------------------


def test_reference_client_talks_to_the_port_daemon(tmp_path):
    """The wire format is one: the reference's CheckerClient (and its
    ClientStream) against the port's daemon."""
    with port_daemon(tmp_path) as d:
        c = RClient(port=d.port, tenant="ref-client", retries=0)
        h = ref_history(register(101))
        out = c.check(h, model="cas-register")
        assert out["valid?"] is True and out["tenant"] == "ref-client"
        s = c.stream("rs")
        s.append(list(h.ops)[:40])
        fin = s.finish(list(h.ops)[40:])
        assert fin["valid?"] is True and fin["stream_id"] == "rs"
        assert c.health()["ok"] is True
        assert c.stats()["tenants"]["ref-client"]["completed"] == 2


def test_admission_ladder_equals_the_reference():
    """tests/test_service.py's shedding-ladder unit, on both packages:
    the same refusals in the same order and the same ledger rows."""
    from jepsen_tpu.service.admission import (
        AdmissionControl as RAdmission,
        AdmissionError as RAdmissionError,
    )
    from jepsen_tpu.service.tenants import TenantLedger as RLedger

    from jepsen_tpu_torch.service.admission import (
        AdmissionControl,
        AdmissionError,
    )
    from jepsen_tpu_torch.service.tenants import TenantLedger

    got = []
    for ledger_cls, ctl_cls, err in ((TenantLedger, AdmissionControl,
                                      AdmissionError),
                                     (RLedger, RAdmission,
                                      RAdmissionError)):
        ledger = ledger_cls()
        ctl = ctl_cls(ledger, max_inflight=3, per_tenant_inflight=2,
                      max_payload_bytes=100)
        trail = []

        def attempt(fn, *a):
            try:
                tok = fn(*a)
                trail.append("ok")
                return tok
            except err as e:
                trail.append((e.status, e.reason))

        t1 = attempt(ctl.admit, "a")
        t2 = attempt(ctl.admit, "a")
        attempt(ctl.admit, "a")
        t3 = attempt(ctl.admit, "b")
        attempt(ctl.admit, "c")
        t3.release()
        t3.release()  # idempotent
        attempt(ctl.admit, "c").release()
        attempt(ctl.check_payload, "big", 101)
        attempt(ctl.check_payload, "big", None)
        ctl.start_drain()
        attempt(ctl.admit, "b")
        t1.release()
        t2.release()
        trail.append(ctl.wait_idle(1.0))
        snap = ctl.snapshot()
        got.append((trail, ledger.snapshot(), snap))
    assert got[0] == got[1]
    assert got[0][0][2] == (429, "tenant-inflight-cap")
    assert got[0][0][4] == (429, "queue-full")


def test_ledger_and_helpers_equal_the_reference():
    from jepsen_tpu.service import server as r_server
    from jepsen_tpu.service import tenants as r_tenants

    from jepsen_tpu_torch.service import server as t_server
    from jepsen_tpu_torch.service import tenants as t_tenants

    snaps = []
    for mod, chaos in ((t_tenants, t_chaos), (r_tenants, r_chaos)):
        chaos.reset_resilience()
        try:
            led = mod.TenantLedger(strict_default=True, quarantine_after=2)
            led.note("a", "accepted", 3)
            led.set_policy("b", strict=False)
            for ms in (5.0, 1.0, 9.0, 3.0):
                led.note_stream_latency("a", ms)
            led.note("a", "stream_chunks")
            led.observe_plane("c", "oracle_fallback")
            tripped = led.note_fault("c")
            snaps.append((led.snapshot(), tripped, led.quarantined("c"),
                          led.strict("a"), led.strict("b"),
                          led.strict("b", True), chaos.quarantined_tenants()))
        finally:
            chaos.reset_resilience()
    assert snaps[0] == snaps[1]
    assert snaps[0][1] is True and snaps[0][6] == ("c",)
    for xs in ([1.0], [3.0, 1.0, 2.0], list(range(100)), [0.1234567] * 7):
        assert t_tenants._percentile(xs, 0.99) == \
            r_tenants._percentile(xs, 0.99)
    body = body_of(register(5))
    for model in ("cas-register", "txn-graph"):
        assert t_server.check_id_for(model, body) == \
            r_server.check_id_for(model, body)
    import numpy as np

    weird = {"a": (1, 2), 3: {frozenset({2, 1})}, "n": np.int64(4),
             "f": np.float32(0.5), "arr": np.arange(3), "none": None,
             "o": RuntimeError("x")}
    assert t_server._jsonable(weird) == r_server._jsonable(weird)


@pytest.mark.parametrize("pkg", ("port", "ref"))
def test_signal_drain_routes_the_first_signal_and_escalates(pkg):
    """install_signal_drain: the first signal runs on_drain on a side
    thread; the second goes to the previous handler; restore()
    reinstates it (tests run the handler directly, on the main
    thread)."""
    import signal

    if pkg == "port":
        from jepsen_tpu_torch.service.drain import install_signal_drain
    else:
        from jepsen_tpu.service.drain import install_signal_drain
    seen, prev_calls = [], []

    def prev(signum, frame):
        prev_calls.append(signum)

    old = signal.signal(signal.SIGUSR1, prev)
    try:
        done = threading.Event()
        handle = install_signal_drain(
            lambda s: (seen.append(s), done.set()), (signal.SIGUSR1,))
        handler = signal.getsignal(signal.SIGUSR1)
        handler(signal.SIGUSR1, None)
        assert done.wait(5) and seen == [signal.SIGUSR1]
        assert handle.triggered.is_set()
        assert handle.signum == signal.SIGUSR1
        handler(signal.SIGUSR1, None)
        assert prev_calls == [signal.SIGUSR1]
        assert signal.getsignal(signal.SIGUSR1) is prev
    finally:
        signal.signal(signal.SIGUSR1, old)
