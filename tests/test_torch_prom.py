"""The port's Prometheus exposition, /metrics, /trace and the audit log
against the JAX package's, on the CPU.

``jepsen_tpu_torch.obs.prom.prometheus_text`` is held byte-equal to
``jepsen_tpu.obs.prom.prometheus_text`` on the same snapshot, events
and tenant rows: the port daemon's live snapshot after real checks,
hostile tenant names (tests/test_service.py's label-escaping case),
quarantine lists and span histograms. The daemon's /metrics body
conforms to the text format and its tenant gauges reconcile with the
ledger; /trace leaves as a validated Chrome trace whose request span
and submit instants carry the tenant; each package's read_audit_log
reads the other's log, rotated and with a torn tail. Tolerance: exact
equality."""

import json
import os
import re
import time
import urllib.request

import pytest
from test_torch_service import get, port_daemon, post, register

from jepsen_tpu.obs.export import validate_chrome_trace as r_validate
from jepsen_tpu.obs.prom import prometheus_text as r_prom
from jepsen_tpu.obs.snapshot import engine_snapshot as r_engine_snapshot
from jepsen_tpu.obs.snapshot import reset_engine_stats as r_reset_engine_stats
from jepsen_tpu.service.audit import AuditLog as RAuditLog
from jepsen_tpu.service.audit import read_audit_log as r_read_audit

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.obs.export import validate_chrome_trace
from jepsen_tpu_torch.obs.prom import prometheus_text
from jepsen_tpu_torch.obs.snapshot import engine_snapshot
from jepsen_tpu_torch.obs.snapshot import (
    reset_engine_stats as t_reset_engine_stats,
)
from jepsen_tpu_torch.service.audit import AuditLog, read_audit_log
from jepsen_tpu_torch.service.client import CheckerClient, encode_history

pytestmark = pytest.mark.service

_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\"(,"
    r"[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")*\})? "
    r"(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|NaN)$"
)


def parse_exposition(body):
    """{(name, labels): value}, asserting every sample line conforms
    (tests/test_service.py's _parse_exposition)."""
    out = {}
    for ln in body.splitlines():
        if not ln or ln.startswith(("# HELP ", "# TYPE ")):
            continue
        m = _LINE.match(ln)
        assert m, f"non-conformant exposition line: {ln!r}"
        out[(m.group(1), m.group(2) or "")] = float(m.group(4))
    return out


_HOSTILE_TENANTS = {
    'evil"quote': {"completed": 1, "quarantined": True},
    "back\\slash": {"completed": 2, "quarantined": False},
    "new\nline": {"completed": 3, "strict": True},
    "团队-мир": {"completed": 4, "stream_p99_ms": 1.25},
}

_SNAPSHOTS = {
    "empty": ({}, [], None),
    "hostile-tenants": ({}, [], _HOSTILE_TENANTS),
    "quarantine": ({"resilience": {
        "retries": 2, "quarantined_devices": ["cuda:0", 'we"ird'],
        "quarantined_hosts": ["1"], "quarantined_tenants": ["x"],
        "device_failures": {"cuda:0": 3, "tenant:x": 5},
    }, "uptime_s": 12.5, "draining": False, "label": "text"}, [], None),
    "histograms": ({"launch": {"launches": 3}}, [
        {"ph": "X", "dur": 5e5, "kind": "launch", "name": "a"},
        {"ph": "X", "dur": 2e9, "kind": "collect", "name": "b"},
        {"ph": "X", "dur": 2e7, "kind": "launch", "name": "c"},
        {"ph": "i", "kind": "dispatch", "name": "d"},
        {"ph": "X", "dur": 1, "kind": "odd-kind!", "name": "e"},
    ], {"t": {"completed": 1}}),
}


@pytest.mark.parametrize("case", sorted(_SNAPSHOTS))
def test_prometheus_text_byte_equal_to_the_reference(case):
    snapshot, events, tenants = _SNAPSHOTS[case]
    got = prometheus_text(snapshot=snapshot, events=events, tenants=tenants)
    assert got == r_prom(snapshot=snapshot, events=events, tenants=tenants)
    parse_exposition(got)


def test_label_escaping_and_contiguous_families():
    body = prometheus_text(snapshot={}, events=[], tenants={
        k: {"completed": v["completed"]}
        for k, v in _HOSTILE_TENANTS.items()})
    vals = parse_exposition(body)
    name = "jepsen_tpu_tenant_completed"
    assert vals[(name, '{tenant="evil\\"quote"}')] == 1.0
    assert vals[(name, '{tenant="back\\\\slash"}')] == 2.0
    assert vals[(name, '{tenant="new\\nline"}')] == 3.0
    assert vals[(name, '{tenant="团队-мир"}')] == 4.0
    lines = body.splitlines()
    idxs = [i for i, ln in enumerate(lines) if ln.startswith(name + "{")]
    assert idxs == list(range(idxs[0], idxs[0] + 4))
    assert lines[idxs[0] - 1] == f"# TYPE {name} gauge"


def test_live_daemon_snapshot_renders_as_the_reference(tmp_path):
    """After real checks, the port's engine snapshot, trace events and
    ledger rows render byte-equal in both packages; /metrics conforms
    and every numeric ledger counter reappears as a labelled gauge."""
    obs.enable()
    try:
        with port_daemon(tmp_path) as d:
            for tenant, seed in (("alice", 301), ("alice", 302),
                                 ("bob", 303)):
                CheckerClient(port=d.port, tenant=tenant,
                              retries=0).check(register(seed))
            st, ctype, raw = get(d, "/metrics")
            snap, events = engine_snapshot(), obs.spans()
            tenants = d.ledger.snapshot()
    finally:
        obs.disable()
        obs_trace.TRACER.clear()
    assert st == 200 and ctype.startswith("text/plain")
    assert any(e.get("ph") == "X" for e in events)
    assert prometheus_text(snap, events, tenants) == r_prom(
        snap, events, tenants)
    vals = parse_exposition(raw.decode())
    assert ("jepsen_tpu_launch_launches", "") in vals
    assert ("jepsen_tpu_dispatch_requests", "") in vals
    assert any(n.startswith("jepsen_tpu_streaming_") for n, _ in vals)
    assert any(n.startswith("jepsen_tpu_txn_graph_") for n, _ in vals)
    assert tenants["alice"]["completed"] == 2
    for tenant, row in tenants.items():
        for counter, v in row.items():
            if isinstance(v, bool):
                v = 1.0 if v else 0.0
            elif not isinstance(v, (int, float)):
                continue
            key = (f"jepsen_tpu_tenant_{counter}",
                   f'{{tenant="{tenant}"}}')
            assert vals.get(key) == float(v), key


def _key_paths(obj, prefix=()):
    """Every key path of a nested dict, as tuples."""
    out = set()
    for k, v in obj.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _key_paths(v, prefix + (k,))
    return out


def _metric_names(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_snapshot_and_metric_names_equal_the_reference():
    """Both packages' live engine snapshots, read in one process, carry
    the same sections (``mesh`` among them) and, section by section, the
    same key paths; the live /metrics text names the same metrics, the
    ``jepsen_tpu_mesh_*`` series, ``jepsen_tpu_launch_donated_buffers``
    and ``jepsen_tpu_dispatch_launch_donated_buffers`` among them (0:
    PyTorch donates no buffers). Both start from reset counters, so the
    per-device and per-name rows that earlier checks leave do not
    count."""
    t_reset_engine_stats()
    r_reset_engine_stats()
    snap_t, snap_r = engine_snapshot(), r_engine_snapshot()
    assert set(snap_t) == set(snap_r)
    for section in snap_t:
        assert _key_paths(snap_t[section]) == _key_paths(
            snap_r[section]), section
    names_t = _metric_names(prometheus_text())
    names_r = _metric_names(r_prom())
    assert any(n.startswith("jepsen_tpu_mesh_") for n in names_t)
    assert names_t == names_r
    for name in ("jepsen_tpu_launch_donated_buffers",
                 "jepsen_tpu_dispatch_launch_donated_buffers"):
        assert name in names_t
    assert snap_t["launch"]["donated_buffers"] == 0
    assert snap_t["dispatch"]["launch"]["donated_buffers"] == 0


def test_trace_endpoint_drains_validated_chrome_json(tmp_path):
    """GET /trace: schema-valid in both packages' validators, the
    request span with its tenant, admission and status, the plane's
    submit instant with the tenant; a second GET is drained."""
    obs.enable()
    try:
        with port_daemon(tmp_path) as d:
            CheckerClient(port=d.port, tenant="alice",
                          retries=0).check(register(305))
            events = []
            for _ in range(100):
                st, ctype, raw = get(d, "/trace")
                assert st == 200 and ctype.startswith("application/json")
                obj = json.loads(raw)
                assert validate_chrome_trace(obj) == []
                assert r_validate(obj) == []
                events += obj["traceEvents"]
                if any(e["name"] == "request" for e in events):
                    break
                time.sleep(0.05)
            req = next(e for e in events if e["name"] == "request")
            assert req["args"]["tenant"] == "alice"
            assert req["args"]["admission"] == "admitted"
            assert req["args"]["status"] == 200
            sub = next(e for e in events if e["name"] == "submit")
            assert sub["args"]["tenant"] == "alice"
            chk = next(e for e in events if e["name"] == "check")
            assert chk["args"]["tenant"] == "alice"
            get(d, "/trace")
            obj2 = json.loads(get(d, "/trace")[2])
            assert not any(e["name"] == "request"
                           for e in obj2["traceEvents"])
    finally:
        obs.disable()
        obs_trace.TRACER.clear()


def test_trace_endpoint_disabled_recorder_serves_empty(tmp_path):
    with port_daemon(tmp_path) as d:
        obj = json.loads(get(d, "/trace")[2])
    assert obj["traceEvents"] == []
    assert obj["metadata"]["enabled"] is False


def test_metrics_under_concurrent_load(tmp_path):
    """/metrics stays conformant while checks are in flight."""
    import threading

    with port_daemon(tmp_path) as d:
        errs, bodies = [], []

        def scrape():
            try:
                for _ in range(5):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{d.port}/metrics",
                            timeout=10) as r:
                        assert r.status == 200
                        bodies.append(r.read().decode())
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        def work(seed):
            try:
                CheckerClient(port=d.port, tenant=f"t{seed}",
                              retries=0).check(register(seed))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=scrape) for _ in range(3)]
        ts += [threading.Thread(target=work, args=(400 + i,))
               for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    assert errs == [] and len(bodies) == 15
    for body in bodies:
        parse_exposition(body)


# -- the audit log, across packages --------------------------------------


@pytest.mark.parametrize("writer", ("port", "ref"))
def test_audit_rotation_and_torn_tail_read_by_both(tmp_path, writer):
    """One package writes five records with rotation after the fourth
    append's size; both packages' readers see the same records, and a
    torn trailing line is skipped by both."""
    mk = AuditLog if writer == "port" else RAuditLog
    probe = mk(str(tmp_path / "probe.jsonl"), fsync=False)
    rec = probe.record(tenant="t0", path="/check", admission="admitted",
                       status=200, wall_s=0.01, launches=1)
    probe.close()
    line_len = len(json.dumps(rec)) + 1
    path = str(tmp_path / "audit.jsonl")
    log = mk(path, max_bytes=int(3.5 * line_len), fsync=False)
    for i in range(5):
        log.record(tenant=f"t{i}", path="/check", admission="admitted",
                   status=200, wall_s=0.01, launches=1, extra=i)
    log.close()
    assert os.path.exists(path + ".1")
    for read in (read_audit_log, r_read_audit):
        both = read(path, include_rotated=True)
        assert [r["tenant"] for r in both] == ["t0", "t1", "t2", "t3", "t4"]
        assert [r["extra"] for r in both] == [0, 1, 2, 3, 4]
        assert [r["tenant"] for r in read(path)] == ["t4"]
    with open(path, "a") as f:
        f.write('{"tenant": "torn"')
    assert read_audit_log(path) == r_read_audit(path)
    assert [r["tenant"] for r in read_audit_log(path)] == ["t4"]


def test_daemon_audit_log_read_by_the_reference(tmp_path):
    """The port daemon's own log (one record per request, GETs
    included) reads the same through the reference's reader."""
    body = json.dumps({"history": encode_history(register(306))}).encode()
    with port_daemon(tmp_path) as d:
        assert post(d, "/check", body, tenant="alice")[0] == 200
        assert post(d, "/check", b"{bad", tenant="bob")[0] == 400
        assert get(d, "/healthz")[0] == 200
        path = d.audit.path
    recs = read_audit_log(path)
    assert recs == r_read_audit(path)
    assert [(r["tenant"], r["path"], r["status"]) for r in recs] == [
        ("alice", "/check", 200), ("bob", "/check", 400),
        ("default", "/healthz", 200)]
