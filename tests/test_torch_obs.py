"""The port's flight recorder (jepsen_tpu_torch.obs) against the JAX
package's (jepsen_tpu.obs), on the CPU.

The counterparts of tests/test_obs.py's recorder, export and snapshot
cases: span/instant semantics, the disabled no-op singleton, ring
bounds and drops, per-thread rings, the Chrome-trace golden and
validator, engine_snapshot as the one reader and reset_engine_stats.
Then the spans at the plane crossings: on the same histories the port's
trace names the same events, of the same kinds and as many of each, as
the reference's (interpret=True, its racer off, as the port's default
is), plus its own host-stage spans; its launch_stat instants sum to
LAUNCH_STATS. Then the port's own: the span tree of a keyed check (ids,
parents, self times), the off path that reads no clock, and the
torch.profiler mirror that puts each span into the profiler's trace;
and the torch.profiler capture writes its trace on the CPU. Tolerance:
exact equality."""

import collections
import itertools
import json
import random
import subprocess
import sys
import threading
import time

import pytest
import torch

from jepsen_tpu import obs as r_obs
from jepsen_tpu.obs.export import chrome_trace as r_chrome_trace

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.obs.export import chrome_trace, validate_chrome_trace


@pytest.fixture(autouse=True)
def _quiet_tracer():
    """Every test starts and ends with both recorders off and empty:
    each is process-wide state, like the stats planes."""
    for o in (obs, r_obs):
        o.disable()
        o.TRACER.clear()
    yield
    for o in (obs, r_obs):
        o.disable()
        o.TRACER.clear()


# -- span / instant semantics -----------------------------------------


def test_span_records_complete_event_with_set_attrs():
    obs.enable()
    with obs.span("check", kind="service", tenant="t0") as sp:
        sp.set(status=200)
    (ev,) = obs.spans()
    assert ev["name"] == "check" and ev["kind"] == "service"
    assert ev["ph"] == "X" and ev["dur"] >= 0
    assert ev["args"] == {"tenant": "t0", "status": 200}
    assert ev["tid"] == threading.get_ident()


def test_nested_spans_and_instants_order_by_start():
    obs.enable()
    with obs.span("outer"):
        obs.instant("mark", kind="launch_stat", n=1)
        with obs.span("inner"):
            pass
    assert [e["name"] for e in obs.spans()] == ["outer", "mark", "inner"]
    st = obs.trace_stats()
    assert st["spans"] == 2 and st["instants"] == 1
    assert st["by_kind"]["launch_stat"] == 1


def test_disabled_mode_is_noop_singleton():
    assert obs.span("a") is obs.span("b")
    assert obs.span("a").__enter__().set(x=1).__exit__() is False
    assert obs.instant("a", n=1) is None
    assert obs_trace.TRACER._rings == {}
    assert obs.trace_stats()["events"] == 0
    assert obs_trace._NoopSpan.__slots__ == ()


def test_disabled_mode_full_check_allocates_no_rings():
    """A full instrumented check through the plane with the tracer off
    never touches a ring."""
    from jepsen_tpu_torch.checker.events import history_to_events
    from jepsen_tpu_torch.checker.sharded import check_keys
    from jepsen_tpu_torch.sim import gen_register_history

    streams = [
        history_to_events(gen_register_history(
            random.Random(s), n_ops=16, n_procs=2))
        for s in range(3)
    ]
    assert len(check_keys(streams, device="cpu")) == 3
    assert obs_trace.TRACER._rings == {}
    assert obs.trace_stats() == {
        "enabled": False, "events": 0, "spans": 0, "instants": 0,
        "dropped": 0, "by_kind": {},
    }


def test_ring_bounds_memory_and_counts_drops():
    obs.enable(capacity=16)
    try:
        for i in range(100):
            obs.instant("tick", kind="soak", i=i)
        st = obs.trace_stats()
        assert st["events"] < 32
        assert st["dropped"] > 0
        assert st["events"] + st["dropped"] == 100
        assert obs.spans()[-1]["args"]["i"] == 99
    finally:
        obs_trace.TRACER.capacity = obs_trace.DEFAULT_CAPACITY


def test_per_thread_rings_stamp_tid_and_tname():
    obs.enable()

    def emit():
        obs.instant("from_worker", kind="test")

    t = threading.Thread(target=emit, name="worker-0")
    t.start()
    t.join()
    obs.instant("from_main", kind="test")
    by_name = {e["name"]: e for e in obs.spans()}
    assert by_name["from_worker"]["tname"] == "worker-0"
    assert by_name["from_worker"]["tid"] != by_name["from_main"]["tid"]


# -- export schema ----------------------------------------------------


def test_chrome_trace_schema_golden(tmp_path):
    obs.enable()
    with obs.span("launch", kind="launch"):
        obs.instant("launches", kind="launch_stat", n=1)
    events = obs.spans()
    obj = chrome_trace(events)
    assert validate_chrome_trace(obj) == []
    metas = [e for e in obj["traceEvents"] if e["ph"] == "M"]
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    inst = [e for e in obj["traceEvents"] if e["ph"] == "i"]
    assert len(metas) == 1 and metas[0]["name"] == "thread_name"
    assert len(xs) == 1 and xs[0]["cat"] == "launch"
    assert inst[0]["s"] == "t"
    assert min(e["ts"] for e in xs + inst) == 0.0
    # each event's id and cause ride in its args
    assert xs[0]["args"] == {"id": events[0]["id"], "parent": None}
    assert inst[0]["args"] == {"n": 1, "id": events[1]["id"],
                               "parent": events[0]["id"]}
    # past them, the reference lowers the same events to the same object
    for e in obj["traceEvents"]:
        e["args"].pop("id", None)
        e["args"].pop("parent", None)
    assert obj == r_chrome_trace(events)
    p = tmp_path / "t.json"
    obs.write_chrome_trace(str(p), events)
    assert validate_chrome_trace(json.loads(p.read_text())) == []
    q = tmp_path / "t.jsonl"
    assert obs.write_jsonl(str(q), events) == 2
    assert [json.loads(ln) for ln in q.read_text().splitlines()] == \
        json.loads(json.dumps(events))


def test_chrome_trace_validator_rejects_torn_events():
    bad = {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0},
        {"name": "y", "ph": "i", "pid": 1, "tid": 1, "ts": 0},
        {"name": "", "ph": "Q", "pid": 1, "tid": 1, "ts": 0},
    ]}
    errors = validate_chrome_trace(bad)
    assert len(errors) == 3
    assert errors == r_obs.validate_chrome_trace(bad)
    assert validate_chrome_trace({"events": []}) != []


# -- the consolidated snapshot ----------------------------------------


def test_engine_snapshot_is_the_one_reader():
    from jepsen_tpu.obs.snapshot import engine_snapshot as r_snapshot
    from jepsen_tpu_torch.obs.snapshot import engine_snapshot

    snap = engine_snapshot()
    # the reference's sections, mesh among them
    assert set(snap) == set(r_snapshot())
    assert set(snap) == {"dispatch", "launch", "mesh", "resilience",
                         "checkpoint", "streaming", "txn_graph", "trace",
                         "perf"}
    assert "launches" in snap["launch"]
    assert "enabled" in snap["trace"]
    assert isinstance(snap["txn_graph"], dict)


def test_reset_engine_stats_resets_every_plane():
    from jepsen_tpu_torch import device
    from jepsen_tpu_torch.checker import chaos, checkpoint, dispatch
    from jepsen_tpu_torch.checker import streaming, txn_graph
    from jepsen_tpu_torch.obs.snapshot import (
        engine_snapshot,
        reset_engine_stats,
    )

    obs.enable()
    device._bump_launch("launches")
    assert obs.trace_stats()["events"] == 1
    dispatch._bump("requests")
    chaos.note_device_failure("cuda:9", quarantine_after=1)
    checkpoint._bump("saves")
    streaming._bump("appends")
    txn_graph._note("device_graphs", 3)
    snap = engine_snapshot()
    assert snap["launch"]["launches"] >= 1
    assert snap["dispatch"]["requests"] >= 1
    assert snap["resilience"]["quarantined_devices"] == ["cuda:9"]
    assert snap["checkpoint"]["saves"] >= 1
    assert snap["streaming"]["appends"] >= 1
    assert snap["txn_graph"]["device_graphs"] >= 3
    reset_engine_stats()
    snap = engine_snapshot()
    assert snap["launch"]["launches"] == 0
    assert snap["dispatch"]["requests"] == 0
    assert snap["resilience"]["quarantined_devices"] == []
    assert snap["checkpoint"]["saves"] == 0
    assert snap["streaming"]["appends"] == 0
    assert snap["txn_graph"]["device_graphs"] == 0
    assert snap["trace"]["events"] == 0


# -- the spans at the plane crossings ---------------------------------


def _no_race(monkeypatch):
    """The reference's native racer off: the port races only when
    asked, and a racer's win skips the device's sync and launch."""
    from jepsen_tpu.checker import dispatch as r_dp
    from jepsen_tpu.checker import linearizable as r_lin

    monkeypatch.setattr(r_lin, "_race_eligible", lambda *a: False)
    monkeypatch.setattr(r_dp, "_race_eligible", lambda *a: False)


def _scenario(port: bool, tmp):
    """The same work in either package: a key batch through the
    default plane, four sequential checks (two of them corrupted, so
    escalated), a checkpointed check and a two-append stream."""
    if port:
        from jepsen_tpu_torch import sim
        from jepsen_tpu_torch.checker import events, sharded
        from jepsen_tpu_torch.checker.checkpoint import CheckpointSink
        from jepsen_tpu_torch.checker.linearizable import (
            LinearizableChecker,
        )

        checker = LinearizableChecker(device="cpu")
        keys = lambda s: sharded.check_keys(s, device="cpu")  # noqa: E731
    else:
        from jepsen_tpu import sim
        from jepsen_tpu.checker import events, sharded
        from jepsen_tpu.checker.checkpoint import CheckpointSink
        from jepsen_tpu.checker.linearizable import LinearizableChecker

        checker = LinearizableChecker(interpret=True)
        keys = lambda s: sharded.check_keys(  # noqa: E731
            s, mesh=False, interpret=True)
    hs = []
    for seed in range(4):
        rng = random.Random(seed)
        h = sim.gen_register_history(rng, n_ops=20, n_procs=3)
        hs.append(sim.corrupt_history(h, rng) if seed % 2 else h)
    keys([events.history_to_events(h) for h in hs])
    for h in hs:
        checker.check(None, h)
    checker.check(None, hs[0], checkpoint=CheckpointSink(
        str(tmp), seg_min_len=1))
    sc = checker.check_streaming()
    sc.append(hs[2].ops[:20])
    sc.append(hs[2].ops[20:])
    sc.result()


def _census(events):
    return collections.Counter(
        (e["kind"], e["name"], e["ph"]) for e in events)


def test_trace_names_the_reference_events_on_the_same_work(
        tmp_path, monkeypatch):
    from jepsen_tpu.obs.snapshot import reset_engine_stats as r_reset
    from jepsen_tpu_torch.device import launch_stats_snapshot
    from jepsen_tpu_torch.obs.snapshot import reset_engine_stats

    _no_race(monkeypatch)
    got = {}
    for port, o, reset in ((False, r_obs, r_reset),
                           (True, obs, reset_engine_stats)):
        _scenario(port, tmp_path / f"warm{port}")  # compile untraced
        reset()
        o.enable()
        _scenario(port, tmp_path / f"run{port}")
        o.disable()
        got[port] = o.spans()
    port, ref = _census(got[True]), _census(got[False])
    ref_kinds = {k for k, _, _ in ref}
    # exact on every kind the reference emits; the port's host-stage
    # spans (kind "host") are its one addition
    assert collections.Counter(
        {key: n for key, n in port.items() if key[0] in ref_kinds}) == ref
    assert {k for k, _, _ in port} - ref_kinds == {"host"}
    assert {"dispatch", "collect", "launch_stat", "host_sync",
            "checkpoint", "streaming"} <= ref_kinds
    # the trace's launch accounting is the engine's
    counted = collections.Counter()
    for e in got[True]:
        if e["kind"] == "launch_stat":
            counted[e["name"]] += e["args"]["n"]
    ls = launch_stats_snapshot()
    assert ls["launches"] > 0 and ls["host_syncs"] > 0
    assert {k: counted.get(k, 0) for k in ls} == ls


def test_prep_worker_spans_land_in_its_ring():
    from jepsen_tpu_torch.checker.dispatch import DispatchPlane
    from jepsen_tpu_torch.checker.events import history_to_events
    from jepsen_tpu_torch.sim import gen_register_history

    plane = DispatchPlane(device="cpu", async_prep=True)
    try:
        obs.enable()
        futs = [plane.submit(history_to_events(gen_register_history(
            random.Random(s), n_ops=16, n_procs=2))) for s in range(3)]
        # the worker preps and flushes the aged bucket on its own
        deadline = time.monotonic() + 30
        while any(f.launch is None for f in futs):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert all(f.result()["valid?"] is True for f in futs)
        obs.disable()
    finally:
        plane.close()
    by = collections.defaultdict(set)
    for e in obs.spans():
        by[e["name"]].add(e["tname"])
    assert by["submit"] == {threading.current_thread().name}
    assert by["dispatch_batch"] == by["dispatch"] == {"dispatch-plane-prep"}
    assert by["train_register"] == {"dispatch-plane-prep"}


def test_quarantine_and_retry_instants(monkeypatch):
    from jepsen_tpu_torch.checker import chaos

    obs.enable()
    for _ in range(3):
        chaos.note_device_failure("cuda:7", quarantine_after=3)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise chaos.InjectedCudaError("not ready", chaos.CUDA_NOT_READY,
                                          "cuda:0")
        return 5

    monkeypatch.setattr(chaos.RetryPolicy, "delay", lambda self, a: 0.0)
    assert chaos.resilient_call(flaky, site="launch",
                                devices=["cuda:0"]) == 5
    obs.disable()
    chaos.reset_resilience()
    ev = [(e["name"], e["kind"], e["args"]) for e in obs.spans()]
    assert ("quarantine", "chaos", {"device": "cuda:7"}) in ev
    assert [x for x in ev if x[0] == "retry"] == [
        ("retry", "chaos", {"site": "launch", "fault": "transient",
                            "attempt": 1})]


# -- the host stages of a keyed check ---------------------------------

#: the stages every key's linearizable.check holds on the bitset tier
STAGES = {"sentry", "history_to_events", "events_to_steps", "launch_prep",
          "host_sync", "verdict"}


def _keyed_ops(corrupt: bool, keys: int = 3, nemesis: bool = False):
    """A keyed register history: each key's ops one after another,
    key 1's corrupted on request, and on request a nemesis's start and
    stop before each key's."""
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.independent import KV

    ops = []
    for k in range(keys):
        if nemesis:
            ops += [{"type": t, "f": "start", "value": None,
                     "process": "nemesis"} for t in ("invoke", "info")]
        h = sim.gen_register_history(random.Random(k), n_ops=20, n_procs=3)
        if corrupt and k == 1:
            h = sim.corrupt_history(h, random.Random(k))
        for o in h.to_dicts():
            o = dict(o, value=KV(k, o.get("value")))
            o.pop("index", None)
            ops.append(o)
    return ops


def _keyed_check(ops) -> dict:
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.independent import IndependentChecker

    return IndependentChecker(LinearizableChecker(device="cpu")).check(
        {}, list(ops))


def _traced_keyed_check(corrupt: bool, nemesis: bool = False):
    ops = _keyed_ops(corrupt, nemesis=nemesis)
    _keyed_check(ops)  # warm: compile nothing in the traced run
    obs.enable()
    out = _keyed_check(ops)
    obs.disable()
    return ops, out, obs.spans()


def _children(events):
    kids = collections.defaultdict(list)
    for e in events:
        kids[e["parent"]].append(e)
    return kids


@pytest.mark.parametrize("corrupt", [False, True])
def test_keyed_check_records_the_stage_tree(corrupt):
    ops, out, events = _traced_keyed_check(corrupt)
    assert out["valid?"] is (not corrupt)
    kids = _children(events)
    (root,) = kids[None]
    assert root["name"] == "independent.check" and root["kind"] == "host"
    assert root["args"] == {"keys": 3, "n_ops": len(ops)}
    top = [e["name"] for e in kids[root["id"]]]
    assert top == ["independent.split"] + ["independent.key"] * 3
    valid = []
    for key in kids[root["id"]][1:]:
        (lin,) = kids[key["id"]]
        assert lin["name"] == "linearizable.check"
        assert key["args"]["n_ops"] == 40
        stages = {e["name"] for e in kids[lin["id"]] if e["ph"] == "X"}
        assert stages == STAGES
        assert lin["args"]["method"] == "gpu-wgl-bitset"
        valid.append(lin["args"]["valid"])
    assert valid == [True, not corrupt, True]
    (prep,) = [e for e in events if e["name"] == "launch_prep"][:1]
    assert prep["args"] == {"segments": 1, "padded_steps": 64}


@pytest.mark.parametrize("nemesis", [False, True])
def test_split_counts_the_ops_it_builds(nemesis):
    """The split builds one Op per KV-valued entry, and none for the
    nemesis's entries, which the root's n_ops still counts."""
    from jepsen_tpu_torch.independent import KV

    ops, out, events = _traced_keyed_check(False, nemesis=nemesis)
    assert out["valid?"] is True
    (root,) = [e for e in events if e["name"] == "independent.check"]
    (split,) = [e for e in events if e["name"] == "independent.split"]
    kvs = sum(isinstance(o["value"], KV) for o in ops)
    assert split["args"] == {"ops_built": kvs} and kvs == 120
    assert root["args"]["n_ops"] == len(ops) == kvs + 6 * nemesis


def test_ids_are_unique_and_parents_contain_their_children():
    _, _, events = _traced_keyed_check(corrupt=True)
    by_id = {e["id"]: e for e in events}
    assert len(by_id) == len(events)
    for e in events:
        if e["parent"] is None:
            continue
        p = by_id[e["parent"]]
        assert p["ph"] == "X" and p["tid"] == e["tid"]
        end = e["ts"] + e.get("dur", 0)
        assert p["ts"] <= e["ts"] and end <= p["ts"] + p["dur"]


def test_self_times_under_each_root_sum_to_its_duration():
    _, _, events = _traced_keyed_check(corrupt=True)
    spans = [e for e in events if e["ph"] == "X"]
    kids = _children(spans)
    self_ns = {e["id"]: e["dur"] - sum(c["dur"] for c in kids[e["id"]])
               for e in spans}
    assert min(self_ns.values()) >= 0

    def subtree(e):
        return self_ns[e["id"]] + sum(subtree(c) for c in kids[e["id"]])

    (root,) = kids[None]
    assert subtree(root) == root["dur"]


def test_launch_stat_instants_name_their_stage():
    _, _, events = _traced_keyed_check(corrupt=True)
    by_id = {e["id"]: e for e in events}
    seen = collections.Counter(
        (e["name"], by_id[e["parent"]]["name"]) for e in events
        if e["kind"] == "launch_stat")
    # a key's launch is counted in its launch preparation; its syncs,
    # and the exact re-run of the corrupted key, in the check around
    assert seen == {("launches", "launch_prep"): 3,
                    ("host_syncs", "linearizable.check"): 4,
                    ("launches", "linearizable.check"): 1,
                    ("escalations", "linearizable.check"): 1}


def test_recorder_off_keyed_check_reads_no_clock_and_makes_no_ring(
        monkeypatch):
    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("the off path read the clock")

    monkeypatch.setattr(obs_trace, "time", NoClock())
    monkeypatch.setattr(obs_trace, "_ids", itertools.count(7))
    assert _keyed_check(_keyed_ops(corrupt=True))["valid?"] is False
    assert obs_trace.TRACER._rings == {}
    assert next(obs_trace._ids) == 7


def test_recorder_on_without_a_profiler_touches_no_torch(monkeypatch):
    def no_annotation(*a, **kw):
        raise AssertionError("an annotation with no capture running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_annotation)
    obs.enable()
    assert _keyed_check(_keyed_ops(corrupt=False))["valid?"] is True
    assert any(e["name"] == "linearizable.check" for e in obs.spans())
    # and a process that never imported torch does not import it
    code = ("import sys\n"
            "from jepsen_tpu_torch.obs import trace\n"
            "trace.enable()\n"
            "with trace.span('outer', kind='host'):\n"
            "    trace.instant('tick')\n"
            "assert len(trace.spans()) == 2\n"
            "assert 'torch' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)


def test_traced_decorator_spans_each_call():
    @obs_trace.traced("stage")
    def stage(x, y=1):
        return x + y

    assert stage(1) == 2 and obs.spans() == []
    obs.enable()
    with obs.span("outer", kind="host"):
        assert stage(2, y=3) == 5
    outer, inner = obs.spans()
    assert (inner["name"], inner["kind"]) == ("stage", "host")
    assert inner["parent"] == outer["id"] and stage.__name__ == "stage"


def _profiled_keyed_check(tmp_path, record: bool):
    ops = _keyed_ops(corrupt=True)
    _keyed_check(ops)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        if record:
            obs.enable()
        _keyed_check(ops)
        obs.disable()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    names = {"independent.check", "independent.split", "independent.key",
             "linearizable.check"} | STAGES
    notes = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"] in names]
    return sorted(notes, key=lambda e: (e["ts"], -e["dur"]))


def test_profiler_capture_holds_each_span_once_as_an_annotation(
        tmp_path):
    notes = _profiled_keyed_check(tmp_path, record=True)
    spans = [e for e in obs.spans() if e["ph"] == "X"]
    assert [e["name"] for e in notes] == [e["name"] for e in spans]
    note_of = {e["id"]: n for e, n in zip(spans, notes)}
    for e in spans:
        if e["parent"] is None:
            continue
        n, p = note_of[e["id"]], note_of[e["parent"]]
        assert p["ts"] <= n["ts"]
        assert n["ts"] + n["dur"] <= p["ts"] + p["dur"]


def test_profiler_capture_without_the_recorder_holds_no_span(tmp_path):
    assert _profiled_keyed_check(tmp_path, record=False) == []
    assert obs.spans() == []


def test_cli_analyze_puts_the_spans_into_the_device_trace(tmp_path):
    from jepsen_tpu_torch import cli, sim
    from jepsen_tpu_torch import store as t_store
    from jepsen_tpu_torch.obs.profiler import PROFILE_FILE

    root = str(tmp_path / "store")
    h = sim.gen_register_history(random.Random(5), n_ops=30, n_procs=3)
    t_store.Store(root).save_1({"name": "spans", "history": h})
    trace, prof = tmp_path / "t.json", tmp_path / "prof"
    assert cli.main(["analyze", "spans", "--store", root, "--backend",
                     "cpu", "--trace", str(trace), "--xla-trace",
                     str(prof)]) == cli.EXIT_VALID
    events = json.loads((prof / PROFILE_FILE).read_text())["traceEvents"]
    notes = collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation")
    recorded = collections.Counter(
        e["name"] for e in json.loads(trace.read_text())["traceEvents"]
        if e.get("cat") == "host")
    assert recorded["linearizable.check"] == 1
    assert {n: notes[n] for n in recorded} == recorded


# -- the torch.profiler capture ---------------------------------------


def test_profiler_capture_writes_a_trace_on_the_cpu(tmp_path):
    from jepsen_tpu_torch.obs.profiler import PROFILE_FILE, xla_trace

    with xla_trace(str(tmp_path / "prof"), device="cpu"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    obj = json.loads((tmp_path / "prof" / PROFILE_FILE).read_text())
    assert isinstance(obj["traceEvents"], list) and obj["traceEvents"]


class _DeadProfiler:
    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        raise RuntimeError("profiler unavailable")


def test_profiler_that_cannot_start_is_a_noop_only_on_the_cpu(
        tmp_path, monkeypatch):
    from jepsen_tpu_torch.obs import profiler

    monkeypatch.setattr(torch.profiler, "profile", _DeadProfiler)
    ran = []
    with profiler.xla_trace(str(tmp_path / "cpu"), device="cpu"):
        ran.append(1)
    assert ran == [1]
    assert not (tmp_path / "cpu" / profiler.PROFILE_FILE).exists()
    # on the card the same failure raises: no quiet run without a
    # device timeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiler.xla_trace(str(tmp_path / "card")):
            ran.append(2)
    assert ran == [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiler.xla_trace(str(tmp_path / "none")):
            pass
