"""The port's flight recorder (jepsen_tpu_torch.obs) against the JAX
package's (jepsen_tpu.obs), on the CPU.

The counterparts of tests/test_obs.py's recorder, export and snapshot
cases: span/instant semantics, the disabled no-op singleton, ring
bounds and drops, per-thread rings, the kind mask, sampling, the
Chrome-trace golden and validator, engine_snapshot as the one reader
and reset_engine_stats. Then the spans at the plane crossings: on the
same histories the port's trace names the same events, of the same
kinds and as many of each, as the reference's (interpret=True, its
racer off, as the port's default is); its launch_stat instants sum to
LAUNCH_STATS; and the torch.profiler capture writes its trace on the
CPU. Tolerance: exact equality."""

import collections
import json
import random
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
        "dropped": 0, "sample_n": 1, "kinds": None, "sampled_out": 0,
        "by_kind": {},
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


def test_kind_mask_records_only_enabled_kinds():
    obs.enable(kinds=["dispatch"])
    obs.instant("keep", kind="dispatch")
    obs.instant("drop", kind="service")
    with obs.span("drop_too", kind="launch"):
        pass
    assert [e["name"] for e in obs.spans()] == ["keep"]
    st = obs.trace_stats()
    assert st["kinds"] == ["dispatch"]
    assert st["sampled_out"] == 0


def test_sampling_counts_thinned_emissions_in_ring_metadata():
    obs.enable(sample_n=4)
    for i in range(100):
        obs.instant("tick", kind="soak", i=i)
    st = obs.trace_stats()
    assert st["sample_n"] == 4
    assert st["events"] == 25 and st["sampled_out"] == 75
    obs_trace.reset()
    assert obs.trace_stats()["sampled_out"] == 0


def test_sampled_out_span_is_the_noop_singleton():
    obs.enable(kinds=["launch"], sample_n=2)
    spans = [obs.span("probe", kind="launch") for _ in range(4)]
    assert len([s for s in spans if s is obs_trace._NOOP]) == 2
    assert obs.span("masked", kind="service") is obs_trace._NOOP


def test_plain_enable_resets_to_full_fidelity():
    obs.enable(kinds=["dispatch"], sample_n=16)
    obs.enable()
    assert obs_trace.TRACER.kinds is None
    assert obs_trace.TRACER.sample_n == 1
    obs.instant("any", kind="whatever")
    assert len(obs.spans()) == 1


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
    # the reference lowers the same events to the same object
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
    assert _census(got[True]) == _census(got[False])
    kinds = {k for k, _, _ in _census(got[True])}
    assert {"dispatch", "collect", "launch_stat", "host_sync",
            "checkpoint", "streaming"} <= kinds
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
