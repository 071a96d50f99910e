"""The port's pod trace merge (jepsen_tpu_torch.obs.podtrace) against the
JAX package's (jepsen_tpu.obs.podtrace), on synthetic members.

The same member rings and clock records go through both packages'
persist and merge: the merged JSON must be equal, and so must every
member file. Then the corner cases: persist/load round-trip, a wrong
schema refused, a missing member timing the merge out loudly (no
partial merge written), an earlier run's member files neither read nor
merged, a member without a clock merged unaligned, a
live ring persisted from the tracer, and launch_pod(trace_dir=)
setting the env seam in every member. Tolerance: exact equality."""

import json
import os
import random

import numpy as np
import pytest

from jepsen_tpu.obs import podtrace as r_podtrace

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.obs import podtrace


def _member_events(rng, base_ns, n=6, tids=(1, 2)):
    """A synthetic member ring in the recorder's raw form: spans and
    instants on a few threads, ns timestamps, seeded."""
    out = []
    ts = base_ns
    for i in range(n):
        tid = tids[i % len(tids)]
        ts += int(rng.integers(1_000, 2_000_000))
        if i % 3 == 2:
            out.append({"name": "launches", "kind": "launch_stat",
                        "ph": "i", "ts": ts, "tid": tid,
                        "tname": f"t{tid}", "args": {"n": 1}})
        else:
            out.append({"name": f"span{i}", "kind": "dispatch",
                        "ph": "X", "ts": ts,
                        "dur": int(rng.integers(100, 5_000_000)),
                        "tid": tid, "tname": f"t{tid}",
                        "args": {"i": i}})
    return out


def _members(seed, n_members=3):
    rng = np.random.default_rng(seed)
    out = []
    for pidx in range(n_members):
        offset = 0 if pidx == 0 else int(rng.integers(-3_000_000,
                                                      3_000_000))
        out.append({
            "process_index": pidx,
            "n_hosts": n_members,
            "events": _member_events(rng, 10_000_000 + offset),
            "clock": {"anchor_ns": 5_000 + offset, "offset_ns": offset,
                      "skew_bound_ns": int(rng.integers(1_000, 90_000))},
        })
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_equals_the_reference(tmp_path, seed):
    """The same members through both packages: every member file and
    the merged trace are equal, in memory and on disk."""
    d_ref, d_port = tmp_path / "ref", tmp_path / "port"
    members = _members(seed)
    random.Random(seed).shuffle(members)  # persist order is irrelevant
    for m in members:
        a = r_podtrace.persist_member_trace(str(d_ref), **m)
        b = podtrace.persist_member_trace(str(d_port), **m)
        assert os.path.basename(a) == os.path.basename(b)
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)
    want = r_podtrace.merge_pod_trace(str(d_ref), str(d_ref / "m.json"),
                                      expect_members=3)
    got = podtrace.merge_pod_trace(str(d_port), str(d_port / "m.json"),
                                   expect_members=3)
    assert got == want
    assert obs.validate_chrome_trace(got) == []
    with open(d_port / "m.json") as f:
        assert json.load(f) == got
    assert got["metadata"]["clock_skew_bound_ns"] == max(
        m["clock"]["skew_bound_ns"] for m in members)


def test_merge_rebases_onto_member0_clock(tmp_path):
    """Member 1's clock reads 1 ms ahead: the same instant lands at the
    same merged ts, one process row per member, the worst skew bound
    disclosed."""
    rng = np.random.default_rng(7)
    ev = _member_events(rng, 1_000_000, n=1)
    podtrace.persist_member_trace(
        str(tmp_path), process_index=0, n_hosts=2, events=ev,
        clock={"offset_ns": 0, "skew_bound_ns": 20_000})
    shifted = [dict(e, ts=e["ts"] + 1_000_000) for e in ev]
    podtrace.persist_member_trace(
        str(tmp_path), process_index=1, n_hosts=2, events=shifted,
        clock={"offset_ns": 1_000_000, "skew_bound_ns": 40_000})
    merged = podtrace.merge_pod_trace(str(tmp_path), expect_members=2)
    names = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {1: "pod-member-0", 2: "pod-member-1"}
    spans = {e["pid"]: e["ts"] for e in merged["traceEvents"]
             if e["ph"] == "X"}
    assert spans[1] == spans[2] == 0.0
    assert merged["metadata"]["clock_skew_bound_ns"] == 40_000


def test_persist_load_round_trip(tmp_path):
    m = _members(3, n_members=2)[1]
    path = podtrace.persist_member_trace(str(tmp_path), **m)
    assert path == podtrace.member_trace_path(str(tmp_path), 1)
    assert path.endswith("member-001.trace.json")
    obj = podtrace.load_member_trace(path)
    assert obj == {"schema": podtrace.SCHEMA_VERSION, **m}
    assert podtrace.SCHEMA_VERSION == r_podtrace.SCHEMA_VERSION
    assert podtrace.ENV_TRACE_DIR == r_podtrace.ENV_TRACE_DIR


@pytest.mark.parametrize("body", [
    {"schema": 999, "events": []},
    {"schema": podtrace.SCHEMA_VERSION},
    [1, 2],
], ids=["wrong-schema", "no-events", "not-a-dict"])
def test_load_rejects_a_foreign_file(tmp_path, body):
    p = tmp_path / "member-000.trace.json"
    p.write_text(json.dumps(body))
    with pytest.raises(ValueError) as port_err:
        podtrace.load_member_trace(str(p))
    with pytest.raises(ValueError) as ref_err:
        r_podtrace.load_member_trace(str(p))
    assert str(port_err.value) == str(ref_err.value)


def test_missing_member_times_out_loudly(tmp_path):
    """One of two members persisted: the merge raises naming the count
    and writes nothing (no partial merge)."""
    m = _members(4, n_members=2)[0]
    podtrace.persist_member_trace(str(tmp_path), **m)
    out = tmp_path / "merged.json"
    with pytest.raises(RuntimeError, match="expected 2 member traces"):
        podtrace.merge_pod_trace(str(tmp_path), str(out),
                                 expect_members=2, timeout_s=0.2)
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no member traces"):
        podtrace.merge_pod_trace(str(tmp_path / "empty"))


def _run_members(seed, n_members, anchors_ns):
    """Members of one pod run: their clocks carry the handshake's
    anchors, as init_pod records them."""
    out = _members(seed, n_members)
    for m in out:
        m["clock"]["anchors_ns"] = list(anchors_ns)
    return out


def test_merge_reads_only_the_expected_members(tmp_path):
    """A larger earlier pod left member-002 in the directory: a merge
    that expects 2 members reads members 0 and 1 only."""
    for m in _run_members(8, 3, [1, 2, 3]):
        podtrace.persist_member_trace(str(tmp_path), **m)
    now = _run_members(9, 2, [7, 8])
    for m in now:
        podtrace.persist_member_trace(str(tmp_path), **m)
    got = podtrace.merge_pod_trace(str(tmp_path), expect_members=2)
    assert obs.validate_chrome_trace(got) == []
    assert [m["process_index"] for m in got["metadata"]["members"]] == [
        0, 1]
    assert {e["pid"] for e in got["traceEvents"]} == {1, 2}
    assert got["metadata"]["clock_skew_bound_ns"] == max(
        m["clock"]["skew_bound_ns"] for m in now)


def test_merge_refuses_a_member_of_another_run(tmp_path):
    """member-001 is an earlier run's (other handshake anchors): the
    merge raises and writes nothing."""
    old = _run_members(10, 2, [1, 2])
    new = _run_members(11, 2, [5, 6])
    podtrace.persist_member_trace(str(tmp_path), **new[0])
    podtrace.persist_member_trace(str(tmp_path), **old[1])
    out = tmp_path / "merged.json"
    with pytest.raises(RuntimeError, match="come from 2 pod runs"):
        podtrace.merge_pod_trace(str(tmp_path), str(out),
                                 expect_members=2, timeout_s=0.2)
    assert not out.exists()


def test_merge_without_a_clock_runs_unaligned(tmp_path):
    """A member whose handshake could not run (clock None) merges
    unaligned (offset 0, no skew), as the reference's does."""
    rng = np.random.default_rng(5)
    p = tmp_path / "member-000.trace.json"
    p.write_text(json.dumps({
        "schema": podtrace.SCHEMA_VERSION, "process_index": 0,
        "n_hosts": 1, "clock": None,
        "events": _member_events(rng, 5_000)}))
    got = podtrace.merge_pod_trace(str(tmp_path))
    assert obs.validate_chrome_trace(got) == []
    assert got["metadata"]["members"][0]["offset_ns"] == 0
    assert got["metadata"]["clock_skew_bound_ns"] == 0
    assert got == r_podtrace.merge_pod_trace(str(tmp_path))


def test_persist_defaults_read_the_live_ring_and_topology(tmp_path):
    """Off-pod, the defaults are process 0 of 1 with no clock, and the
    events are the tracer's ring."""
    obs.reset()
    obs.enable()
    try:
        with obs.span("unit", kind="corpus", n=1):
            pass
        obs.instant("tick", kind="corpus")
        path = podtrace.persist_member_trace(str(tmp_path))
    finally:
        obs.disable()
    obj = podtrace.load_member_trace(path)
    assert (obj["process_index"], obj["n_hosts"], obj["clock"]) == (
        0, 1, None)
    assert [e["name"] for e in obj["events"]] == ["unit", "tick"]
    for e in obj["events"]:
        assert {"ts", "tid", "tname", "kind", "ph", "args"} <= set(e)
    obs.reset()


def test_launch_pod_sets_the_trace_dir_seam(tmp_path):
    """launch_pod(trace_dir=) puts JEPSEN_TPU_TRACE_DIR in every
    member's env (and leaves it out without trace_dir)."""
    from jepsen_tpu_torch.pod import launcher

    script = ("import os, json; print(json.dumps(os.environ.get("
              f"{podtrace.ENV_TRACE_DIR!r})))\n")
    got = launcher.launch_pod(2, script, n_local_devices=1,
                              timeout_s=60, trace_dir=str(tmp_path))
    for p in got:
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1]) == str(
            tmp_path)
    got = launcher.launch_pod(2, script, n_local_devices=1, timeout_s=60)
    for p in got:
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1]) is None
