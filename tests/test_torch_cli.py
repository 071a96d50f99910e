"""The port's CLI (jepsen_tpu_torch.cli) against the JAX package's
(jepsen_tpu.cli), on the CPU.

For each of the ten WORKLOADS, a run recorded by the reference's
`test` command is copied twice; the reference's `analyze` (--devices 1,
JEPSEN_TPU_INTERPRET=1, its native racer off, as the port's default is)
checks one copy and the port's `analyze --backend cpu` the other. The
exit codes, results.json minus wall_s (methods mapped tpu-* -> gpu-*)
and engine_stats["launch"] must be equal; on an invalid register run
linear.svg must be byte-equal. Then the command surface: the strict
history gate, a clean engine slate per command, usage errors, --follow
on a growing history, --trace with trace-summary, and --stats-json.
Tolerance: exact equality."""

import json
import os
import random
import shutil
import threading
import time

import pytest
import torch

from jepsen_tpu import cli as r_cli
from jepsen_tpu import sim as r_sim
from jepsen_tpu import store as r_store
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import linearizable as r_lin
from jepsen_tpu.checker import sharded as r_sharded
from jepsen_tpu.checker import wgl_bitset as r_bs

from jepsen_tpu_torch import cli
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import store as t_store
from jepsen_tpu_torch.checker import sharded as t_sharded
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.device import launch_stats_snapshot
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History as THistory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_reference_mesh_policy(monkeypatch):
    """The reference's `analyze --devices 1` pins its process-wide mesh
    policy (sharded._MESH_POLICY) and never unpins it, and so does the
    port's `analyze --backend cpu` (its own sharded._MESH_POLICY):
    restore both packages' keys after each test, so a later test in
    this worker still sees the ambient mesh of either."""
    for pol in (r_sharded._MESH_POLICY, t_sharded._MESH_POLICY):
        for k in ("devices", "backend"):
            monkeypatch.setitem(pol, k, pol[k])


@pytest.fixture
def ref_env(monkeypatch):
    """The reference's CLI as the port's runs: interpret mode (its CPU
    check takes the bitset tier, as the port's does), racer off."""
    monkeypatch.setenv("JEPSEN_TPU_INTERPRET", "1")
    monkeypatch.setattr(r_lin, "_race_eligible", lambda *a: False)
    monkeypatch.setattr(r_dp, "_race_eligible", lambda *a: False)


def ref_analyze(run_dir, root, *extra):
    return r_cli.main(["analyze", run_dir, "--store", root,
                       "--devices", "1", *extra])


def port_analyze(run_dir, root, *extra):
    return cli.main(["analyze", run_dir, "--store", root,
                     "--backend", "cpu", *extra])


def normalized(res):
    """results.json minus wall_s (every level), methods mapped."""
    if isinstance(res, dict):
        out = {}
        for k, v in res.items():
            if k == "wall_s":
                continue
            if k == "method" and isinstance(v, str):
                v = v.replace("tpu-", "gpu-")
            out[k] = normalized(v)
        return out
    if isinstance(res, list):
        return [normalized(x) for x in res]
    return res


def two_copies(run_dir):
    a, b = run_dir + ".ref", run_dir + ".port"
    for d in (a, b):
        shutil.copytree(run_dir, d)
        if os.path.exists(os.path.join(d, "results.json")):
            os.unlink(os.path.join(d, "results.json"))
    return a, b


def both_analyze(run_dir, root, *extra):
    """(ref exit, port exit, ref results, port results) on two copies."""
    a, b = two_copies(run_dir)
    rc_r = ref_analyze(a, root, "--workload", *extra)
    rc_t = port_analyze(b, root, "--workload", *extra)
    return (rc_r, rc_t, r_store.Store(root).load_results(a),
            t_store.Store(root).load_results(b), a, b)


@pytest.mark.parametrize("workload", r_cli.WORKLOADS)
def test_analyze_equals_the_reference_on_every_workload(
        tmp_path, ref_env, workload):
    assert cli.WORKLOADS == r_cli.WORKLOADS
    root = str(tmp_path / "store")
    extra = ["--concurrency", "4"] if workload == "g2" else []
    assert r_cli.main(["test", "--workload", workload, "--ops", "40",
                       "--store", root, "--name", workload,
                       "--seed", "3"] + extra) == 0
    run = r_store.Store(root).latest(workload)
    rc_r, rc_t, res_r, res_t, _, _ = both_analyze(run, root, workload)
    assert rc_t == rc_r == cli._exit_code(res_t)
    es_r, es_t = res_r.pop("engine_stats"), res_t.pop("engine_stats")
    assert normalized(res_t) == normalized(res_r)
    launch_r = dict(es_r["launch"])
    if workload == "txn-graph":
        # the port's TxnGraphChecker resolves its buckets from the last
        # submitted launch, so one wait covers the train (ROADMAP
        # queue 3): fewer host syncs, never more
        assert es_t["launch"]["host_syncs"] <= launch_r["host_syncs"]
        launch_r["host_syncs"] = es_t["launch"]["host_syncs"]
    assert es_t["launch"] == launch_r
    assert set(es_t) == set(es_r)
    assert set(es_t["perf"]) == set(es_r["perf"])


def test_invalid_register_run_writes_the_reference_svg(tmp_path, ref_env):
    from jepsen_tpu.history.history import History as RHistory

    root = str(tmp_path / "store")
    rng = random.Random(701)
    h = r_sim.corrupt_history(r_sim.gen_register_history(
        rng, n_ops=30, n_procs=3, p_crash=0.05), random.Random(701))
    test = {"name": "reg-bad", "workload": "register",
            "history": RHistory(h.ops)}
    run = r_store.Store(root).save_1(test)
    rc_r, rc_t, res_r, res_t, a, b = both_analyze(run, root, "register")
    assert rc_r == rc_t == cli.EXIT_INVALID
    res_r.pop("engine_stats"), res_t.pop("engine_stats")
    # each names the svg in its own run dir
    assert os.path.relpath(res_r.pop("failure_svg"), a) == "linear.svg"
    assert res_t.pop("failure_svg") == os.path.join(b, "linear.svg")
    assert normalized(res_t) == normalized(res_r)
    with open(os.path.join(a, "linear.svg"), "rb") as f1, \
            open(os.path.join(b, "linear.svg"), "rb") as f2:
        assert f2.read() == f1.read()


def hostile_run(root):
    h = THistory([
        t_ops.invoke_op(0, "write", 1), t_ops.ok_op(0, "write", 1),
        t_ops.invoke_op(0, "read"), t_ops.ok_op(0, "read", 1),
        # a completion with no invocation: sentry-hostile, checkable
        t_ops.ok_op(9, "read", 5),
    ])
    return t_store.Store(root).save_1({"name": "hostile", "history": h})


def test_strict_history_exit_code_contract(tmp_path, ref_env):
    root = str(tmp_path / "store")
    run = hostile_run(root)
    a, b = two_copies(run)
    assert ref_analyze(a, root, "--strict-history") == \
        port_analyze(b, root, "--strict-history") == cli.EXIT_HOSTILE_HISTORY
    assert t_store.Store(root).load_results(b) is None
    assert len({cli._epitaph(c) for c in (1, 2, 3)}) == 3
    assert [cli._epitaph(c) for c in (0, 1, 2, 3)] == \
        [r_cli._epitaph(c) for c in (0, 1, 2, 3)]
    # without the flag the same run repairs, verdicts and reports
    assert ref_analyze(a, root) == port_analyze(b, root) == cli.EXIT_VALID
    res_r = r_store.Store(root).load_results(a)
    res_t = t_store.Store(root).load_results(b)
    assert res_t["valid?"] is True
    assert res_t["history_report"]["clean"] is False
    assert res_t["history_report"] == res_r["history_report"]


def test_commands_start_with_clean_engine_slate(tmp_path):
    from jepsen_tpu_torch import device
    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker.checkpoint import CHECKPOINT_STATS

    root = str(tmp_path / "store")
    st = t_store.Store(root)
    test = {"name": "slate", "history": THistory([
        t_ops.invoke_op(0, "write", 1), t_ops.ok_op(0, "write", 1)])}
    st.save_1(test)
    for _ in range(3):
        chaos.note_device_failure("cuda:9", quarantine_after=3)
    assert "cuda:9" in chaos.quarantined_devices()
    with device._launch_stats_lock:
        device.LAUNCH_STATS["launches"] = 999
    CHECKPOINT_STATS["saves"] = 777
    assert port_analyze("slate", root) == cli.EXIT_VALID
    assert "cuda:9" not in chaos.quarantined_devices()
    res = st.load_results(test["run_dir"])
    assert res["engine_stats"]["launch"]["launches"] == 1
    assert res["engine_stats"]["checkpoint"]["saves"] == 0
    assert port_analyze("slate", root) == cli.EXIT_VALID
    assert st.load_results(test["run_dir"])["engine_stats"] == \
        res["engine_stats"]


def test_undrained_train_is_collected_before_the_reset(tmp_path):
    """A train an earlier in-process command left on the default plane
    is waited for (its futures resolve), and its sync does not count in
    the next command's stats."""
    from jepsen_tpu_torch.checker import dispatch
    from jepsen_tpu_torch.checker.events import history_to_events
    from jepsen_tpu_torch.sim import gen_register_history

    plane = dispatch.default_plane("cpu")
    fut = plane.submit(history_to_events(gen_register_history(
        random.Random(4), n_ops=16, n_procs=2)))
    plane.flush()
    assert fut.launch is not None and not fut.launch.resolved
    root = str(tmp_path / "store")
    st = t_store.Store(root)
    test = {"name": "after", "history": THistory([
        t_ops.invoke_op(0, "write", 1), t_ops.ok_op(0, "write", 1)])}
    st.save_1(test)
    assert port_analyze("after", root) == cli.EXIT_VALID
    assert fut.done() and fut.result()["valid?"] is True
    launch = st.load_results(test["run_dir"])["engine_stats"]["launch"]
    assert launch == {"launches": 1, "escalations": 0, "host_syncs": 1,
                      "donated_buffers": 0}


@pytest.mark.parametrize("argv", [
    ["frobnicate"], ["test", "--workload", "register"], ["serve"],
    ["lint", "--frobnicate"], ["analyze", "x", "--devices", "all"],
    ["analyze", "x", "--backend", "tpu"], ["trace-summary"],
])
def test_usage_errors_exit_255(argv):
    assert cli.main(argv) == cli.EXIT_USAGE


# -- --devices and --pod-* --------------------------------------------------


def test_devices_caps_the_mesh_as_the_reference(tmp_path, ref_env,
                                                monkeypatch):
    """`analyze --devices 4` on a txn-graph run: the reference caps its
    8-device CPU mesh, the port its 8 virtual slots (the local-slot
    seam), both shard the graph buckets over 4; exit codes, results and
    the mesh engagement are equal. The autouse fixture restores both
    packages' mesh policies afterwards."""
    monkeypatch.setenv(t_sharded.ENV_LOCAL_DEVICES, "8")
    root = str(tmp_path / "store")
    assert r_cli.main(["test", "--workload", "txn-graph", "--ops", "40",
                       "--store", root, "--name", "g", "--seed", "3"]) == 0
    a, b = two_copies(r_store.Store(root).latest("g"))
    rc_r = r_cli.main(["analyze", a, "--store", root, "--workload",
                       "txn-graph", "--devices", "4"])
    rc_t = port_analyze(b, root, "--workload", "txn-graph",
                        "--devices", "4")
    assert t_sharded.mesh_policy() == {"devices": 4, "backend": "cpu"}
    res_r = r_store.Store(root).load_results(a)
    res_t = t_store.Store(root).load_results(b)
    assert rc_t == rc_r == cli._exit_code(res_t)
    mesh_r = res_r.pop("engine_stats")["mesh"]
    mesh_t = res_t.pop("engine_stats")["mesh"]
    assert normalized(res_t) == normalized(res_r)
    assert mesh_t["last_n_devices"] == mesh_r["last_n_devices"] == 4
    assert mesh_t["sharded_launches"] == mesh_r["sharded_launches"] > 0


def _pod_member(args, env):
    import subprocess
    import sys

    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pod_analyze(root, runs, *extra, timeout=120):
    """`analyze` in a 2-process pod joined by --pod-* flags, member i
    on runs[i], each with 2 virtual slots: [(exit, stderr)]."""
    from jepsen_tpu_torch.pod import launcher

    port = launcher.free_port()
    procs = []
    for i, run in enumerate(runs):
        env = launcher.member_env()
        env[t_sharded.ENV_LOCAL_DEVICES] = "2"
        procs.append(_pod_member(
            ["analyze", run, "--store", root, "--backend", "cpu",
             "--workload", "txn-graph",
             "--pod-coordinator", f"127.0.0.1:{port}",
             "--pod-processes", "2", "--pod-index", str(i), *extra],
            env))
    try:
        return [(p.wait(timeout=timeout), p.communicate()[1])
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_pod_flags_join_a_two_process_pod(tmp_path):
    """`analyze --pod-coordinator --pod-processes 2 --pod-index i` in
    two processes: both join one gloo pod, shard the txn graph over its
    2 x 2 slots and exit with the single-process verdict; results.json
    records the pod's two hosts."""
    root = str(tmp_path / "store")
    assert r_cli.main(["test", "--workload", "txn-graph", "--ops", "40",
                       "--store", root, "--name", "g", "--seed", "3"]) == 0
    run = r_store.Store(root).latest("g")
    solo, m0 = two_copies(run)
    m1 = run + ".m1"
    shutil.copytree(m0, m1)
    rc_solo = port_analyze(solo, root, "--workload", "txn-graph")
    got = _pod_analyze(root, [m0, m1])
    for rc, err in got:
        assert rc == rc_solo, err[-2000:]
    want = normalized(t_store.Store(root).load_results(solo))
    want.pop("engine_stats")
    for d in (m0, m1):
        res = t_store.Store(root).load_results(d)
        mesh = res.pop("engine_stats")["mesh"]
        assert normalized(res) == want
        assert mesh["topology"]["n_hosts"] == 2
        assert mesh["last_n_devices"] == 4


def test_trace_inside_a_pod_merges_every_member(tmp_path):
    """`analyze --trace` in a 2-process gloo pod: both members exit with
    the single-process verdict, process 0 writes ONE merged trace that
    validates, holds both members (a process_name row and events each)
    and the handshake's skew bound, and each member's span-kind census
    equals a single-process `analyze --trace` of the same run."""
    from collections import Counter

    from jepsen_tpu_torch.obs import podtrace

    root = str(tmp_path / "store")
    assert r_cli.main(["test", "--workload", "txn-graph", "--ops", "40",
                       "--store", root, "--name", "g", "--seed", "3"]) == 0
    run = r_store.Store(root).latest("g")
    solo, m0 = two_copies(run)
    m1 = run + ".m1"
    shutil.copytree(m0, m1)
    solo_trace = str(tmp_path / "solo.json")
    rc_solo = port_analyze(solo, root, "--workload", "txn-graph",
                           "--trace", solo_trace)
    merged_path = str(tmp_path / "pod" / "merged.json")
    got = _pod_analyze(root, [m0, m1], "--trace", merged_path, timeout=90)
    for rc, err in got:
        assert rc == rc_solo, err[-2000:]
    trace_dir = os.path.dirname(merged_path)
    assert sorted(os.listdir(trace_dir)) == [
        "member-000.trace.json", "member-001.trace.json", "merged.json"]
    with open(merged_path) as f:
        merged = json.load(f)
    assert obs.validate_chrome_trace(merged) == []
    evs = merged["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {1: "pod-member-0", 2: "pod-member-1"}
    meta = merged["metadata"]
    assert meta["schema"] == podtrace.SCHEMA_VERSION
    skews = []
    for i, m in enumerate(meta["members"]):
        clock = podtrace.load_member_trace(
            podtrace.member_trace_path(trace_dir, i))["clock"]
        assert m["process_index"] == i
        assert m["offset_ns"] == clock["offset_ns"]
        skews.append(clock["skew_bound_ns"])
    assert meta["clock_skew_bound_ns"] == max(skews) > 0
    with open(solo_trace) as f:
        want = Counter(e["cat"] for e in json.load(f)["traceEvents"]
                       if e["ph"] != "M")
    assert want
    for pid in (1, 2):
        census = Counter(e["cat"] for e in evs
                         if e["ph"] != "M" and e["pid"] == pid)
        assert census == want
    assert cli.main(["trace-summary", merged_path, "--by-process"]) == 0


def test_trace_in_a_pod_reads_no_member_file_of_an_earlier_run(tmp_path):
    """An earlier 3-process pod left member-001 and member-002 in the
    trace dir: this 2-process pod's merge holds this run's two members
    only (the barrier orders every member's write before process 0's
    read), and member-001 on disk is this run's, with member 0's
    handshake anchors."""
    from jepsen_tpu_torch.obs import podtrace

    root = str(tmp_path / "store")
    assert r_cli.main(["test", "--workload", "txn-graph", "--ops", "40",
                       "--store", root, "--name", "g", "--seed", "3"]) == 0
    run = r_store.Store(root).latest("g")
    m0, m1 = run + ".m0", run + ".m1"
    shutil.copytree(run, m0)
    shutil.copytree(run, m1)
    trace_dir = str(tmp_path / "pod")
    stale = [{"name": "stale-span", "kind": "stale", "ph": "X",
              "ts": 1_000, "dur": 10, "tid": 1, "tname": "t1",
              "args": {}}]
    for i in (1, 2):
        podtrace.persist_member_trace(
            trace_dir, process_index=i, n_hosts=3, events=stale,
            clock={"anchor_ns": 1, "offset_ns": 0, "skew_bound_ns": 1,
                   "anchors_ns": [1, 2, 3]})
    merged_path = os.path.join(trace_dir, "merged.json")
    got = _pod_analyze(root, [m0, m1], "--trace", merged_path, timeout=90)
    for rc, err in got:
        assert rc == 0, err[-2000:]
    with open(merged_path) as f:
        merged = json.load(f)
    assert obs.validate_chrome_trace(merged) == []
    evs = merged["traceEvents"]
    assert {e["pid"] for e in evs} == {1, 2}
    assert not [e for e in evs if e["name"] == "stale-span"]
    assert [m["process_index"] for m in merged["metadata"]["members"]] == [
        0, 1]
    clocks = [podtrace.load_member_trace(
        podtrace.member_trace_path(trace_dir, i))["clock"] for i in (0, 1)]
    assert clocks[0]["anchors_ns"] == clocks[1]["anchors_ns"] != [1, 2, 3]


# -- --follow -------------------------------------------------------------


@pytest.fixture
def small_w(monkeypatch):
    """Narrow W buckets in both packages (the reference tests' seam),
    so burst histories segment at W4/W5."""
    monkeypatch.setattr(r_bs, "W_BUCKETS", (4, 5) + r_bs.W_BUCKETS)
    monkeypatch.setattr(t_bs, "W_BUCKETS", (4, 5) + t_bs.W_BUCKETS)


def burst_ops(ops, rounds=2, pairs=30, bad_tail=False, nburst=5):
    """tests/test_checkpoint.py's burst_history, as a package's ops."""
    out = []
    for _ in range(rounds):
        for i in range(pairs):
            out.append(ops.invoke_op(0, "write", i % 3))
            out.append(ops.ok_op(0, "write", i % 3))
        for p in range(nburst):
            out.append(ops.invoke_op(p, "write", p % 3))
        for p in range(nburst):
            out.append(ops.ok_op(p, "write", p % 3))
    if bad_tail:
        out.append(ops.invoke_op(0, "read"))
        out.append(ops.ok_op(0, "read", 7))
    return out


@pytest.mark.parametrize("bad", [False, True], ids=["valid", "invalid"])
def test_follow_tails_a_growing_history(tmp_path, small_w, bad):
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.checker.streaming import stream_stats

    ops = burst_ops(t_ops, rounds=2, bad_tail=bad)
    root = str(tmp_path / "store")
    st = t_store.Store(root)
    test = {"name": "follow", "workload": "register",
            "history": THistory(ops[:40])}
    d = st.save_1(test)
    hist = os.path.join(d, "history.jsonl")

    def writer():
        # the rest in chunks, the last line of each chunk torn first
        for i in range(40, len(ops), 25):
            time.sleep(0.3)
            lines = [json.dumps(t_store.op_to_json(o))
                     for o in ops[i:i + 25]]
            text = "\n".join(lines) + "\n"
            with open(hist, "a") as f:
                f.write(text[:-7])
                f.flush()
                time.sleep(0.05)
                f.write(text[-7:])

    t = threading.Thread(target=writer)
    t.start()
    try:
        rc = port_analyze(d, root, "--workload", "register", "--follow",
                          "--follow-idle", "3")
    finally:
        t.join()
    want = LinearizableChecker(device="cpu").check(None, THistory(ops))
    # the followed verdict is the one-shot verdict
    assert rc == cli._exit_code(want)
    assert rc == (cli.EXIT_INVALID if bad else cli.EXIT_VALID)
    assert stream_stats()["appends"] >= 2  # it really followed
    assert st.load_results(d) is None  # a follow writes no results.json


def test_follow_rejects_other_workloads(tmp_path):
    root = str(tmp_path / "store")
    st = t_store.Store(root)
    d = st.save_1({"name": "f2", "workload": "bank",
                   "history": THistory(burst_ops(t_ops, rounds=1))})
    assert port_analyze(d, root, "--workload", "bank", "--follow") == \
        cli.EXIT_USAGE


# -- --trace, trace-summary, --stats-json ---------------------------------


def test_analyze_trace_and_summary(tmp_path, capsys):
    root = str(tmp_path / "store")
    st = t_store.Store(root)
    from jepsen_tpu_torch.sim import corrupt_history, gen_register_history

    rng = random.Random(7)
    h = corrupt_history(gen_register_history(rng, n_ops=40, n_procs=3),
                        rng)
    d = st.save_1({"name": "obs-run", "history": h})
    trace_path = str(tmp_path / "trace.json")
    stats_path = str(tmp_path / "stats.json")
    code = port_analyze("obs-run", root, "--workload", "register",
                        "--trace", trace_path, "--stats-json", stats_path)
    assert code in (cli.EXIT_VALID, cli.EXIT_INVALID)
    obj = json.loads(open(trace_path).read())
    assert obs.validate_chrome_trace(obj) == []
    ls = launch_stats_snapshot()
    counted = {}
    for e in obj["traceEvents"]:
        if e.get("cat") == "launch_stat":
            counted[e["name"]] = counted.get(e["name"], 0) + e["args"]["n"]
    assert counted.get("launches", 0) == ls["launches"] > 0
    assert counted.get("host_syncs", 0) == ls["host_syncs"] > 0
    res = st.load_results(d)
    assert res["engine_stats"]["launch"] == ls
    assert {k: counted.get(k, 0) for k in ls} == ls
    assert not obs.TRACER.enabled
    bundle = json.loads(open(stats_path).read())
    assert bundle["launch"] == ls
    assert bundle["trace"]["enabled"] is True
    capsys.readouterr()
    assert cli.main(["trace-summary", trace_path]) == cli.EXIT_VALID
    out = capsys.readouterr().out
    assert "wall" in out and "launch_stat" in out and "host_sync" in out
    assert cli.main(["trace-summary", trace_path, "--by-process"]) == \
        cli.EXIT_VALID
    out = capsys.readouterr().out
    assert "1 process(es)" in out


def test_trace_summary_equals_the_reference_on_one_file(tmp_path, capsys):
    """Both packages' trace-summary read one file to the same table."""
    p = tmp_path / "t.json"
    obs.enable()
    with obs.span("dispatch", kind="dispatch"):
        obs.instant("dispatch_batch", kind="dispatch", riders=3)
        obs.instant("train_register", kind="dispatch", inflight=1)
        obs.instant("launches", kind="launch_stat", n=1)
    obs.disable()
    obs.write_chrome_trace(str(p), obs.spans())
    obs.TRACER.clear()
    outs = []
    for main in (r_cli.main, cli.main):
        for extra in ([], ["--by-process"]):
            capsys.readouterr()
            assert main(["trace-summary", str(p), *extra]) == 0
            outs.append(capsys.readouterr().out)
    assert outs[2:] == outs[:2]
    assert "floor_amortization    3.000" in outs[2]


def test_trace_summary_rejects_bad_schema(tmp_path, capsys):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"traceEvents": [{"ph": "Z"}]}))
    assert cli.main(["trace-summary", str(p)]) == cli.EXIT_UNKNOWN
    assert "schema" in capsys.readouterr().out


def test_stats_json_to_stdout(tmp_path, capsys):
    root = str(tmp_path / "store")
    t_store.Store(root).save_1({"name": "s", "history": THistory([
        t_ops.invoke_op(0, "write", 1), t_ops.ok_op(0, "write", 1)])})
    capsys.readouterr()
    assert port_analyze("s", root, "--stats-json", "-") == cli.EXIT_VALID
    out = capsys.readouterr().out
    bundle = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert bundle["launch"] == {"launches": 1, "escalations": 0,
                                "host_syncs": 1, "donated_buffers": 0}
    assert bundle["trace"]["enabled"] is False
