"""The port's suites (jepsen_tpu_torch.suites) against the JAX
package's, on the CPU.

Every case of tests/test_suites.py, test_simple_suites.py,
test_hazelcast.py and test_more_suites.py runs against both packages,
as one test parametrised by package (the file's source loaded once per
package; the port's suite test maps take device="cpu"), and so does
tests/test_queue_device.py's composed queue checker case.

Then checker differentials: for etcd, zookeeper, consul, mongodb,
tidb's register workload, hazelcast's lock, queue and map register,
rabbitmq and simple's raftis (dummy mode), the port's runtime records
one seeded history of the suite's own test map. The history is written
as JSON lines and checked twice: by the reference suite's checker map
(its linearizability checkers on the bitset tier in interpret mode,
mesh=False, no native racer) and by the port's map at device="cpu".
The verdicts must agree on valid?, each key's failed_op_index, the
failed_value and the total-queue counts, for the valid history and for
a corrupted copy (a register's first ok read given a value never
written, a queue's first ok dequeue a value never enqueued, a mutex's
first release taken out).

Last, the entry points: `python -m jepsen_tpu_torch.suites.etcd
--dummy --backend cpu` and `suites.simple --suite raftis --dummy
--backend cpu` exit 0 and print valid?=True, and every suite's main
exits 254 without a card (and without --backend cpu) before any worker
starts, writing no run directory. Tolerance: exact."""

import importlib
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu.store import Store as RStore
from jepsen_tpu import suites as r_suites

from jepsen_tpu_torch import suites as t_suites
from jepsen_tpu_torch.runtime import run as t_run
from jepsen_tpu_torch.store import Store as TStore

from test_torch_generator import PKGS, load_cases, restored_run_logs
from test_torch_protocols import CPU_SUBS, expand_cases, run_local_case

# the checker package's __init__ re-exports a function of this name
r_lin = importlib.import_module("jepsen_tpu.checker.linearizable")

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

SUITE_FILES = ("test_suites.py", "test_simple_suites.py",
               "test_hazelcast.py", "test_more_suites.py",
               "test_cockroach.py", "test_divergence.py")
#: checker cases another port test already holds on both packages:
#: the monotonic, dirty-read, strong-dirty-read and multiversion ones
#: (test_torch_divergence.py) and the schedule ones
#: (test_torch_perf_graphs.py's HOST_CASES)
HELD_ELSEWHERE = {
    "test_cockroach.py": ("test_monotonic_checker_valid",
                          "test_monotonic_checker_catches_order_and_loss",
                          "test_monotonic_checker_unknown_without_read"),
    "test_divergence.py": ("test_dirty_reads_checker_clean_and_filthy",
                           "test_strong_dirty_read_checker",
                           "test_multiversion_checker",
                           "test_job_targets_cutoff",
                           "test_job_solution_matching",
                           "test_schedule_checker_unknown_without_read"),
}
SUITE_SUBS = CPU_SUBS + [
    ("make_test(suite, {", 'make_test(suite, {"device": "cpu", '),
    # the port names its methods for the card (tpu-* -> gpu-*)
    ('"tpu-wgl"', '"gpu-wgl"'),
]
SUITE_CASES = {
    pkg: {f: load_cases(TESTS / f, pkg, subs=SUITE_SUBS)
          for f in SUITE_FILES}
    for pkg in PKGS
}
CASES = [(f, *c) for f in SUITE_FILES
         for c in expand_cases(SUITE_CASES["jepsen_tpu"][f])
         if c[1] not in HELD_ELSEWHERE.get(f, ())]

#: every suite of the JAX package
PORTED = ("aerospike", "chronos", "cockroachdb", "consul", "crate",
          "dgraph", "elasticsearch", "etcd", "faunadb", "galera",
          "hazelcast", "mongodb", "percona", "rabbitmq", "simple", "tidb",
          "yugabyte", "zookeeper")
MAINS = ("aerospike", "chronos", "cockroachdb", "crate", "dgraph",
         "elasticsearch", "etcd", "faunadb", "galera", "hazelcast",
         "mongodb", "percona", "rabbitmq", "simple", "yugabyte")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one intra-op thread keeps
    torch's pool from oversubscribing the cores under parallel workers
    (a queue check's plain kernel-B scan took 100x longer without it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_run_logs():
    with restored_run_logs():
        yield


def test_the_cases_load_each_package():
    assert len(CASES) == 86
    for pkg, mods in SUITE_CASES.items():
        assert mods["test_suites.py"].etcd.__name__ == f"{pkg}.suites.etcd"
        assert mods["test_more_suites.py"].simple.__name__ == \
            f"{pkg}.suites.simple"
    assert tuple(t_suites.__all__) == PORTED


@pytest.mark.parametrize("f,cid,name,params", CASES,
                         ids=[f"{f[5:-3]}::{cid}" for f, cid, _, _ in CASES])
@pytest.mark.parametrize("pkg", PKGS)
def test_suite_case(pkg, f, cid, name, params, request):
    run_local_case(SUITE_CASES[pkg][f], name, params, request)


@pytest.mark.parametrize("pkg", PKGS)
def test_queue_suite_composed_checker(pkg):
    """tests/test_queue_device.py's case of the same name: the
    hazelcast queue workload checks conservation and by-value
    linearizability end to end."""
    run = importlib.import_module(f"{pkg}.runtime").run
    hz = importlib.import_module(f"{pkg}.suites.hazelcast")
    opts = {
        "dummy": True,
        "workload": "queue",
        "ops": 120,
        "nodes": ["n1", "n2", "n3"],
        "rng": random.Random(4),
    }
    if pkg == "jepsen_tpu_torch":
        opts["device"] = "cpu"
    t = hz.hazelcast_test(opts)
    t["concurrency"] = 4
    r = run(t)["results"]
    assert r["valid?"] is True, r
    assert r["linearizable"]["method"].startswith("per-value:"), r


# -- checker differentials ----------------------------------------------------


NODES3 = ["n1", "n2", "n3"]
NODES5 = ["n1", "n2", "n3", "n4", "n5"]

#: suite -> (builder name in the suite module, opts, concurrency)
DIFFS = {
    "etcd": ("etcd", "etcd_test", {
        "keys": 3, "per_key_limit": 15, "threads_per_key": 2,
        "stagger": 0.0005, "nemesis_interval": 0.1, "time_limit": 1.0,
        "nodes": NODES5}, 6),
    "zookeeper": ("zookeeper", "zookeeper_test", {
        "keys": 2, "per_key_limit": 12, "nodes": NODES3}, 4),
    "consul": ("consul", "consul_test", {
        "keys": 2, "per_key_limit": 12, "threads_per_key": 2,
        "nemesis_interval": 0.1, "time_limit": 1.0, "nodes": NODES3}, 4),
    "mongodb": ("mongodb", "mongodb_test", {
        "ops": 60, "nodes": NODES3}, 4),
    "tidb-register": ("tidb", "tidb_test", {
        "workload": "register", "keys": 3, "per_key_ops": 16,
        "nodes": NODES3}, 4),
    "hazelcast-lock": ("hazelcast", "hazelcast_test", {
        "workload": "lock", "ops": 60, "nodes": NODES3}, 4),
    "hazelcast-queue": ("hazelcast", "hazelcast_test", {
        "workload": "queue", "ops": 60, "nodes": NODES3}, 4),
    "hazelcast-map-register": ("hazelcast", "hazelcast_test", {
        "workload": "map-register", "ops": 60, "nodes": NODES3}, 4),
    "rabbitmq": ("rabbitmq", "rabbitmq_test", {
        "ops": 60, "nodes": NODES3}, 4),
    "raftis": ("simple", None, {
        "workload": "register", "ops": 60, "nodes": NODES3}, 4),
    "cockroach-register": ("cockroachdb", "cockroach_test", {
        "workload": "register", "keys": 3, "per_key_ops": 16,
        "nodes": NODES5}, 6),
}
#: cockroachdb's g2 workload, serializable and weak: no corrupted copy,
#: the weak store's history is the invalid one
G2_DIFFS = {
    "cockroach-g2": ("cockroachdb", "cockroach_test", {
        "workload": "g2", "keys": 6, "nodes": NODES5}, 6),
    "cockroach-g2-weak": ("cockroachdb", "cockroach_test", {
        "workload": "g2", "keys": 6, "weak": True, "nodes": NODES5}, 6),
}


def _spec(name):
    return DIFFS[name] if name in DIFFS else G2_DIFFS[name]


def _test_map(suites, name, opts):
    suite, builder, base, _ = _spec(name)
    mod = getattr(suites, suite)
    opts = {**base, **opts, "dummy": True}
    if builder is None:
        return mod.make_test(name, opts)
    return getattr(mod, builder)(opts)


def _reference_checker(checker):
    """Point every reference LinearizableChecker under ``checker`` at
    the bitset tier in interpret mode on one device."""
    if isinstance(checker, r_lin.LinearizableChecker):
        checker.interpret = True
        checker.mesh = False
    for child in (getattr(checker, "checkers", {}) or {}).values():
        _reference_checker(child)
    inner = getattr(checker, "checker", None)
    if inner is not None:
        _reference_checker(inner)
    return checker


def _record(name, seed, run_dir):
    """One seeded history of the suite's dummy test map, recorded by
    the port's runtime (unchecked) and written as JSON lines."""
    from jepsen_tpu_torch.store import write_history_jsonl

    test = _test_map(t_suites, name, {"device": "cpu",
                                      "rng": random.Random(seed)})
    test["concurrency"] = _spec(name)[3]
    test["checker"] = None
    test = t_run(test)
    run_dir.mkdir()
    write_history_jsonl(str(run_dir / "history.jsonl"), test["history"].ops)
    return run_dir


def _corrupt(run_dir, out_dir):
    """A copy of the history that no linearizable run could give."""
    lines = [json.loads(line) for line in
             (run_dir / "history.jsonl").read_text().splitlines()]

    def first(pred):
        return next(i for i, o in enumerate(lines) if pred(o))

    if any(o["f"] == "acquire" for o in lines):
        # a mutex: the first release never happened
        inv = first(lambda o: o["f"] == "release")
        proc = lines[inv]["process"]
        done = first(lambda o: o["f"] == "release" and o["type"] != "invoke"
                     and o["process"] == proc)
        lines = [o for i, o in enumerate(lines) if i not in (inv, done)]
    elif any(o["f"] == "dequeue" for o in lines):
        i = first(lambda o: o["f"] == "dequeue" and o["type"] == "ok")
        lines[i]["value"] = 10 ** 6
    else:
        i = first(lambda o: o["f"] == "read" and o["type"] == "ok")
        v = lines[i]["value"]
        if isinstance(v, dict) and "__kv__" in v:
            v["__kv__"][1] = 99
        else:
            lines[i]["value"] = 99
    for i, o in enumerate(lines):
        o["index"] = i
    out_dir.mkdir()
    (out_dir / "history.jsonl").write_text(
        "".join(json.dumps(o) + "\n" for o in lines))
    return out_dir


KEEP = ("valid?", "failed_op_index", "failed_value", "key_count")


def verdict_core(r):
    """The fields both packages must agree on, at every level."""
    if isinstance(r, dict):
        out = {}
        for k, v in r.items():
            if k in KEEP or (isinstance(k, str) and k.endswith("-count")):
                out[k] = v
            elif isinstance(v, dict):
                sub = verdict_core(v)
                if sub:
                    out[k] = sub
        return out
    return None


@pytest.mark.parametrize("name", sorted(DIFFS))
def test_checker_maps_agree(name, tmp_path, monkeypatch):
    monkeypatch.setattr(r_lin, "_race_eligible", lambda *a: False)
    valid_dir = _record(name, seed=5, run_dir=tmp_path / "valid")
    bad_dir = _corrupt(valid_dir, tmp_path / "bad")
    got = {}
    for tag, d in (("valid", valid_dir), ("bad", bad_dir)):
        ref_h = RStore(str(d)).load_history(str(d))
        port_h = TStore(str(d)).load_history(str(d))
        ref_map = _reference_checker(
            _test_map(r_suites, name, {"rng": random.Random(0)})["checker"])
        port_map = _test_map(t_suites, name, {
            "device": "cpu", "rng": random.Random(0)})["checker"]
        ref = verdict_core(ref_map.check({}, ref_h, {}))
        port = verdict_core(port_map.check({}, port_h, {}))
        assert port == ref, (tag, port, ref)
        got[tag] = port
    assert got["valid"]["valid?"] is True, got
    assert got["bad"]["valid?"] is False, got
    flat = json.dumps(got["bad"])
    if name.startswith(("hazelcast-queue", "rabbitmq")):
        assert got["bad"]["linearizable"]["failed_value"] == 10 ** 6
        assert got["bad"]["total-queue"]["unexpected-count"] == 1
    else:
        assert '"failed_op_index"' in flat, got["bad"]


@pytest.mark.parametrize("name", sorted(G2_DIFFS))
def test_g2_maps_agree(name, tmp_path):
    """One recorded g2 history of cockroachdb's suite map, checked by
    the reference's map and the port's: the same verdict and the same
    anomaly counts. An insert-pair history is counted on the host in
    both packages (G2Checker's bincounts; the txn-graph program takes
    only micro-op txn histories)."""
    d = _record(name, seed=7, run_dir=tmp_path / "run")
    ref = _test_map(r_suites, name, {"rng": random.Random(0)})[
        "checker"].check({}, RStore(str(d)).load_history(str(d)), {})
    port = _test_map(t_suites, name, {
        "device": "cpu", "rng": random.Random(0)})["checker"].check(
        {}, TStore(str(d)).load_history(str(d)), {})
    keys = ("valid?", "key_count", "legal_count", "illegal_count",
            "illegal")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    weak = name.endswith("-weak")
    assert port["valid?"] is (not weak), port
    assert (port["illegal_count"] > 0) is weak, port


# -- entry points ------------------------------------------------------------


def _module(argv, cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", *argv], cwd=cwd, capture_output=True,
        text=True, timeout=240, env={**os.environ, **(env or {})},
    )


def test_etcd_main_on_the_cpu(tmp_path):
    proc = _module(["jepsen_tpu_torch.suites.etcd", "--dummy",
                    "--backend", "cpu", "--time-limit", "2",
                    "--store", str(tmp_path / "store")], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "valid?=True" in proc.stdout
    assert list((tmp_path / "store").iterdir())


def test_cockroachdb_main_on_the_cpu(tmp_path):
    proc = _module(["jepsen_tpu_torch.suites.cockroachdb", "--dummy",
                    "--backend", "cpu", "--time-limit", "2",
                    "--store", str(tmp_path / "store")], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "valid?=True" in proc.stdout
    assert list((tmp_path / "store").iterdir())


def test_simple_raftis_main_on_the_cpu(tmp_path):
    proc = _module(["jepsen_tpu_torch.suites.simple", "--suite", "raftis",
                    "--dummy", "--backend", "cpu",
                    "--store", str(tmp_path / "store")], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "valid?=True" in proc.stdout


def test_suite_main_without_a_card_exits_254_by_subprocess(tmp_path):
    proc = _module(["jepsen_tpu_torch.suites.etcd", "--dummy",
                    "--store", str(tmp_path / "store")], REPO,
                   env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 254, proc.stderr[-3000:]
    assert "CUDA is not available" in proc.stderr
    assert "valid?" not in proc.stdout
    assert not (tmp_path / "store").exists()


@pytest.mark.parametrize("suite", MAINS)
def test_suite_main_without_a_card_exits_254(suite, tmp_path, monkeypatch,
                                             capsys):
    """In process, CUDA hidden: the main returns 254 before its run
    starts a worker (runtime.run is never reached) and makes no store."""
    import torch

    from jepsen_tpu_torch import runtime

    mod = importlib.import_module(f"jepsen_tpu_torch.suites.{suite}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_run(test):
        raise AssertionError("a worker would have started")

    monkeypatch.setattr(runtime, "run", no_run)
    argv = ["--dummy", "--store", str(tmp_path / "store")]
    if suite == "simple":
        argv += ["--suite", "raftis"]
    assert mod.main(argv) == 254
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "store").exists()


@pytest.mark.parametrize("pkg", PKGS)
def test_faunadb_main_default_concurrency_splits_a_key_group(pkg, tmp_path):
    """A fault of the reference's faunadb suite, kept in the port
    (ROADMAP queue 3): its main's default workload is the keyed
    register, 2 threads a key, but its default --concurrency is 5, so
    the run refuses to start."""
    faunadb = importlib.import_module(f"{pkg}.suites.faunadb")
    argv = ["--dummy", "--time-limit", "1", "--store", str(tmp_path)]
    if pkg == "jepsen_tpu_torch":
        argv += ["--backend", "cpu"]
    with pytest.raises(ValueError, match="multiple of the group size 2"):
        faunadb.main(argv)


@pytest.mark.parametrize("pkg", PKGS)
def test_weak_dirty_reads_show_only_between_two_writes(pkg):
    """A fault of the reference's dirty-reads workload, kept in the
    port (ROADMAP queue 3): its docstring calls the weak store's catch
    deterministic, but the 5th write's half-applied rows are
    overwritten whole by the next write, so only a read between the two
    sees them. Writes 1-6 and then reads: the weak percona run is
    valid, and no read saw the aborted value."""
    run = importlib.import_module(f"{pkg}.runtime").run
    gen = importlib.import_module(f"{pkg}.generator.pure")
    percona = importlib.import_module(f"{pkg}.suites.percona")
    opts = {"dummy": True, "workload": "dirty-reads", "weak": True,
            "nodes": NODES3}
    if pkg == "jepsen_tpu_torch":
        opts["device"] = "cpu"
    test = percona.percona_test(opts)
    test["generator"] = gen.clients(
        [gen.once({"f": "write", "value": v}) for v in range(1, 7)]
        + [gen.once({"f": "read"}) for _ in range(3)])
    test["concurrency"] = 1
    test = run(test)
    fails = [o.value for o in test["history"].ops
             if o.f == "write" and o.type == "fail"]
    reads = [o.value for o in test["history"].ops
             if o.f == "read" and o.type == "ok"]
    assert fails == [5]
    assert reads == [[6] * 8] * 3
    assert test["results"]["valid?"] is True

