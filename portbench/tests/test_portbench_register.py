"""The single-register cell, register-clean: its generator against its
configuration, the program against the plain reference on its items,
its per-layer shares on a traced CPU run, its control, and the judge's
own path beside the control (the faults its timed path can have are in
test_portbench_faults.py)."""

import json
import os

import pytest

from portbench import spec
from portbench.gen import register
from portbench.reference import cas_register
from portbench.tests._tiny import (config, control_readings, run,
                                   tiny_checkout)

CELL = "register-clean"
TRAFFIC = {"pool": 3, "corrupt": [[0, 0.3], [1, 0.7]]}


def _pool(seed=11):
    return register.build_pool(config("etcd-register"), TRAFFIC, seed)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**62 + 5])
def test_history_follows_the_configuration(seed):
    cfg = config("etcd-register")
    ops = register.register_history(cfg, seed)
    assert ops == register.register_history(cfg, seed)
    assert ops != register.register_history(cfg, seed + 1)
    invokes = [o for o in ops if o["type"] == "invoke"]
    assert len(invokes) == cfg["invocations"]
    assert len(ops) == 2 * cfg["invocations"]
    assert {o["type"] for o in ops} == {"invoke", "ok", "fail"}
    assert {o["process"] for o in ops} == set(range(cfg["concurrency"]))
    assert {o["f"] for o in ops} == {"read", "write", "cas"}
    values = set(range(cfg["values"]))
    for o in ops:
        v = o["value"]
        if o["f"] == "cas":
            assert set(v) <= values
        else:
            assert v is None or v in values, o
        if o["type"] == "fail":
            assert o["f"] == "cas"
    times = [o["time"] for o in ops]
    assert times == sorted(times)
    assert 1 <= cas_register.peak_window(ops) <= cfg["concurrency"]
    assert cas_register.check(ops)["valid?"]


def test_pool_and_its_corrupted_copies():
    valid, corrupted = _pool()
    assert len(valid) == 3 and len(corrupted) == 2
    n = len(valid[0]["ops"])
    for it in valid:
        assert not it["keyed"] and not it["corrupt"]
        assert it["invoked"] == config("etcd-register")["invocations"]
    for (h, frac), it in zip(TRAFFIC["corrupt"], corrupted):
        diffs = [i for i, (a, b) in enumerate(zip(valid[h]["ops"],
                                                  it["ops"])) if a != b]
        assert len(diffs) == 1 and diffs[0] >= int(frac * n)
        o = it["ops"][diffs[0]]
        assert (o["type"], o["f"], o["value"]) == ("ok", "read", None)
        v = cas_register.verdict(it)
        assert v == {"valid": False, "failed": diffs[0]}
    again, _ = _pool()
    assert [it["ops"] for it in again] == [it["ops"] for it in valid]


@pytest.mark.parametrize("seed", [3, 2**40 + 1])
def test_program_agrees_with_the_reference(seed):
    """The program on the CPU, through the cell's entry, gives the
    reference's verdict and failing op on every valid and corrupted
    item."""
    from types import SimpleNamespace

    entry = spec.load_module(spec.PKG, "entries", "linearizable")
    valid, corrupted = _pool(seed)
    run_ = SimpleNamespace(
        items=valid + corrupted, device="cpu",
        cell=SimpleNamespace(config=config("etcd-register")))
    state = entry.prepare(run_)
    for i, it in enumerate(run_.items):
        assert entry.check(state, i) == cas_register.verdict(it), it["label"]


def test_the_judge_is_unmoved_by_the_control():
    """The reference's verdict is cas_register.check's, before and after
    the control has read the same items, which it leaves as they
    were."""
    valid, corrupted = _pool(5)
    items = valid + corrupted
    copies = [json.dumps(it["ops"]) for it in items]
    before = [cas_register.verdict(it) for it in items]
    for it, want in zip(items, before):
        r = cas_register.check(it["ops"])
        assert want == {"valid": r["valid?"], "failed": r["failed_op_index"]}
    assert [v["valid"] for v in before] == [True] * 3 + [False] * 2
    fail_ok = spec.load_module(spec.PKG, "controls", "fail-ok")
    ctl = [fail_ok.verdict(it) for it in items]
    assert all(v["valid"] is False for v in ctl)
    assert [json.dumps(it["ops"]) for it in items] == copies
    assert [cas_register.verdict(it) for it in items] == before


def test_control_is_not_correct(tmp_path):
    """The control that etcd-register lists, `fail-ok`, found by its
    name and put in the program's place, through the harness's run and
    its comparison: `correct` comes out false, every check a wrong
    verdict."""
    root = tiny_checkout(tmp_path)
    res = control_readings(root, CELL, "fail-ok", seed=3, seconds=1.0)
    assert res["attempted"] > 0
    assert res["correct"] is False
    # the valid checks; every 8th check is a corrupted copy
    n = res["attempted"]
    assert res["checks"]["wrong_verdicts"]["value"] == n - n // 8


ROOTS = '''def read(run):
    w0, w1 = run.t_window0 * 1e9, run.t_window1 * 1e9
    return sum(max(min(s["ts"] + s["dur"], w1) - max(s["ts"], w0), 0)
               for s in run.spans if s["name"] == "linearizable.check"
               and s.get("parent") is None) / (w1 - w0)
'''

SHARES = ["sentry_share", "events_share", "steps_share",
          "launch_prep_share", "verdict_share", "lin_unnamed_share"]


def test_the_shares_add_up_to_the_checks_on_a_traced_cpu_run(tmp_path):
    root = tiny_checkout(tmp_path)
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(pkg, "metrics", "roots_share.py"), "w") as f:
        f.write(ROOTS)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "roots_share", "unit": "fraction", "better": "lower",
        "source": "program_span", "layer": "x", "moves": "ops_per_s",
        "workloads": [CELL]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    res = run(root, CELL, seconds=2.0, trace=True)
    assert res["correct"] and res["failed"] == 0
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert "keyloop_share" not in m
    assert m["launches_per_check"] >= 1.0
    for name in SHARES:
        assert 0.0 <= m[name] <= 1.0, name
    assert m["roots_share"] > 0.5
    total = sum(m[name] for name in SHARES) + m["sync_wait_share"]
    assert abs(total - m["roots_share"]) < 0.01

