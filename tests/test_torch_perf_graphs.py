"""The port's host checkers (jepsen_tpu_torch.checker.timeline, .perf,
.causal and .schedule) against the JAX package's, on the CPU.

Every case of tests/test_perf.py runs against both packages, as one
test parametrised by package. Then side by side:

- timeline.html, latency-raw.svg, rate.svg and clock-skew.svg are byte
  for byte the reference's on the same histories: a literal history
  with set times (client ops of every outcome, an unresolved invoke,
  nemesis windows and clock offsets), and a partitioned register run
  with clock nemesis ops recorded by the port's runtime, stored as JSON
  lines and loaded by each package; the perf() bundle's results agree;
- the causal cases of tests/test_workloads.py and the schedule cases of
  tests/test_divergence.py run on both packages, every checker result
  and job_targets/job_solution output recorded, and the two packages'
  records are equal.

Tolerance: exact."""

import random
from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu.checker import perf as r_perf
from jepsen_tpu.checker import schedule as r_schedule
from jepsen_tpu.checker import timeline as r_timeline
from jepsen_tpu.history import history as r_history
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.store import Store as RStore

from jepsen_tpu_torch.checker import causal as t_causal
from jepsen_tpu_torch.checker import perf as t_perf
from jepsen_tpu_torch.checker import schedule as t_schedule
from jepsen_tpu_torch.checker import timeline as t_timeline
from jepsen_tpu_torch.history import history as t_history
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.store import Store as TStore

from test_torch_generator import PKGS, load_cases, restored_run_logs, run_case

TESTS = Path(__file__).resolve().parent

PERF_CASES = {pkg: load_cases(TESTS / "test_perf.py", pkg) for pkg in PKGS}
PERF_CASE_NAMES = sorted(n for n in vars(PERF_CASES["jepsen_tpu"])
                         if n.startswith("test_"))

SIDES = {
    "ref": dict(perf=r_perf, timeline=r_timeline, history=r_history,
                ops=r_ops, store=RStore),
    "port": dict(perf=t_perf, timeline=t_timeline, history=t_history,
                 ops=t_ops, store=TStore),
}
ARTIFACTS = ("timeline.html", "latency-raw.svg", "rate.svg",
             "clock-skew.svg")


@pytest.fixture(autouse=True)
def _restore_run_logs():
    with restored_run_logs():
        yield


def test_the_cases_load_each_package():
    assert len(PERF_CASE_NAMES) == 4
    for pkg, mod in PERF_CASES.items():
        assert mod.perf.__module__ == f"{pkg}.checker.perf"
        assert mod.html_timeline.__module__ == f"{pkg}.checker.timeline"


@pytest.mark.parametrize("case", PERF_CASE_NAMES)
@pytest.mark.parametrize("pkg", PKGS)
def test_perf_case(pkg, case, request):
    run_case(PERF_CASES[pkg], case, request)


# -- the artifacts, byte for byte --------------------------------------------


def literal_ops(ops):
    """Client ops of every outcome on three processes, an unresolved
    invoke, two nemesis windows and two clock readings, at set times."""
    out, t = [], 0
    kinds = ("ok", "fail", "info", "ok", "ok")
    for i in range(40):
        p, f = i % 3, ("read", "write", "cas")[i % 3]
        v = None if f == "read" else (i % 5 if f == "write" else [1, 2])
        out.append(ops.invoke_op(p, f, v).with_(time=t))
        done = getattr(ops, f"{kinds[i % 5]}_op")(p, f, v if f != "read"
                                                   else i % 4)
        out.append(done.with_(time=t + 700_000 + 31_000 * (i % 7)))
        t += 2_500_000
    out.append(ops.invoke_op(1, "read").with_(time=t))
    for f, a, b in (("start", 10e6, 11e6), ("stop", 40e6, 40.5e6),
                    ("start", 60e6, 60.2e6), ("stop", 90e6, 90.1e6)):
        out.append(ops.invoke_op("nemesis", f).with_(time=int(a)))
        out.append(ops.info_op("nemesis", f, ["isolated", {"n1": ["n2"]}]
                               if f == "start" else "network-healed"
                               ).with_(time=int(b)))
    for k, offs in enumerate(({"n1": 0.0, "n2": 3.5, "n3": -1.25},
                              {"n1": -2.0, "n2": 1.0, "n3": 0.5})):
        t0 = int((30 + 40 * k) * 1e6)
        out.append(ops.invoke_op("nemesis", "check-offsets").with_(time=t0))
        out.append(ops.info_op("nemesis", "check-offsets",
                               {"clock-offsets": offs}).with_(
                                   time=t0 + 100_000))
    out.sort(key=lambda o: o.time)
    return out


def render_all(side, history, run_dir, name):
    m = SIDES[side]
    test = {"name": name, "run_dir": str(run_dir)}
    results = {
        "timeline": m["timeline"].html_timeline().check(test, history),
        "perf": m["perf"].perf().check(test, history),
        "clock": m["perf"].clock_plot().check(test, history),
    }
    files = {a: (run_dir / a).read_bytes() for a in ARTIFACTS}
    for r in (results["timeline"], results["clock"],
              results["perf"]["latency-graph"],
              results["perf"]["rate-graph"]):
        r["file"] = Path(r["file"]).name
    return results, files


def test_artifacts_byte_identical_on_a_literal_history(tmp_path):
    seen = {}
    for side, m in SIDES.items():
        h = m["history"].History(literal_ops(m["ops"]))
        seen[side] = render_all(side, h, tmp_path / side, "literal")
    assert seen["port"][1] == seen["ref"][1]
    assert seen["port"][0] == seen["ref"][0]
    files = seen["port"][1]
    assert b"#F3B5B5" in files["latency-raw.svg"]
    assert b"(unresolved)" in files["timeline.html"]
    assert b"n3" in files["clock-skew.svg"]


@pytest.fixture(scope="module")
def recorded_run(tmp_path_factory):
    """A partitioned register run with clock nemesis ops, recorded by
    the port's runtime and stored as JSON lines."""
    from jepsen_tpu_torch import nemesis as nem
    from jepsen_tpu_torch import nemesis_time
    from jepsen_tpu_torch import net
    from jepsen_tpu_torch.control import DummyRemote
    from jepsen_tpu_torch.generator import pure as gen
    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.store import write_history_jsonl
    from jepsen_tpu_torch.workloads.register import (
        ReplicatedRegisterClient,
        op_mix,
    )

    rng = random.Random(15)
    with restored_run_logs():
        test = run({
            "name": "recorded",
            "nodes": ["n1", "n2", "n3"],
            "net": net.MemNet(),
            "remote": DummyRemote(responses={
                "date +%s.%N": (0, "1700000000.25\n", "")}),
            "client": ReplicatedRegisterClient(latency_s=0.001),
            "nemesis": nem.compose({
                frozenset(["start", "stop"]): nem.partition_halves(),
                frozenset(["reset", "bump", "strobe", "check-offsets"]):
                    nemesis_time.clock_nemesis(),
            }),
            "generator": gen.any_gen(
                gen.clients(gen.limit(120, gen.stagger(
                    0.0005, op_mix(rng), rng=rng))),
                gen.nemesis([
                    gen.sleep(0.01), gen.once({"f": "start"}),
                    gen.once({"f": "check-offsets"}),
                    gen.sleep(0.02), gen.once({"f": "stop"}),
                    gen.once(nemesis_time.clock_gen(rng)),
                    gen.once({"f": "check-offsets"}),
                ]),
            ),
            "concurrency": 3,
        })
    d = tmp_path_factory.mktemp("recorded")
    write_history_jsonl(str(d / "history.jsonl"), test["history"].ops)
    return d


def test_artifacts_byte_identical_on_a_recorded_history(recorded_run,
                                                        tmp_path):
    seen = {}
    for side, m in SIDES.items():
        h = m["store"](str(recorded_run)).load_history(str(recorded_run))
        seen[side] = render_all(side, h, tmp_path / side, "recorded")
    assert seen["port"][1] == seen["ref"][1]
    assert seen["port"][0] == seen["ref"][0]
    files = seen["port"][1]
    assert b"#F3B5B5" in files["latency-raw.svg"]
    assert b"polyline" in files["clock-skew.svg"]
    assert files["timeline.html"].count(b'class="nem"') >= 1


# -- causal and schedule: the reference's cases, results recorded -----------


def _normal(x):
    if hasattr(x, "to_dict"):
        return _normal(x.to_dict())
    if isinstance(x, dict):
        return {k: _normal(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normal(v) for v in x]
    if isinstance(x, np.ndarray):
        return ["ndarray", str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    return x


def recording(mod, names, seen):
    """Point each named checker class or function of a loaded case
    module at a wrapper that records what it returns."""
    for name in names:
        orig = getattr(mod, name)
        if isinstance(orig, type):
            class Rec(orig):
                def check(self, *a, _name=name, **kw):
                    out = super().check(*a, **kw)
                    seen.append((_name, _normal(out)))
                    return out
            setattr(mod, name, Rec)
        else:
            def rec(*a, _orig=orig, _name=name, **kw):
                out = _orig(*a, **kw)
                seen.append((_name, _normal(out)))
                return out
            setattr(mod, name, rec)


HOST_CASES = {
    "workloads": (TESTS / "test_workloads.py", (),
                  ("CausalChecker", "CausalReverseChecker"),
                  ("test_causal_valid_chain", "test_causal_broken_link",
                   "test_causal_stale_read",
                   "test_causal_reverse_violation")),
    # the suites wait for their own slice: only the schedule cases run
    "divergence": (TESTS / "test_divergence.py",
                   (("from jepsen_tpu_torch.suites import chronos, crate, "
                     "elasticsearch, percona",
                     "chronos = elasticsearch = percona = None\n"
                     "crate = type('crate', (), {'WORKLOADS': ()})"),),
                   ("ScheduleChecker", "job_targets", "job_solution"),
                   ("test_job_targets_cutoff", "test_job_solution_matching",
                    "test_schedule_checker_unknown_without_read")),
}


@pytest.mark.parametrize("case", [(f, c) for f, spec in HOST_CASES.items()
                                  for c in spec[3]],
                         ids=lambda fc: fc[1])
def test_host_checker_case_equal(case, request):
    file_key, name = case
    path, subs, names, _ = HOST_CASES[file_key]
    seen = {}
    for pkg in PKGS:
        mod = load_cases(path, pkg, subs=subs)
        seen[pkg] = []
        recording(mod, names, seen[pkg])
        run_case(mod, name, request)
    assert seen["jepsen_tpu_torch"] == seen["jepsen_tpu"]
    assert seen["jepsen_tpu_torch"]


def test_host_checkers_are_the_ports():
    assert t_causal.CausalChecker.__module__ == \
        "jepsen_tpu_torch.checker.causal"
    assert t_schedule.UNKNOWN == r_schedule.UNKNOWN
    assert t_schedule.merge_valid.__module__ == \
        "jepsen_tpu_torch.checker.core"
