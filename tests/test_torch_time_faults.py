"""The port's clock faults (jepsen_tpu_torch.nemesis_time, .faketime and
the node tools in jepsen_tpu_torch/resources/) against the JAX
package's, on the CPU.

Every case of tests/test_time_faults.py runs against both packages, as
one test parametrised by package: the port's case builds bump_time,
strobe_time and strobe_time_experiment with g++ from the port's own
resources/ and runs them in --print-only mode (the host clock is never
touched). Then side by side, on the recording DummyRemote:

- the clock nemesis's setup, bump, strobe, check-offsets and reset
  record the same calls on every node (reset's target second is read
  from the host clock: its lines are compared with the digits masked);
- clock_gen, bump_gen and strobe_gen draw equal op lists for one seed;
- faketime.wrap_binary pipes the same wrapper script, and
  unwrap_binary runs the same command.

Tolerance: exact."""

import random
import re
from pathlib import Path

import pytest

from jepsen_tpu import faketime as r_faketime
from jepsen_tpu import nemesis_time as r_time
from jepsen_tpu.control import core as r_control
from jepsen_tpu.history import ops as r_ops

from jepsen_tpu_torch import faketime as t_faketime
from jepsen_tpu_torch import nemesis_time as t_time
from jepsen_tpu_torch.control import core as t_control
from jepsen_tpu_torch.history import ops as t_ops

from test_torch_generator import PKGS, load_cases, run_case
from test_torch_nemesis import node_log, recording_remote

TESTS = Path(__file__).resolve().parent

TIME_CASES = {pkg: load_cases(TESTS / "test_time_faults.py", pkg)
              for pkg in PKGS}
CASE_NAMES = sorted(n for n in vars(TIME_CASES["jepsen_tpu"])
                    if n.startswith("test_"))

SIDES = {"ref": (r_time, r_faketime, r_control, r_ops),
         "port": (t_time, t_faketime, t_control, t_ops)}
NODES = ["n1", "n2", "n3"]


def test_the_cases_load_each_package():
    assert len(CASE_NAMES) == 4
    for pkg, mod in TIME_CASES.items():
        assert mod.nemesis_time.__name__ == f"{pkg}.nemesis_time"
        assert mod.faketime.__name__ == f"{pkg}.faketime"
    # the port's tools build from the port's own sources
    assert Path(t_time._RES) == Path(t_time.__file__).parent / "resources"


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("pkg", PKGS)
def test_time_faults_case(pkg, case, request):
    run_case(TIME_CASES[pkg], case, request)


def _clock_run(side):
    time_mod, _, control, ops = SIDES[side]
    remote = recording_remote(control, {"date +%s.%N": (0, "0.0\n", "")})
    test = {"nodes": NODES, "remote": remote}
    nem = time_mod.clock_nemesis().setup(test)
    outs = []
    for f, v in (
        ("bump", {"n1": 30000, "n3": -4500}),
        ("strobe", {"n2": {"delta": 100, "period": 10, "duration": 5}}),
        ("check-offsets", None),
        ("reset", None),
    ):
        out = nem.invoke(test, ops.invoke_op("nemesis", f, v))
        value = (sorted(out.value["clock-offsets"]) if f == "check-offsets"
                 else out.value)
        outs.append((out.type, out.f, value))
    nem.teardown(test)
    digits = re.compile(r"@\d+")
    log = {n: [(k, digits.sub("@T", c), u) for k, c, u in calls]
           for n, calls in node_log(remote, NODES).items()}
    return outs, log


def test_clock_nemesis_calls_equal():
    ref, port = _clock_run("ref"), _clock_run("port")
    assert port == ref
    n1 = port[1]["n1"]
    assert ("upload", "/opt/jepsen-tpu/bump_time.cc", "bump_time.cc") in n1
    assert any("/opt/jepsen-tpu/bump_time 30000" in c for _, c, _ in n1)
    assert any("date +%s -s @T" in c for _, c, _ in n1)


@pytest.mark.parametrize("seed", [2, 15])
def test_clock_generators_draw_equal_ops(seed):
    test = {"nodes": ["n1", "n2", "n3", "n4", "n5"]}
    seen = {}
    for side, (time_mod, *_rest) in SIDES.items():
        g = time_mod.clock_gen(random.Random(seed))
        rng = random.Random(seed)
        seen[side] = ([g(test, {}) for _ in range(60)],
                      [time_mod.bump_gen(test, rng) for _ in range(10)],
                      [time_mod.strobe_gen(test, rng) for _ in range(10)],
                      time_mod.reset_gen(test, rng))
    assert seen["port"] == seen["ref"]
    fs = {o["f"] for o in seen["port"][0]}
    assert fs == {"reset", "bump", "strobe", "check-offsets"}


@pytest.mark.parametrize("rate,offset_s", [(5.0, -2.0), (0.5, 3.25),
                                           (1.0, 0.0)])
def test_faketime_wrapper_equal(rate, offset_s):
    seen = {}
    for side, (_, faketime, control, _) in SIDES.items():
        remote = recording_remote(control)
        test = {"nodes": ["n1"], "remote": remote}
        s = control.sessions_for(test)["n1"]
        faketime.wrap_binary(s, "/opt/db/bin/db", rate=rate,
                             offset_s=offset_s)
        faketime.unwrap_binary(s, "/opt/db/bin/db")
        seen[side] = node_log(remote, ["n1"])
    assert seen["port"] == seen["ref"]
    script = [c for k, c, _ in seen["port"]["n1"] if k == "stdin"]
    assert len(script) == 1 and "/opt/db/bin/db.real" in script[0]
    assert t_faketime.SCRIPT == r_faketime.SCRIPT
