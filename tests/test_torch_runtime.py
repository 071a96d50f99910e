"""The port's runtime (jepsen_tpu_torch.runtime) against the JAX
package's, on the CPU.

Every case of tests/test_runtime.py runs against both packages, as one
test parametrised by package (the file's source loaded once per
package; the port's LinearizableChecker takes device="cpu"). Then:

- at concurrency 1, both runtimes record the same (process, type, f,
  value) sequence from one seed: the ops are drawn up front from the
  register workload's seeded mix (a threaded scheduler polls its
  generator from every thread, so a generator that draws on each poll
  is not replayable), and a client that crashes every seventh invoke
  cycles the processes the same way in both;
- at concurrency 5, a register history recorded by the port's runtime
  (the port's register workload) gets the same valid? from the
  reference's LinearizableChecker(interpret=True) and the port's
  LinearizableChecker(device="cpu"), and so does a copy with one ok
  read's value set outside the written range. The history stays under
  200 ops at W=12, S=8, the shapes other tests compile.

Tolerance: exact."""

import random
import threading
import time
from pathlib import Path

import pytest

from jepsen_tpu.checker.linearizable import LinearizableChecker as RLin
from jepsen_tpu.generator import pure as r_gen
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.runtime import client as r_client
from jepsen_tpu.runtime import core as r_core

from jepsen_tpu_torch.checker.linearizable import (
    LinearizableChecker as TLin,
)
from jepsen_tpu_torch.generator import pure as t_gen
from jepsen_tpu_torch.history.history import History as THistory
from jepsen_tpu_torch.runtime import client as t_client
from jepsen_tpu_torch.runtime import core as t_core
from jepsen_tpu_torch.workloads import register as t_register

from test_torch_generator import PKGS, load_cases, restored_run_logs, run_case

TESTS = Path(__file__).resolve().parent

RUNTIME_CASES = {
    pkg: load_cases(
        TESTS / "test_runtime.py", pkg,
        subs=[("LinearizableChecker()",
               'LinearizableChecker(device="cpu")')],
    )
    for pkg in PKGS
}
CASE_NAMES = sorted(n for n in vars(RUNTIME_CASES["jepsen_tpu"])
                    if n.startswith("test_"))


@pytest.fixture(autouse=True)
def _restore_run_logs():
    with restored_run_logs():
        yield


def test_the_cases_load_each_package():
    assert len(CASE_NAMES) == 9
    for pkg, mod in RUNTIME_CASES.items():
        assert mod.run.__module__ == f"{pkg}.runtime.core"
        assert mod.LinearizableChecker.__module__ == (
            f"{pkg}.checker.linearizable")


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("pkg", PKGS)
def test_runtime_case(pkg, case, request):
    run_case(RUNTIME_CASES[pkg], case, request)


# -- one seed, one worker: the same sequence --------------------------------


def drawn_ops(seed, n):
    """n register ops drawn from the workload's seeded r/w/cas mix by
    the pure interpreter (deterministic, no threads)."""
    from jepsen_tpu_torch.generator.simulate import quick

    rng = random.Random(seed)
    g = t_gen.limit(n, t_register.op_mix(rng))
    return [{"f": o["f"], "value": o.get("value")} for o in quick(g)]


def crash_every_seventh(client_mod):
    class Crashy(client_mod.AtomClient):
        def __init__(self, register=None, counter=None):
            super().__init__(register)
            self.counter = counter if counter is not None else [0]

        def open(self, test, node):
            return Crashy(self.register, self.counter)

        def invoke(self, test, op):
            self.counter[0] += 1
            if self.counter[0] % 7 == 0:
                raise RuntimeError("connection reset")
            return super().invoke(test, op)

    return Crashy()


def _sequence(core, client_mod, gen, ops):
    test = core.run({
        "client": crash_every_seventh(client_mod),
        "generator": gen.clients([gen.once(dict(o)) for o in ops]),
        "concurrency": 1,
    })
    return [(o.process, o.type, o.f, o.value) for o in test["history"].ops]


@pytest.mark.parametrize("seed", [1, 14])
def test_one_worker_records_the_same_sequence(seed):
    ops = drawn_ops(seed, 60)
    want = _sequence(r_core, r_client, r_gen, ops)
    got = _sequence(t_core, t_client, t_gen, ops)
    assert len(got) == 120
    assert got == want
    # the crashes cycled the process: 60 // 7 retirements
    assert max(p for p, *_ in got) == 60 // 7


# -- five workers: the port's history, both checkers ------------------------


class SlowAtomClient(t_client.AtomClient):
    """The workload's register with 1 ms of latency an op, so the five
    workers overlap (the in-memory client alone answers before the
    stagger's next op, and one worker takes every op)."""

    def open(self, test, node):
        return SlowAtomClient(self.register)

    def invoke(self, test, op):
        time.sleep(0.001)
        return super().invoke(test, op)


@pytest.fixture(scope="module")
def port_register_history():
    spec = t_register.workload(n_ops=90, rng=random.Random(5),
                               device="cpu")
    spec["client"] = SlowAtomClient()
    test = t_core.run({**spec, "concurrency": 5})
    return test["history"]


def corrupt_one_read(history, value=7):
    """A copy with the last ok read's value outside the written range
    0-4 (so no linearization can explain it)."""
    ops = list(history.ops)
    i = max(j for j, o in enumerate(ops)
            if o.type == "ok" and o.f == "read")
    ops[i] = ops[i].with_(value=value)
    return THistory(ops, indexed=True)


def _both(history):
    ref = RLin(interpret=True).check(
        None, RHistory.from_dicts(history.to_dicts(), indexed=True))
    port = TLin(device="cpu").check(None, history)
    return ref, port


@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["recorded", "corrupted"])
def test_the_ports_recorded_history_checks_as_the_reference(
        port_register_history, corrupt):
    h = port_register_history
    assert len(h.ops) == 180
    assert len({o.process for o in h.ops}) >= 2
    if corrupt:
        h = corrupt_one_read(h)
    ref, port = _both(h)
    assert port["valid?"] is ref["valid?"] is (not corrupt)
    if corrupt:
        assert port["failed_op_index"] == ref["failed_op_index"]
        assert port["window"] <= 12  # the W=12 bucket


def test_worker_threads_never_touch_cuda(monkeypatch):
    """The workers are plain Python: only the check, after the join,
    runs torch (here on the CPU)."""
    import torch

    seen = []

    def guard(*a, **k):
        seen.append(threading.current_thread().name)
        return False

    monkeypatch.setattr(torch.cuda, "is_available", guard)
    spec = t_register.workload(n_ops=30, rng=random.Random(2),
                               device="cpu")
    test = t_core.run({**spec, "concurrency": 3})
    assert test["results"]["valid?"] is True
    assert not [n for n in seen if n.startswith("jepsen-")]
