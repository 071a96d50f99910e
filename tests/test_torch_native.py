"""The port's native host code (jepsen_tpu_torch.checker.wgl_native on
its own copies of the C++ sources, csrc/wgl_native.cc and
csrc/wgl_prep.cc, built with g++ into build/jepsen_tpu_torch/) and the
oracle dispatch around it (wgl_oracle.check_events_fast,
check_streams), against the JAX package's, on the CPU:

- the native oracle's verdict, failed_op_index, failing event and
  largest frontier equal to the reference's native oracle (and the
  verdict to the Python oracle's) on register, mutex and packed-queue
  streams, valid and invalid, and its envelope checks;
- the native prep byte-identical to the port's numpy path and to the
  reference's ReturnSteps;
- check_streams' verdicts and meta, serial and over a forked pool (in
  a process without jax).

Tolerance: exact equality."""

import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import wgl_native as r_nat
from jepsen_tpu.checker import wgl_oracle as r_or
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import _build
from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import wgl_native as t_nat
from jepsen_tpu_torch.checker import wgl_oracle as t_or
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.history.history import History as THistory
from jepsen_tpu_torch.history.ops import info_op, invoke_op, ok_op


def _mutex_history(seed, n_ops=30, n_procs=3, bad=False):
    """A lock that is held by one process at a time; bad=True lets a
    second process acquire it while it is held."""
    rng = random.Random(seed)
    ops, holder = [], None
    for _ in range(n_ops):
        if holder is None:
            holder = rng.randrange(n_procs)
            ops += [invoke_op(holder, "acquire"), ok_op(holder, "acquire")]
        else:
            if bad and rng.random() < 0.2:
                other = (holder + 1) % n_procs
                ops += [invoke_op(other, "acquire"), ok_op(other, "acquire")]
                bad = False
            ops += [invoke_op(holder, "release"), ok_op(holder, "release")]
            holder = None
    return [o.to_dict() for o in ops]


def _register(seed, corrupt, p_crash=0.1):
    h = gen_register_history(random.Random(seed), n_ops=60, n_procs=4,
                             p_crash=p_crash)
    if corrupt:
        h = corrupt_history(h, random.Random(seed))
    return h.to_dicts()


def _queue(seed, corrupt):
    h = t_sim.gen_queue_history(random.Random(seed), n_ops=40, n_procs=3,
                                n_values=4, p_crash=0.05)
    if corrupt:
        h = t_sim.overdraw_queue_history(h, 1)
    return h.to_dicts()


#: id -> (history op dicts, encoding model, checking model)
STREAMS = {
    "register": (lambda: _register(600, False), "cas-register",
                 "cas-register"),
    "register-invalid": (lambda: _register(601, True), "cas-register",
                         "cas-register"),
    "register-model-invalid": (lambda: _register(602, True, 0.0),
                             "register", "register"),
    "mutex": (lambda: _mutex_history(603), "mutex", "mutex"),
    "mutex-invalid": (lambda: _mutex_history(604, bad=True), "mutex",
                      "mutex"),
    "packed-queue": (lambda: _queue(605, False), "unordered-queue",
                     "unordered-queue-packed"),
    "packed-queue-invalid": (lambda: _queue(606, True), "unordered-queue",
                             "unordered-queue-packed"),
}


def _events(case):
    make, enc, _ = STREAMS[case]
    ev = r_ev.history_to_events(RHistory(make()), model=enc)
    return ev, from_reference(ev)


@pytest.mark.parametrize("case", list(STREAMS))
def test_native_oracle_matches_reference(case):
    model = STREAMS[case][2]
    r_ev_, t_ev_ = _events(case)
    want = r_nat.check_events_native(r_ev_, model, return_stats=True)
    got = t_nat.check_events_native(t_ev_, model, return_stats=True)
    assert want is not None and got == want
    assert got[0] == t_or.check_events(t_ev_, model)
    assert got[0] is ("invalid" not in case)
    fast = t_or.check_events_fast(t_ev_, model, return_stats=True)
    assert fast[0] == got[0] and fast[1]["oracle"] == "native"
    assert fast[1]["failed_op_index"] == got[1]["failed_op_index"]


def test_native_oracle_envelope():
    """Outside the native envelope the oracle declines (None) and
    check_events_fast takes the Python rung: a window past 64 slots, the
    tuple-multiset queue model, a packed queue with more than 7 values."""
    ops = []
    for p in range(70):
        ops += [invoke_op(p, "write", p), info_op(p, "write", p)]
    ops += [invoke_op(200, "read"), ok_op(200, "read", 3)]
    wide = t_ev.history_to_events(THistory(ops), max_window=1 << 10)
    assert wide.window > 64
    assert t_nat.check_events_native(wide) is None
    valid, stats = t_or.check_events_fast(wide, return_stats=True)
    assert stats["oracle"] == "python" and valid == t_or.check_events(wide)

    _, q = _events("packed-queue")
    assert t_nat.check_events_native(q, "unordered-queue") is None
    many = t_ev.history_to_events(
        t_sim.gen_queue_history(random.Random(607), n_ops=40, n_values=9),
        model="unordered-queue")
    assert t_nat.check_events_native(many, "unordered-queue-packed") is None
    assert r_nat.check_events_native(
        r_ev.history_to_events(RHistory(
            t_sim.gen_queue_history(random.Random(607), n_ops=40,
                                    n_values=9).to_dicts()),
            model="unordered-queue"),
        "unordered-queue-packed") is None


@pytest.mark.parametrize("W", [16, 32, 64])
def test_native_prep_is_byte_identical(W):
    """prep_steps_native against the port's numpy path and the
    reference's events_to_steps, every array, on crash-bearing register
    streams (one and two mask words) and a queue stream."""
    for case in ("register", "register-invalid", "packed-queue"):
        r_e, t_e = _events(case)
        want = r_ev.events_to_steps(r_e, W=W)
        numpy_path = t_ev._events_to_steps_numpy(t_e, W)
        got = t_nat.prep_steps_native(t_e, W)
        assert got is not None
        for f in ("occ", "f", "a", "b", "slot", "live", "crashed",
                  "op_index", "fresh"):
            for other in (numpy_path, want):
                a, b = getattr(got, f), getattr(other, f)
                assert a.dtype == b.dtype and a.shape == b.shape, (case, f)
                assert a.tobytes() == b.tobytes(), (case, f)
        assert got.init_state == want.init_state and got.W == W


def test_events_to_steps_takes_the_native_path(monkeypatch):
    """events_to_steps tries the native prep first (PREP_NATIVE) and
    gives the same steps with it switched off."""
    _, t_e = _events("register-invalid")
    calls = []
    real = t_nat.prep_steps_native

    def counting(ev, W):
        calls.append(W)
        return real(ev, W)

    monkeypatch.setattr(t_nat, "prep_steps_native", counting)
    native = t_ev._events_to_steps(t_e, 16)
    assert calls == [16]
    monkeypatch.setattr(t_ev, "PREP_NATIVE", False)
    plain = t_ev._events_to_steps(t_e, 16)
    assert calls == [16]
    assert np.array_equal(native.occ, plain.occ)
    assert np.array_equal(native.fresh, plain.fresh)


def test_native_libraries_build_into_the_port_tree():
    for name in ("wgl_native", "wgl_prep"):
        so = _build.native_library(name)
        assert so is not None and so.parent == _build.BUILD_DIR
        assert so.name.startswith(f"{name}-") and so.suffix == ".so"
    assert t_nat.available() and t_nat.prep_available()


#: check_streams over a pool of two forked workers, in a process that
#: never loads jax (as the port runs; this test process has jax, and
#: forking it would fork jax's threads)
_FORKED = """
import json, random
from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker.events import history_to_events
from jepsen_tpu_torch.checker.wgl_oracle import check_streams
streams = []
for seed, bad in ((600, False), (601, True)):
    h = sim.gen_register_history(random.Random(seed), n_ops=60, n_procs=4,
                                 p_crash=0.1)
    if bad:
        h = sim.corrupt_history(h, random.Random(seed))
    streams.append(history_to_events(h))
verdicts, meta = check_streams(streams, processes=2)
print(json.dumps({"verdicts": verdicts, "meta": meta}))
"""


def test_check_streams_matches_reference():
    """Verdicts and deciding rungs against the reference's, serially,
    and over a pool of two forked workers (the reference's own pool is
    not run here: with jax loaded it spawns fresh interpreters)."""
    pairs = [_events(c) for c in ("register", "register-invalid")]
    want = r_or.check_streams([r for r, _ in pairs], processes=1)
    got = t_or.check_streams([t for _, t in pairs], processes=1)
    assert got[0] == want[0] == [True, False]
    assert got[1]["rungs"] == want[1]["rungs"] == ["native", "native"]
    assert got[1]["oracle"] == want[1]["oracle"] == "native"
    assert got[1]["processes"] == 1

    proc = subprocess.run(
        [sys.executable, "-c", _FORKED],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    forked = json.loads(proc.stdout.strip().splitlines()[-1])
    assert forked["verdicts"] == want[0]
    assert forked["meta"]["rungs"] == want[1]["rungs"]
    assert forked["meta"]["processes"] == 2
