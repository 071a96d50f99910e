"""The port's competition race (jepsen_tpu_torch.checker.linearizable:
_NativeRacer, _race_decide, _race_crosscheck, RACE_STATS), the cases
of the reference's tests/test_race.py on the CPU.

The device side is faked where readiness matters: a launch handle's
recorded CUDA event is replaced by an object whose query() turns true
at a chosen time. The native thread, winner selection, cross-check
accounting and the eligibility gate are real. The native oracle's
verdicts are also held against the reference's racer on the same
streams (valid?, failed_op_index; exact)."""

import inspect
import random
import time

import pytest
import torch

import jepsen_tpu.checker.linearizable as r_lin
from jepsen_tpu.checker.events import history_to_events as r_history_to_events
from jepsen_tpu.sim import corrupt_history as r_corrupt
from jepsen_tpu.sim import gen_register_history as r_gen

import jepsen_tpu_torch.checker.linearizable as lin
import jepsen_tpu_torch.checker.wgl_bitset as bs
from jepsen_tpu_torch.checker.dispatch import DispatchPlane
from jepsen_tpu_torch.checker.events import history_to_events
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.checker.wgl_native import available
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import invoke_op, ok_op
from jepsen_tpu_torch.sim import corrupt_history, gen_register_history


@pytest.fixture(autouse=True)
def _native_oracle():
    """The race needs the native oracle (built with g++ at first use)."""
    if not available():
        pytest.skip("no C++ toolchain for the native oracle")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeEvent:
    def __init__(self, ready_at):
        self.ready_at = ready_at

    def query(self):
        return time.perf_counter() >= self.ready_at


def _stream(n_ops=200, seed=5):
    h = gen_register_history(random.Random(seed), n_ops=n_ops, n_procs=4,
                             p_crash=0.01)
    return history_to_events(h)


def _handle(ready_in):
    """A launch_steps_bitset_segmented handle whose event fires
    ready_in seconds from now."""
    return [], (None, None, None, None,
                FakeEvent(time.perf_counter() + ready_in))


def test_native_wins_when_gpu_slow():
    lin.reset_race_stats()
    ev = _stream()
    racer = lin._NativeRacer(ev, "cas-register")
    out = lin._race_decide(ev, None, _handle(30.0), racer, "cas-register")
    assert out is not None
    assert out["valid?"] is True
    assert out["method"] == "cpu-oracle-native"
    assert out["race_winner"] == "native"
    assert lin.RACE_STATS["native_wins"] == 1


def test_gpu_wins_when_ready_first():
    lin.reset_race_stats()
    ev = _stream()
    racer = lin._NativeRacer(ev, "cas-register")
    out = lin._race_decide(ev, None, _handle(0.0), racer, "cas-register")
    assert out is None  # the caller collects the device verdict
    lin._race_crosscheck(racer, True)
    assert lin.RACE_STATS["gpu_wins"] == 1
    assert lin.RACE_STATS["crosschecked"] == 1
    assert lin.RACE_STATS["mismatches"] == 0


def test_crosscheck_counts_mismatch():
    lin.reset_race_stats()
    ev = _stream()
    racer = lin._NativeRacer(ev, "cas-register")
    racer.join(10.0)
    lin._race_crosscheck(racer, False)
    assert lin.RACE_STATS["mismatches"] == 1


def test_native_win_invalid_carries_failure_report():
    lin.reset_race_stats()
    h = History([
        invoke_op(0, "write", 1),
        ok_op(0, "write", 1),
        invoke_op(1, "read"),
        ok_op(1, "read", 2),
    ])
    ev = history_to_events(h)
    racer = lin._NativeRacer(ev, "cas-register")
    out = lin._race_decide(ev, None, _handle(30.0), racer, "cas-register")
    assert out is not None
    assert out["valid?"] is False
    assert out["failed_op_index"] is not None
    assert "failure" in out and out["failure"]["configs"]


def test_eligibility_gate():
    ev = _stream(n_ops=100)
    m = get_model("cas-register")
    assert lin._race_eligible(ev, m)
    big = _stream(n_ops=100)
    big.n_ops = lin.RACE_MAX_OPS + 1
    assert not lin._race_eligible(big, m)
    assert not lin._race_eligible(ev, get_model("unordered-queue"))


def test_bitset_crosscheck_consumes_racer_no_double_count(monkeypatch):
    """After the bitset tier cross-checks its racer, the racer is
    DROPPED before the taint fall-through hands control to the K-ladder:
    every racer decides exactly one race, so gpu_wins + native_wins
    equals the number of racers created."""
    lin.reset_race_stats()
    ev = _stream(n_ops=60, seed=11)
    created = []
    real_racer = lin._NativeRacer

    class CountingRacer(real_racer):
        def __init__(self, *a, **kw):
            created.append(self)
            super().__init__(*a, **kw)

    monkeypatch.setattr(lin, "_NativeRacer", CountingRacer)
    monkeypatch.setattr(lin, "_race_decide", lambda *a, **kw: None)
    monkeypatch.setattr(
        bs, "collect_steps_bitset_segmented",
        lambda steps, handle: (True, True, -1),
    )
    out = lin.check_events_bucketed(ev, race=True, device="cpu")
    assert out["valid?"] is True, out
    assert lin.RACE_STATS["crosschecked"] >= 1
    wins = lin.RACE_STATS["gpu_wins"] + lin.RACE_STATS["native_wins"]
    assert wins == len(created), (dict(lin.RACE_STATS), len(created))
    assert len(created) == 2  # bitset racer dropped; ladder made its own


def test_cpu_route_races_only_when_asked():
    """Nothing races by default, and race=None races on the card only:
    the CPU route (the tests' seam) keeps its methods; race=True on the
    CPU runs the race, whose device side is always ready first there."""
    lin.reset_race_stats()
    ev = _stream(n_ops=60, seed=12)
    out = lin.check_events_bucketed(ev, device="cpu")
    assert out["method"] == "gpu-wgl-bitset"
    assert lin.check_events_bucketed(ev, device="cpu", race=None) == out
    assert sum(lin.RACE_STATS.values()) == 0
    raced = lin.check_events_bucketed(ev, device="cpu", race=True)
    assert raced == out
    assert lin.RACE_STATS["gpu_wins"] == 1


@pytest.mark.parametrize("entry", (
    lin.check_events_bucketed,
    lin.check_queue_by_value,
    lin.LinearizableChecker,
    DispatchPlane,
))
def test_entry_points_do_not_race_by_default(entry):
    """A verdict from the card is the kernel's unless the caller asks
    for the race: every entry point's race= defaults to False."""
    assert inspect.signature(entry).parameters["race"].default is False


@pytest.mark.parametrize("seed", (21, 22))
def test_racer_verdict_matches_reference_racer(seed):
    """The port's native racer and the reference's on the same stream
    (one corrupted): the same verdict and failed_op_index."""
    rng = random.Random(seed)
    h = r_gen(rng, n_ops=120, n_procs=4, p_crash=0.02)
    if seed == 22:
        h = r_corrupt(h, rng)
    rev = r_history_to_events(h)
    want = r_lin._NativeRacer(rev, "cas-register")
    got = lin._NativeRacer(from_reference(rev), "cas-register")
    want.join(30.0)
    got.join(30.0)
    assert got.error is None and want.error is None
    (gv, gs), (wv, ws) = got.result, want.result
    assert gv == wv
    assert gs.get("failed_op_index") == ws.get("failed_op_index")


def test_plane_race_decides_each_request_once():
    """A racing plane (race=True) on the CPU: verdicts equal the
    non-racing plane's on every field but method/race_winner, and every
    request's racer decides exactly one race."""
    streams = []
    for i in range(4):
        rng = random.Random(7200 + i)
        h = gen_register_history(rng, n_ops=40, n_procs=4, p_crash=0.05)
        if i == 1:
            h = corrupt_history(h, rng)
        streams.append(history_to_events(h))

    def run(race):
        with DispatchPlane(device="cpu", race=race) as plane:
            futs = [plane.submit(s) for s in streams]
            plane.flush()
            return [f.result() for f in futs]

    def strip(o):
        return {k: v for k, v in o.items()
                if k not in ("method", "wall_s", "race_winner", "failure")}

    clean = run(False)
    lin.reset_race_stats()
    raced = run(True)
    assert [strip(o) for o in raced] == [strip(o) for o in clean]
    assert lin.RACE_STATS["gpu_wins"] + lin.RACE_STATS["native_wins"] == 4
    assert lin.RACE_STATS["mismatches"] == 0
