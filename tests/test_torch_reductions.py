"""The port's O(n) checkers (jepsen_tpu_torch.checker.reductions: set,
counter, unique-ids, queue, total-queue, set-full) against the JAX
package's, on the CPU.

Every case of tests/test_reductions.py runs here against both packages,
as one test parametrised by package. Then seeded histories go through
both, and the result dicts must be equal. SetFullChecker's results
carry ops ("known", "last-absent" of each element): they are compared
as op dicts, the packages' Op classes being distinct. The counter runs
both routes in both packages: force_device=False (numpy) and
force_device=True (the reference's jit on JAX-CPU, the port's torch ops
on CPU tensors), with bounds exactly equal in float64. The copies the
checkers stand on (checker/core.py, history/columnar.py, txn.py,
utils/util.py) get parity tests of their own. Tolerance: exact."""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jepsen_tpu import txn as r_txn
from jepsen_tpu.checker import core as r_core
from jepsen_tpu.checker import reductions as r_red
from jepsen_tpu.history import columnar as r_col
from jepsen_tpu.history import history as r_hist
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.utils import util as r_util

from jepsen_tpu_torch import convert
from jepsen_tpu_torch import txn as t_txn
from jepsen_tpu_torch.checker import core as t_core
from jepsen_tpu_torch.checker import reductions as t_red
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats
from jepsen_tpu_torch.history import columnar as t_col
from jepsen_tpu_torch.history import history as t_hist
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.utils import util as t_util


def _pkg(name, red, hist, ops, core, cpu):
    return SimpleNamespace(
        name=name, History=hist.History, invoke_op=ops.invoke_op,
        ok_op=ops.ok_op, fail_op=ops.fail_op, info_op=ops.info_op,
        UNKNOWN=core.UNKNOWN, red=red,
        SetChecker=red.SetChecker, UniqueIdsChecker=red.UniqueIdsChecker,
        QueueChecker=red.QueueChecker,
        TotalQueueChecker=red.TotalQueueChecker,
        SetFullChecker=red.SetFullChecker,
        CounterChecker=(lambda: red.CounterChecker(device="cpu")) if cpu
        else red.CounterChecker,
    )


PKGS = {
    "ref": _pkg("ref", r_red, r_hist, r_ops, r_core, False),
    "port": _pkg("port", t_red, t_hist, t_ops, t_core, True),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def H(pkg, *ops):
    """Index ops and space times 1 ms apart, like the reference's
    history helper (checker_test.clj:412-424)."""
    out = []
    for i, o in enumerate(ops):
        out.append(o.with_(index=i, time=i * 1_000_000))
    return pkg.History(out, indexed=True)


# -- the cases of tests/test_reductions.py, against both packages ------------


def test_queue_empty(pkg):
    assert pkg.QueueChecker().check(None, H(pkg), {})["valid?"] is True


def test_queue_possible_enqueue_no_dequeue(pkg):
    h = H(pkg, pkg.invoke_op(1, "enqueue", 1))
    assert pkg.QueueChecker().check(None, h, {})["valid?"] is True


def test_queue_definite_enqueue_no_dequeue(pkg):
    h = H(pkg, pkg.ok_op(1, "enqueue", 1))
    assert pkg.QueueChecker().check(None, h, {})["valid?"] is True


def test_queue_concurrent_enqueue_dequeue(pkg):
    h = H(
        pkg,
        pkg.invoke_op(2, "dequeue"),
        pkg.invoke_op(1, "enqueue", 1),
        pkg.ok_op(2, "dequeue", 1),
    )
    assert pkg.QueueChecker().check(None, h, {})["valid?"] is True


def test_queue_dequeue_without_enqueue(pkg):
    h = H(pkg, pkg.ok_op(1, "dequeue", 1))
    assert pkg.QueueChecker().check(None, h, {})["valid?"] is False


def test_total_queue_empty(pkg):
    assert pkg.TotalQueueChecker().check(None, H(pkg), {})["valid?"] is True


def test_total_queue_sane(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(
        pkg,
        i(1, "enqueue", 1),
        i(2, "enqueue", 2),
        o(2, "enqueue", 2),
        i(3, "dequeue", 1),
        o(3, "dequeue", 1),
        i(3, "dequeue", 2),
        o(3, "dequeue", 2),
    )
    r = pkg.TotalQueueChecker().check(None, h, {})
    assert r["valid?"] is True
    assert r["attempt-count"] == 2
    assert r["acknowledged-count"] == 1
    assert r["ok-count"] == 2
    assert r["lost-count"] == 0
    assert r["unexpected-count"] == 0
    assert r["duplicated-count"] == 0
    assert r["recovered-count"] == 1
    assert r["recovered"] == {1: 1}


def test_total_queue_pathological(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(
        pkg,
        i(1, "enqueue", "hung"),
        i(2, "enqueue", "enqueued"),
        o(2, "enqueue", "enqueued"),
        i(3, "enqueue", "dup"),
        o(3, "enqueue", "dup"),
        i(4, "dequeue"),
        i(5, "dequeue"),
        o(5, "dequeue", "wtf"),
        i(6, "dequeue"),
        o(6, "dequeue", "dup"),
        i(7, "dequeue"),
        o(7, "dequeue", "dup"),
    )
    r = pkg.TotalQueueChecker().check(None, h, {})
    assert r["valid?"] is False
    assert r["lost"] == {"enqueued": 1}
    assert r["unexpected"] == {"wtf": 1}
    assert r["duplicated"] == {"dup": 1}
    assert r["acknowledged-count"] == 2
    assert r["attempt-count"] == 3
    assert r["ok-count"] == 1
    assert r["lost-count"] == 1
    assert r["unexpected-count"] == 1
    assert r["duplicated-count"] == 1
    assert r["recovered-count"] == 0


def test_total_queue_drain_expansion(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(pkg, i(1, "enqueue", 1), o(1, "enqueue", 1), i(2, "drain"),
          o(2, "drain", [1]))
    r = pkg.TotalQueueChecker().check(None, h, {})
    assert r["valid?"] is True
    assert r["ok-count"] == 1


def test_counter_empty(pkg):
    r = pkg.CounterChecker().check(None, H(pkg), {})
    assert r == {"valid?": True, "reads": [], "errors": []}


def test_counter_initial_read(pkg):
    h = H(pkg, pkg.invoke_op(0, "read"), pkg.ok_op(0, "read", 0))
    r = pkg.CounterChecker().check(None, h, {})
    assert r == {"valid?": True, "reads": [[0, 0, 0]], "errors": []}


def test_counter_ignores_failed_ops(pkg):
    h = H(
        pkg,
        pkg.invoke_op(0, "add", 1),
        pkg.fail_op(0, "add", 1),
        pkg.invoke_op(0, "read"),
        pkg.ok_op(0, "read", 0),
    )
    r = pkg.CounterChecker().check(None, h, {})
    assert r == {"valid?": True, "reads": [[0, 0, 0]], "errors": []}


def test_counter_initial_invalid_read(pkg):
    h = H(pkg, pkg.invoke_op(0, "read"), pkg.ok_op(0, "read", 1))
    r = pkg.CounterChecker().check(None, h, {})
    assert r == {"valid?": False, "reads": [[0, 1, 0]],
                 "errors": [[0, 1, 0]]}


def test_counter_interleaved(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(
        pkg,
        i(0, "read"), i(1, "add", 1), i(2, "read"), i(3, "add", 2),
        i(4, "read"), i(5, "add", 4), i(6, "read"), i(7, "add", 8),
        i(8, "read"),
        o(0, "read", 6), o(1, "add", 1), o(2, "read", 0), o(3, "add", 2),
        o(4, "read", 3), o(5, "add", 4), o(6, "read", 100), o(7, "add", 8),
        o(8, "read", 15),
    )
    r = pkg.CounterChecker().check(None, h, {})
    assert r["valid?"] is False
    assert r["reads"] == [
        [0, 6, 15],
        [0, 0, 15],
        [0, 3, 15],
        [0, 100, 15],
        [0, 15, 15],
    ]
    assert r["errors"] == [[0, 100, 15]]


def test_counter_rolling(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(
        pkg,
        i(0, "read"), i(1, "add", 1), o(0, "read", 0), i(0, "read"),
        o(1, "add", 1), i(1, "add", 2), o(0, "read", 3), i(0, "read"),
        o(1, "add", 2), o(0, "read", 5),
    )
    r = pkg.CounterChecker().check(None, h, {})
    assert r["valid?"] is False
    assert r["reads"] == [[0, 0, 1], [0, 3, 3], [1, 5, 3]]
    assert r["errors"] == [[1, 5, 3]]


def test_set_never_read_unknown(pkg):
    h = H(pkg, pkg.invoke_op(0, "add", 0), pkg.ok_op(0, "add", 0))
    assert pkg.SetChecker().check(None, h, {})["valid?"] == pkg.UNKNOWN


def test_set_ok_lost_unexpected_recovered(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(
        pkg,
        i(0, "add", 0),
        o(0, "add", 0),
        i(0, "add", 1),  # indeterminate, recovered by read
        i(0, "add", 2),
        o(0, "add", 2),  # lost
        i(1, "read"),
        o(1, "read", [0, 1, 5]),  # 5 unexpected
    )
    r = pkg.SetChecker().check(None, h, {})
    assert r["valid?"] is False
    assert r["attempt-count"] == 3
    assert r["acknowledged-count"] == 2
    assert r["ok-count"] == 2
    assert r["lost-count"] == 1
    assert r["recovered-count"] == 1
    assert r["unexpected-count"] == 1
    assert r["lost"] == "#{2}"
    assert r["unexpected"] == "#{5}"
    assert r["recovered"] == "#{1}"


def test_set_valid(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(pkg, i(0, "add", 10), o(0, "add", 10), i(1, "read"),
          o(1, "read", [10]))
    assert pkg.SetChecker().check(None, h, {})["valid?"] is True


def test_unique_ids_valid(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(pkg, i(0, "generate"), o(0, "generate", 1), i(0, "generate"),
          o(0, "generate", 2))
    r = pkg.UniqueIdsChecker().check(None, h, {})
    assert r["valid?"] is True
    assert r["attempted-count"] == 2
    assert r["acknowledged-count"] == 2
    assert r["range"] == [1, 2]


def test_unique_ids_duplicates(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(pkg, i(0, "generate"), o(0, "generate", 7), i(0, "generate"),
          o(0, "generate", 7))
    r = pkg.UniqueIdsChecker().check(None, h, {})
    assert r["valid?"] is False
    assert r["duplicated-count"] == 1
    assert r["duplicated"] == {7: 2}


def SF(pkg, *ops):
    return pkg.SetFullChecker().check(None, H(pkg, *ops), {})


def test_set_full_never_read(pkg):
    r = SF(pkg, pkg.invoke_op(0, "add", 0), pkg.ok_op(0, "add", 0))
    assert r["valid?"] == pkg.UNKNOWN
    assert r["attempt-count"] == 1
    assert r["never-read"] == [0]
    assert r["never-read-count"] == 1
    assert r["stable-count"] == 0
    assert r["lost-count"] == 0


def test_set_full_never_confirmed_never_read(pkg):
    r = SF(pkg, pkg.invoke_op(0, "add", 0), pkg.invoke_op(1, "read"),
           pkg.ok_op(1, "read", []))
    assert r["valid?"] == pkg.UNKNOWN
    assert r["never-read"] == [0]


def test_set_full_successful_read_windows(pkg):
    a = pkg.invoke_op(0, "add", 0)
    a_ = pkg.ok_op(0, "add", 0)
    r = pkg.invoke_op(1, "read")
    rp = pkg.ok_op(1, "read", [0])
    for hist in (
        (r, a, rp, a_),  # concurrent read before
        (r, a, a_, rp),  # concurrent read outside
        (a, r, rp, a_),  # concurrent read inside
        (a, r, a_, rp),  # concurrent read after
        (a, a_, r, rp),  # subsequent read
    ):
        out = SF(pkg, *hist)
        assert out["valid?"] is True, hist
        assert out["stable-count"] == 1
        assert out["stable-latencies"] == {0: 0, 0.5: 0, 0.95: 0, 0.99: 0,
                                           1: 0}


def test_set_full_absent_read_after_is_lost(pkg):
    r = SF(pkg, pkg.invoke_op(0, "add", 0), pkg.ok_op(0, "add", 0),
           pkg.invoke_op(1, "read"), pkg.ok_op(1, "read", []))
    assert r["valid?"] is False
    assert r["lost"] == [0]
    assert r["lost-count"] == 1
    assert r["lost-latencies"] == {0: 0, 0.5: 0, 0.95: 0, 0.99: 0, 1: 0}


def test_set_full_absent_read_concurrent_is_unknown(pkg):
    a = pkg.invoke_op(0, "add", 0)
    a_ = pkg.ok_op(0, "add", 0)
    r = pkg.invoke_op(1, "read")
    rm = pkg.ok_op(1, "read", [])
    for hist in ((r, a, rm, a_), (r, a, a_, rm), (a, r, rm, a_),
                 (a, r, a_, rm)):
        out = SF(pkg, *hist)
        assert out["valid?"] == pkg.UNKNOWN, hist
        assert out["never-read"] == [0]


def test_set_full_write_present_missing(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    a0, a0_ = i(0, "add", 0), o(0, "add", 0)
    a1, a1_ = i(1, "add", 1), o(1, "add", 1)
    r2 = i(2, "read")
    r = SF(
        pkg,
        a0, a1, r2, o(2, "read", [1]),
        a0_, a1_,
        r2, o(2, "read", [0, 1]),
        r2, o(2, "read", [0]),
        r2, o(2, "read", []),
    )
    assert r["valid?"] is False
    assert r["attempt-count"] == 2
    assert sorted(r["lost"]) == [0, 1]
    assert r["lost-count"] == 2
    assert r["stable-count"] == 0
    assert r["lost-latencies"] == {0: 3, 0.5: 4, 0.95: 4, 0.99: 4, 1: 4}


def test_set_full_write_flutter_stable_lost(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    a0, a0_ = i(0, "add", 0), o(0, "add", 0)
    a1, a1_ = i(1, "add", 1), o(1, "add", 1)
    r2 = i(2, "read")
    r3 = i(3, "read")
    # t  0   1    2   3   4              5    6   7   8              9
    r = SF(
        pkg,
        a0, a0_, a1, r2, o(2, "read", [1]), a1_, r2, r3,
        o(3, "read", [1]), o(2, "read", [0]),
    )
    assert r["valid?"] is False
    assert r["lost"] == [0]
    assert r["stable-count"] == 1
    assert r["stale"] == [1]
    assert r["lost-latencies"] == {0: 5, 0.5: 5, 0.95: 5, 0.99: 5, 1: 5}
    assert r["stable-latencies"] == {0: 2, 0.5: 2, 0.95: 2, 0.99: 2, 1: 2}
    ws = r["worst-stale"]
    assert len(ws) == 1
    assert ws[0]["element"] == 1
    assert ws[0]["outcome"] == "stable"
    assert ws[0]["stable-latency"] == 2
    assert ws[0]["known"].index == 4  # the read that saw 1 pre-ack
    assert ws[0]["last-absent"].index == 6


def test_set_full_duplicates_invalidate(pkg):
    r = SF(pkg, pkg.invoke_op(0, "add", 0), pkg.ok_op(0, "add", 0),
           pkg.invoke_op(1, "read"), pkg.ok_op(1, "read", [0, 0]))
    assert r["valid?"] is False
    assert r["duplicated-count"] == 1
    assert r["duplicated"] == {0: 2}


def test_set_full_linearizable_mode_fails_stale(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    a0, a0_ = i(0, "add", 0), o(0, "add", 0)
    a1, a1_ = i(1, "add", 1), o(1, "add", 1)
    r2 = i(2, "read")
    # Element 1: miss then hit after ack -> stale but stable.
    hist = (a0, a0_, a1, a1_, r2, o(2, "read", [0]), r2,
            o(2, "read", [0, 1]))
    assert pkg.SetFullChecker().check(None, H(pkg, *hist), {})[
        "valid?"] is True
    assert pkg.SetFullChecker(linearizable=True).check(
        None, H(pkg, *hist), {})["valid?"] is False


def test_counter_float_values(pkg):
    # Float deltas/reads must not silently read as 0 (num_ok=False rows).
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(pkg, i(0, "add", 1), o(0, "add", 1), i(0, "read"),
          o(0, "read", 1.0))
    r = pkg.CounterChecker().check(None, h, {})
    assert r["valid?"] is True
    h2 = H(pkg, i(0, "add", 0.5), o(0, "add", 0.5), i(0, "read"),
           o(0, "read", 0.5))
    r2 = pkg.CounterChecker().check(None, h2, {})
    assert r2["valid?"] is True
    assert r2["reads"] == [[0.5, 0.5, 0.5]]


def test_unique_ids_unhashable_duplicates(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = H(pkg, i(0, "generate"), o(0, "generate", [1, 2]),
          i(0, "generate"), o(0, "generate", [1, 2]))
    r = pkg.UniqueIdsChecker().check(None, h, {})
    assert r["valid?"] is False
    assert r["duplicated-count"] == 1


def test_counter_device_path_parity(pkg):
    # The device path and the numpy path must agree bit-for-bit.
    rng = random.Random(4)
    ops = []
    val = 0
    for _ in range(300):
        p = rng.randrange(4)
        if rng.random() < 0.5:
            d = rng.randrange(1, 5)
            ops.append(pkg.invoke_op(p, "add", d))
            ops.append(pkg.ok_op(p, "add", d))
            val += d
        else:
            ops.append(pkg.invoke_op(p, "read"))
            ops.append(pkg.ok_op(p, "read", val))
    h = pkg.History(ops)
    a = pkg.CounterChecker().check({}, h, force_device=False)
    b = pkg.CounterChecker().check({}, h, force_device=True)
    assert a == b
    assert a["valid?"] is True


def test_set_full_blocked_matches_unblocked(pkg, monkeypatch):
    rng = random.Random(9)
    ops = []
    seen = []
    for i in range(40):
        p = rng.randrange(3)
        if rng.random() < 0.5 or not seen:
            ops.append(pkg.invoke_op(p, "add", i))
            ops.append(pkg.ok_op(p, "add", i))
            seen.append(i)
        else:
            obs = [x for x in seen if rng.random() < 0.8]
            ops.append(pkg.invoke_op(p, "read"))
            ops.append(pkg.ok_op(p, "read", obs))
    h = pkg.History(ops)
    full = pkg.SetFullChecker().check({}, h)
    monkeypatch.setattr(pkg.red, "_SETFULL_BLOCK_CELLS", 64)  # force blocks
    blocked = pkg.SetFullChecker().check({}, h)
    assert full == blocked


def test_total_queue_crashed_drain_degrades_to_unknown(pkg):
    """A crashed (:info) drain may have consumed elements: apparent
    losses become unknown, not false — but clean histories stay valid
    and unexpected elements stay invalid."""
    i, o, info = pkg.invoke_op, pkg.ok_op, pkg.info_op
    base = [
        i(0, "enqueue", 1), o(0, "enqueue", 1),
        i(1, "enqueue", 2), o(1, "enqueue", 2),
        i(0, "dequeue"), o(0, "dequeue", 1),
    ]
    chk = pkg.TotalQueueChecker()
    r = chk.check({}, pkg.History(base + [i(1, "drain"), info(1, "drain")]))
    assert r["valid?"] == "unknown"
    assert r["crashed-drain-count"] == 1 and r["lost-count"] == 1
    r = chk.check({}, pkg.History(base))
    assert r["valid?"] is False and r["lost-count"] == 1
    r = chk.check({}, pkg.History(base + [
        i(1, "dequeue"), o(1, "dequeue", 2), i(1, "drain"),
        info(1, "drain")]))
    assert r["valid?"] is True
    r = chk.check({}, pkg.History(base + [
        i(1, "dequeue"), o(1, "dequeue", 99), i(1, "drain"),
        info(1, "drain")]))
    assert r["valid?"] is False


# -- seeded differentials: the same history through both packages ----------


def _plain(x):
    """Result values with ops as op dicts (the packages' Op classes
    differ), recursively."""
    if hasattr(x, "to_dict") and hasattr(x, "is_invoke"):
        return x.to_dict()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def _set_ops(rng, n=120):
    ops, added = [], []
    for i in range(n):
        p = rng.randrange(4)
        if rng.random() < 0.6:
            v = rng.choice([i, i, str(i), float(i)])
            ops.append({"type": "invoke", "f": "add", "value": v,
                        "process": p})
            t = rng.choice(["ok", "ok", "ok", "fail", "info"])
            ops.append({"type": t, "f": "add", "value": v, "process": p})
            added.append(v)
        else:
            obs = [v for v in added if rng.random() < 0.85]
            if rng.random() < 0.1:
                obs.append(10_000 + i)  # never added
            if obs and rng.random() < 0.05:
                obs.append(obs[0])  # duplicate element
            ops.append({"type": "invoke", "f": "read", "value": None,
                        "process": p})
            ops.append({"type": "ok", "f": "read", "value": obs,
                        "process": p})
    return ops


def _counter_ops(rng, n=400, p_float=0.3, bad=0.0):
    ops, val, pending = [], 0.0, []
    for i in range(n):
        p = rng.randrange(5)
        if rng.random() < 0.5:
            d = (rng.randrange(1, 40) / 4 if rng.random() < p_float
                 else rng.randrange(0, 6))
            ops.append({"type": "invoke", "f": "add", "value": d,
                        "process": p})
            t = rng.choice(["ok"] * 6 + ["fail", "info"])
            if t != "fail":
                val += d
            ops.append({"type": t, "f": "add", "value": d, "process": p})
        else:
            ops.append({"type": "invoke", "f": "read", "value": None,
                        "process": p})
            v = val + (rng.choice([-50, 50]) if rng.random() < bad else 0)
            ops.append({"type": "ok", "f": "read",
                        "value": int(v) if float(v).is_integer() else v,
                        "process": p})
    return ops


def _queue_ops(rng, n=150):
    ops, live = [], []
    for i in range(n):
        p = rng.randrange(4)
        r = rng.random()
        if r < 0.5:
            v = rng.randrange(40)
            ops.append({"type": "invoke", "f": "enqueue", "value": v,
                        "process": p})
            ops.append({"type": rng.choice(["ok", "ok", "info"]),
                        "f": "enqueue", "value": v, "process": p})
            live.append(v)
        elif r < 0.9 or not live:
            v = (live.pop(rng.randrange(len(live))) if live
                 and rng.random() < 0.95 else rng.randrange(60))
            ops.append({"type": "invoke", "f": "dequeue", "value": None,
                        "process": p})
            ops.append({"type": "ok", "f": "dequeue", "value": v,
                        "process": p})
        else:
            got = [live.pop() for _ in range(min(len(live), 3))]
            ops.append({"type": "invoke", "f": "drain", "value": None,
                        "process": p})
            ops.append({"type": rng.choice(["ok", "ok", "info"]),
                        "f": "drain", "value": got, "process": p})
    return ops


def _ids_ops(rng, n=200):
    ops = []
    for i in range(n):
        p = rng.randrange(4)
        ops.append({"type": "invoke", "f": "generate", "value": None,
                    "process": p})
        v = rng.randrange(n * 4) if rng.random() < 0.9 else rng.randrange(8)
        ops.append({"type": rng.choice(["ok"] * 8 + ["info"]),
                    "f": "generate", "value": v, "process": p})
    return ops


#: id -> (ops factory, checker name, constructor kwargs)
DIFFS = {
    "set": (_set_ops, "SetChecker", {}),
    "set-full": (_set_ops, "SetFullChecker", {}),
    "set-full-linearizable": (_set_ops, "SetFullChecker",
                              {"linearizable": True}),
    "unique-ids": (_ids_ops, "UniqueIdsChecker", {}),
    "queue": (_queue_ops, "QueueChecker", {}),
    "total-queue": (_queue_ops, "TotalQueueChecker", {}),
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("case", list(DIFFS))
def test_seeded_results_match_reference(case, seed):
    factory, name, kw = DIFFS[case]
    ops = factory(random.Random(seed))
    want = getattr(r_red, name)(**kw).check({}, r_hist.History(
        [dict(o) for o in ops]))
    got = getattr(t_red, name)(**kw).check({}, t_hist.History(
        [dict(o) for o in ops]))
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("force", [False, True], ids=["numpy", "device"])
@pytest.mark.parametrize("seed,bad", [(5, 0.0), (6, 0.05), (7, 0.0)])
def test_counter_routes_match_reference(seed, bad, force):
    """Float and int deltas, failed and crashed adds: both packages'
    routes give one result dict, the port's torch route on CPU tensors
    included."""
    ops = _counter_ops(random.Random(seed), bad=bad)
    want = r_red.CounterChecker().check(
        {}, r_hist.History([dict(o) for o in ops]), force_device=force)
    got = t_red.CounterChecker(device="cpu").check(
        {}, t_hist.History([dict(o) for o in ops]), force_device=force)
    assert got == want
    assert got["valid?"] is (bad == 0.0)


def test_counter_bounds_torch_equal_numpy_in_float64():
    """counter_bounds_torch against the reference checker's numpy
    expressions on the same float64 inputs: lo, hi, v and bad exactly
    equal (quarter deltas: every partial sum is exact, whatever the
    summation order)."""
    rng = np.random.default_rng(12)
    n = 5_000
    vals = rng.integers(-40, 80, n) / 4.0
    vals[rng.random(n) < 0.01] = np.nan
    inv_add = rng.random(n) < 0.5
    ok_add = inv_add & (rng.random(n) < 0.8)
    inv_pos = np.sort(rng.integers(0, n - 1, 700))
    comp_pos = np.minimum(inv_pos + rng.integers(1, 50, 700), n - 1)
    lo_w = np.cumsum(np.where(ok_add, vals, 0))[inv_pos]
    hi_w = np.cumsum(np.where(inv_add, vals, 0))[comp_pos]
    v_w = vals[comp_pos]
    bad_w = np.isnan(v_w) | (v_w < lo_w) | (hi_w < v_w)
    out = t_red.counter_bounds_torch(
        *(torch.from_numpy(a) for a in (vals, inv_add, ok_add, inv_pos,
                                        comp_pos))).numpy()
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out[0], lo_w)
    np.testing.assert_array_equal(out[1], hi_w)
    np.testing.assert_array_equal(out[2], v_w)
    np.testing.assert_array_equal(out[3] > 0.5, bad_w)


def test_counter_device_route_fetches_once():
    """force_device=True is one counted device->host fetch; the numpy
    route none."""
    h = t_hist.History([dict(o) for o in _counter_ops(random.Random(8))])
    chk = t_red.CounterChecker(device="cpu")
    reset_launch_stats()
    chk.check({}, h, force_device=False)
    assert launch_stats_snapshot()["host_syncs"] == 0
    chk.check({}, h, force_device=True)
    assert launch_stats_snapshot()["host_syncs"] == 1


def test_factories_match_reference():
    pairs = [
        (r_red.set_checker(), t_red.set_checker()),
        (r_red.set_full(True), t_red.set_full(True)),
        (r_red.counter(), t_red.counter(device="cpu")),
        (r_red.unique_ids(), t_red.unique_ids()),
        (r_red.queue(), t_red.queue()),
        (r_red.total_queue(), t_red.total_queue()),
    ]
    for r, t in pairs:
        assert type(r).__name__ == type(t).__name__
    assert pairs[1][1].linearizable is True
    assert pairs[4][1].model_factory is t_red.UnorderedQueue
    assert t_red.counter().device is None


# -- the copies the checkers stand on ----------------------------------------


@pytest.mark.parametrize("xs", [
    [], [1, 2, 3, 5, 7, 8, 9], [3, 1, 2, 2], [-2, -1, 4], [1, "a", 2.5],
    ["b", "a"], [True, 1], [10],
], ids=lambda xs: repr(xs))
def test_util_integer_interval_set_str(xs):
    assert t_util.integer_interval_set_str(xs) == \
        r_util.integer_interval_set_str(xs)


def test_util_natural_key():
    vals = [3, "a", 2.5, True, None, (1, 2), -1, "B", False, [0], 0]
    assert [t_util.natural_key(v) for v in vals] == \
        [r_util.natural_key(v) for v in vals]
    assert sorted(vals, key=t_util.natural_key, reverse=True) == \
        sorted(vals, key=r_util.natural_key, reverse=True)


class _Boom:
    def check(self, test, history, opts=None):
        raise ValueError("boom")


def test_core_lattice_and_combinators():
    for vals in ([], [True], [True, "unknown"], ["unknown", False, True],
                 [True, "weird"], [None]):
        assert t_core.merge_valid(vals) == r_core.merge_valid(vals)
    fn = t_core.FnChecker(lambda t, h, o: {"valid?": "unknown"})
    out = t_core.compose({"noop": t_core.NoopChecker(), "fn": fn,
                          "boom": _Boom()}).check({}, [])
    want = r_core.compose({"noop": r_core.NoopChecker(),
                           "fn": r_core.FnChecker(
                               lambda t, h, o: {"valid?": "unknown"}),
                           "boom": _Boom()}).check({}, [])
    assert out["valid?"] == want["valid?"] == "unknown"
    assert out["noop"] == want["noop"] and out["fn"] == want["fn"]
    assert "ValueError: boom" in out["boom"]["error"]
    assert out["boom"]["valid?"] == "unknown"
    lim = t_core.concurrency_limit(2, t_core.NoopChecker())
    assert lim.check({}, []) == {"valid?": True} and lim.limit == 2
    assert isinstance(t_core.NoopChecker(), t_core.Checker)
    assert t_core.check_safe(_Boom(), {}, [])["valid?"] == t_core.UNKNOWN


def test_columnar_matches_reference():
    """Every column, the interned codes and the pair links of the same
    history; keyed by a key_fn; select() rows; and a reference
    ColumnarHistory carried across by convert.from_reference."""
    rng = random.Random(21)
    ops = _counter_ops(rng, n=60) + _set_ops(rng, n=40) + [
        {"type": "invoke", "f": "cas", "value": [1, 2], "process": 0},
        {"type": "ok", "f": "cas", "value": [1, 2], "process": 0},
        {"type": "invoke", "f": "write", "value": True, "process": 1},
        {"type": "info", "f": "write", "value": True, "process": 1},
        {"type": "info", "f": "kill", "value": {"n": 1},
         "process": "nemesis"},
    ]

    def key_fn(o):
        return o.process if isinstance(o.process, int) else None

    for kf in (None, key_fn):
        want = r_col.ColumnarHistory.from_history(
            r_hist.History([dict(o) for o in ops]), key_fn=kf)
        got = t_col.ColumnarHistory.from_history(
            t_hist.History([dict(o) for o in ops]), key_fn=kf)
        carried = convert.from_reference(want)
        for cols in (got, carried):
            for f in dataclasses.fields(t_col.ColumnarHistory):
                if f.name in ("encoder", "extra"):
                    continue
                np.testing.assert_array_equal(getattr(cols, f.name),
                                              getattr(want, f.name))
            assert cols.encoder.f_codes == want.encoder.f_codes
            assert cols.encoder.value_codes == want.encoder.value_codes
            assert cols.extra["key_codes"] == want.extra["key_codes"]
            assert [cols.encoder.decode_value(c) for c in range(-1, 5)] == \
                [want.encoder.decode_value(c) for c in range(-1, 5)]
        mask = want.type == 1
        np.testing.assert_array_equal(got.select(mask).v0,
                                      want.select(mask).v0)
    for v in (1, True, 1.0, np.int64(1), [1, (2, 3)], {1, 2}, {"a": [1]},
              "s", None):
        assert t_col.intern_key(v) == r_col.intern_key(v)


def test_txn_matches_reference():
    txns = [r_txn.gen_txn(["x", "y", 1, True], rng=random.Random(s),
                          mode=m, counter=[0])
            for s in range(12) for m in ("register", "append")]
    for t in txns:
        assert t_txn.ext_reads(t) == r_txn.ext_reads(t)
        assert t_txn.ext_writes(t) == r_txn.ext_writes(t)
        assert t_txn.apply_txn({}, t) == r_txn.apply_txn({}, t)
        assert t_txn.reads(t) == r_txn.reads(t)
        assert t_txn.writes(t) == r_txn.writes(t)
    for m in ("register", "append"):
        a = [t_txn.gen_txn(["k", 2], rng=random.Random(3), mode=m)
             for _ in range(4)]
        b = [r_txn.gen_txn(["k", 2], rng=random.Random(3), mode=m)
             for _ in range(4)]
        assert a == b
    got, want = t_txn.encode_txns(txns), r_txn.encode_txns(txns)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    with pytest.raises(ValueError):
        t_txn.encode_txns(txns, max_len=1)
    assert t_txn.apply_mop({}, ("w", "k", 1)) == \
        r_txn.apply_mop({}, ("w", "k", 1))
