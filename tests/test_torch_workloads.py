"""BASELINE configs 3-5's checkers in the port
(jepsen_tpu_torch.checker.bank, .adya, .longfork) against the JAX
package's, on the CPU.

Every bank, long-fork and G2 case of tests/test_workloads.py runs here
against both packages, as one test parametrised by package. The
runtime-driven cases take their history from the reference's runtime
(the port has no runtime yet) and check it with each package's checker.
Then seeded sim histories (each package's own generator, which must
yield the same ops) go through both checkers, with the plane encoded
once by the reference and carried across by convert.from_reference,
and the result dicts must be equal: the bank on both routes
(force_device=False, numpy; force_device=True, the reference's jit on
JAX-CPU against the port's torch ops on CPU tensors), long-fork through
the port's torch product on the CPU. G2 over micro-op txn histories
needs the transactional graph checker, which the port does not have
yet: it raises there. Tolerance: exact."""

import functools
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jepsen_tpu import sim as r_sim
from jepsen_tpu.checker import adya as r_adya
from jepsen_tpu.checker import bank as r_bank
from jepsen_tpu.checker import longfork as r_lf
from jepsen_tpu.history import history as r_hist
from jepsen_tpu.history import ops as r_ops

from jepsen_tpu_torch import convert
from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import adya as t_adya
from jepsen_tpu_torch.checker import bank as t_bank
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import longfork as t_lf
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats
from jepsen_tpu_torch.history import history as t_hist
from jepsen_tpu_torch.history import ops as t_ops

PKGS = {
    "ref": SimpleNamespace(
        History=r_hist.History, invoke_op=r_ops.invoke_op,
        ok_op=r_ops.ok_op,
        BankChecker=r_bank.BankChecker, G2Checker=r_adya.G2Checker,
        LongForkChecker=r_lf.LongForkChecker,
    ),
    "port": SimpleNamespace(
        History=t_hist.History, invoke_op=t_ops.invoke_op,
        ok_op=t_ops.ok_op,
        BankChecker=functools.partial(t_bank.BankChecker, device="cpu"),
        G2Checker=t_adya.G2Checker,
        LongForkChecker=functools.partial(t_lf.LongForkChecker,
                                          device="cpu"),
    ),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def _as(pkg, history):
    """A reference History as the package's own."""
    return pkg.History([o.to_dict() for o in history.ops], indexed=True)


@functools.lru_cache(maxsize=None)
def _runtime(workload, **kw):
    """One run of the reference's runtime: (test map, history). The G2
    workload's ops carry independent KV values, which its checker
    unwraps into (key, ids) pairs before the G2 count: so does this."""
    from jepsen_tpu import independent
    from jepsen_tpu.runtime import run
    from jepsen_tpu.workloads import adya, bank, long_fork

    mod = {"bank": bank, "long_fork": long_fork, "adya": adya}[workload]
    conc = kw.pop("concurrency")
    if "seed" in kw:
        kw["rng"] = random.Random(kw.pop("seed"))
    test = run({**mod.workload(**kw), "concurrency": conc})
    h = test["history"]
    if workload == "adya":
        h = r_hist.History([
            o.with_(value=(o.value.key, o.value.value)) for o in h.ops
            if isinstance(o.value, independent.KV)
        ])
    return test, h


# -- the cases of tests/test_workloads.py, against both packages -------------


BANK_TEST = {"accounts": list(range(4)), "total_amount": 40}


def bank_read(pkg, proc, balances):
    return [pkg.invoke_op(proc, "read"), pkg.ok_op(proc, "read", balances)]


def test_bank_valid_reads(pkg):
    h = pkg.History(
        bank_read(pkg, 0, {0: 10, 1: 10, 2: 10, 3: 10})
        + bank_read(pkg, 1, {0: 0, 1: 20, 2: 15, 3: 5})
    )
    r = pkg.BankChecker().check(BANK_TEST, h)
    assert r["valid?"] is True
    assert r["read_count"] == 2


def test_bank_wrong_total(pkg):
    h = pkg.History(
        bank_read(pkg, 0, {0: 10, 1: 10, 2: 10, 3: 11})
        + bank_read(pkg, 1, {0: 10, 1: 10, 2: 10, 3: 10})
    )
    r = pkg.BankChecker().check(BANK_TEST, h)
    assert r["valid?"] is False
    assert r["errors"]["wrong-total"]["count"] == 1
    assert r["errors"]["wrong-total"]["first"]["total"] == 41
    assert r["first_error"]["op_index"] == 1


def test_bank_nil_and_negative_and_unexpected(pkg):
    h = pkg.History(
        bank_read(pkg, 0, {0: 10, 1: None, 2: 10, 3: 20})
        + bank_read(pkg, 1, {0: -5, 1: 25, 2: 10, 3: 10})
        + bank_read(pkg, 2, {0: 10, 1: 10, 2: 10, 3: 10, "x": 0})
    )
    r = pkg.BankChecker().check(BANK_TEST, h)
    assert r["valid?"] is False
    assert r["errors"]["nil-balance"]["count"] == 1
    assert r["errors"]["negative-value"]["count"] == 1
    assert r["errors"]["unexpected-key"]["count"] == 1
    r2 = pkg.BankChecker(negative_balances=True).check(BANK_TEST, h)
    assert "negative-value" not in r2["errors"]


def test_bank_missing_account_is_wrong_total(pkg):
    h = pkg.History(bank_read(pkg, 0, {0: 10, 1: 10, 2: 10}))
    r = pkg.BankChecker().check(BANK_TEST, h)
    assert r["valid?"] is False
    assert r["errors"]["wrong-total"]["first"]["total"] == 30


def test_bank_runtime_snapshot_valid(pkg):
    test, h = _runtime("bank", n_ops=200, seed=1, concurrency=5)
    r = pkg.BankChecker().check(test, _as(pkg, h))
    assert r["valid?"] is True
    assert r["read_count"] > 10


def test_bank_runtime_torn_reads_caught(pkg):
    test, h = _runtime("bank", n_ops=300, seed=2, snapshot_reads=False,
                       concurrency=5)
    r = pkg.BankChecker().check(test, _as(pkg, h))
    assert r["valid?"] is False
    assert "wrong-total" in r["errors"]


def lf_read(pkg, proc, pairs):
    v = [["r", k, val] for k, val in pairs]
    return [pkg.invoke_op(proc, "read", [["r", k, None] for k, _ in pairs]),
            pkg.ok_op(proc, "read", v)]


def lf_write(pkg, proc, k):
    v = [["w", k, 1]]
    return [pkg.invoke_op(proc, "write", v), pkg.ok_op(proc, "write", v)]


def test_long_fork_classic_anomaly(pkg):
    h = pkg.History(
        lf_write(pkg, 0, 0)
        + lf_write(pkg, 1, 1)
        + lf_read(pkg, 2, [(0, None), (1, 1)])
        + lf_read(pkg, 3, [(0, 1), (1, None)])
    )
    r = pkg.LongForkChecker(2).check({}, h)
    assert r["valid?"] is False
    assert len(r["forks"]) == 1


def test_long_fork_valid_progression(pkg):
    h = pkg.History(
        lf_write(pkg, 0, 0)
        + lf_read(pkg, 1, [(0, None), (1, None)])
        + lf_read(pkg, 2, [(0, 1), (1, None)])
        + lf_write(pkg, 1, 1)
        + lf_read(pkg, 3, [(0, 1), (1, 1)])
    )
    r = pkg.LongForkChecker(2).check({}, h)
    assert r["valid?"] is True
    assert r["reads_count"] == 3
    assert r["early_read_count"] == 1
    assert r["late_read_count"] == 1


def test_long_fork_multiple_writes_unknown(pkg):
    h = pkg.History(lf_write(pkg, 0, 0) + lf_write(pkg, 1, 0))
    r = pkg.LongForkChecker(2).check({}, h)
    assert r["valid?"] == "unknown"
    assert r["error"][0] == "multiple-writes"


def test_long_fork_runtime_honest_client_valid(pkg):
    _, h = _runtime("long_fork", n_ops=150, seed=3, concurrency=4)
    r = pkg.LongForkChecker(2).check({}, _as(pkg, h))
    assert r["valid?"] is True
    assert r["reads_count"] > 5


def test_long_fork_runtime_forked_replicas_caught(pkg):
    _, h = _runtime("long_fork", n_ops=300, seed=4, forked=True,
                    concurrency=4)
    r = pkg.LongForkChecker(2).check({}, _as(pkg, h))
    assert r["valid?"] is False
    assert r["forks"]


def test_g2_two_ok_inserts_invalid(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = pkg.History([
        i(0, "insert", (5, (1, None))), o(0, "insert", (5, (1, None))),
        i(1, "insert", (5, (None, 2))), o(1, "insert", (5, (None, 2))),
    ])
    r = pkg.G2Checker().check({}, h)
    assert r["valid?"] is False
    assert r["illegal"] == {5: 2}


def test_g2_one_ok_insert_valid(pkg):
    i, o = pkg.invoke_op, pkg.ok_op
    h = pkg.History([
        i(0, "insert", (5, (1, None))), o(0, "insert", (5, (1, None))),
        i(1, "insert", (5, (None, 2))),
        i(1, "insert", (5, (None, 2))).with_(type="fail"),
    ])
    r = pkg.G2Checker().check({}, h)
    assert r["valid?"] is True
    assert r["key_count"] == 1


def test_g2_runtime_serializable_valid(pkg):
    _, h = _runtime("adya", n_keys=10, serializable=True, concurrency=4)
    r = pkg.G2Checker().check({}, _as(pkg, h))
    assert r["valid?"] is True
    assert r["key_count"] == 10


def test_g2_runtime_weak_predicates_caught(pkg):
    _, h = _runtime("adya", n_keys=15, serializable=False, concurrency=4)
    r = pkg.G2Checker().check({}, _as(pkg, h))
    assert r["valid?"] is False
    assert r["illegal_count"] >= 1


def test_bank_device_host_parity(pkg):
    h = r_sim.gen_bank_history(random.Random(8), n_ops=400, torn=True)
    test = {"accounts": list(range(8)), "total_amount": 100}
    a = pkg.BankChecker(force_device=False).check(test, _as(pkg, h))
    b = pkg.BankChecker(force_device=True).check(test, _as(pkg, h))
    assert a == b
    assert a["valid?"] is False


# -- the generators ---------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("gen_bank_history", dict(n_ops=300)),
    ("gen_bank_history", dict(n_ops=300, n_accounts=5, total=77,
                              torn=True)),
    ("gen_long_fork_history", dict(n_groups=6, ops_per_group=40)),
    ("gen_long_fork_history", dict(n_groups=8, ops_per_group=30, n=3,
                                   forked=True)),
    ("gen_g2_history", dict(n_keys=60)),
    ("gen_g2_history", dict(n_keys=200, weak=True)),
], ids=lambda x: x if isinstance(x, str) else "-".join(map(str, x.values())))
def test_generators_match_reference(name, kw):
    """For the same Random(seed) the port's generator yields the
    reference's ops, field by field."""
    for seed in (1, 2):
        want = getattr(r_sim, name)(random.Random(seed), **kw)
        got = getattr(t_sim, name)(random.Random(seed), **kw)
        assert got.to_dicts() == want.to_dicts()


# -- seeded differentials ----------------------------------------------------


@pytest.mark.parametrize("force", [False, True], ids=["numpy", "device"])
@pytest.mark.parametrize("seed,kw", [
    (31, dict(n_ops=600)),
    (32, dict(n_ops=600, torn=True)),
    (33, dict(n_ops=400, n_accounts=3, total=10, max_transfer=4)),
])
def test_bank_matches_reference(seed, kw, force):
    """The same plane through both checkers (encoded once by the
    reference, carried across), and the port's own encode of its own
    generator's history: one result dict."""
    test = {"accounts": list(range(kw.get("n_accounts", 8))),
            "total_amount": kw.get("total", 100)}
    h = r_sim.gen_bank_history(random.Random(seed), **kw)
    plane = r_bank.BankChecker.encode(test, h)
    want = r_bank.BankChecker(force_device=force).check(test, plane)
    chk = t_bank.BankChecker(force_device=force, device="cpu")
    assert chk.check(test, convert.from_reference(plane)) == want
    th = t_sim.gen_bank_history(random.Random(seed), **kw)
    tplane = t_bank.BankChecker.encode(test, th)
    np.testing.assert_array_equal(tplane.bal, plane.bal)
    assert chk.check(test, tplane) == want
    assert want["valid?"] is not kw.get("torn", False)


def test_bank_reduce_torch_equals_numpy():
    """The torch reduction against the numpy one on the same [R, A]
    float32 matrix, nil, negative and padding rows included: the four
    rows equal bit for bit, the sums kept in float32."""
    rng = np.random.default_rng(3)
    bal = rng.integers(-3, 30, (300, 8)).astype(np.float32)
    bal[rng.random((300, 8)) < 0.02] = np.nan
    bal[250:] = np.nan
    want = t_bank._bank_reduce(bal, 100.0, torch.device("cpu"), False)
    got = t_bank.bank_reduce_torch(torch.from_numpy(bal), 100.0)
    assert got.dtype == torch.float32 and got.shape == (4, 300)
    got = got.numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i] > 0.5, want[i])
    np.testing.assert_array_equal(got[3], want[3])


def test_bank_device_route_fetches_once():
    h = t_sim.gen_bank_history(random.Random(34), n_ops=200)
    test = {"accounts": list(range(8)), "total_amount": 100}
    reset_launch_stats()
    t_bank.BankChecker(device="cpu").check(test, h)
    assert launch_stats_snapshot()["host_syncs"] == 0
    t_bank.BankChecker(device="cpu", force_device=True).check(test, h)
    assert launch_stats_snapshot()["host_syncs"] == 1


@pytest.mark.parametrize("seed,kw", [
    (41, dict(n_groups=12, ops_per_group=48)),
    (42, dict(n_groups=12, ops_per_group=48, forked=True)),
    (43, dict(n_groups=10, ops_per_group=40, n=3, forked=True)),
])
def test_long_fork_matches_reference(seed, kw):
    """The port's torch product on the CPU against the reference's jit:
    one result dict, one launch and one fetch in the port's ledgers,
    as the reference counts its own."""
    h = r_sim.gen_long_fork_history(random.Random(seed), **kw)
    n = kw.get("n", 2)
    want = r_lf.LongForkChecker(n).check({}, h)
    reset_launch_stats()
    before = dict(t_dp.DISPATCH_STATS)
    got = t_lf.LongForkChecker(n, device="cpu").check({}, _as(PKGS["port"],
                                                            h))
    assert got == want
    stats = launch_stats_snapshot()
    assert (stats["launches"], stats["host_syncs"]) == (1, 1)
    assert t_dp.DISPATCH_STATS["requests"] == before["requests"] + 1
    assert t_dp.DISPATCH_STATS["solo_launches"] == \
        before["solo_launches"] + 1
    if kw.get("forked"):
        assert want["valid?"] is False and want["forks"]


def test_fork_pairs_torch_equals_numpy_product():
    """fork_pairs_torch against the product written out in numpy, on
    random presence matrices with dead padding rows."""
    rng = np.random.default_rng(5)
    V = (rng.random((7, 8, 3)) < 0.5).astype(np.float32)
    live = rng.random((7, 8)) < 0.8
    missed = np.einsum("grk,gsk->grs", V, 1 - V) > 0.5
    want = missed & missed.transpose(0, 2, 1) & live[:, :, None] & \
        live[:, None, :]
    got = t_lf.fork_pairs_torch(torch.from_numpy(V), torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), want)


def test_long_fork_unknown_verdicts_match_reference():
    """A read of the wrong group size and two distinct values of one
    key: the reference's unknown verdicts, with no launch."""
    i, o = t_ops.invoke_op, t_ops.ok_op
    wrong = [i(0, "read", [["r", 0, None]]), o(0, "read", [["r", 0, 1]])]
    distinct = [i(0, "read", [["r", 0, None], ["r", 1, None]]),
                o(0, "read", [["r", 0, 1], ["r", 1, None]]),
                i(1, "read", [["r", 0, None], ["r", 1, None]]),
                o(1, "read", [["r", 0, 2], ["r", 1, None]])]
    for ops in (wrong, distinct):
        h = t_hist.History(ops)
        reset_launch_stats()
        got = t_lf.LongForkChecker(2, device="cpu").check({}, h)
        want = r_lf.LongForkChecker(2).check({}, r_hist.History(
            h.to_dicts(), indexed=True))
        assert got == want and got["valid?"] == "unknown"
        assert launch_stats_snapshot()["launches"] == 0


@pytest.mark.parametrize("seed,kw", [
    (51, dict(n_keys=300)),
    (52, dict(n_keys=300, weak=True)),
])
def test_g2_matches_reference(seed, kw):
    h = r_sim.gen_g2_history(random.Random(seed), **kw)
    plane = r_adya.G2Checker.encode(h)
    want = r_adya.G2Checker().check({}, plane)
    assert t_adya.G2Checker().check({}, convert.from_reference(plane)) == \
        want
    th = t_sim.gen_g2_history(random.Random(seed), **kw)
    assert t_adya.G2Checker().check({}, th) == want
    assert t_adya.G2Checker().check({}, th.to_dicts()) == want
    assert want["valid?"] is not kw.get("weak", False)


def test_g2_mixed_keys_and_empty_match_reference():
    i, o = t_ops.invoke_op, t_ops.ok_op
    ops = []
    for k in (3, "a", 1.5, (1, 2), "b"):
        for side in (0, 1):
            v = (k, (1, None) if side == 0 else (None, 2))
            ops += [i(side, "insert", v), o(side, "insert", v)]
    h = t_hist.History(ops)
    want = r_adya.G2Checker().check({}, r_hist.History(h.to_dicts(),
                                                       indexed=True))
    assert t_adya.G2Checker().check({}, h) == want
    assert list(want["illegal"]) == [1.5, 3, "a", "b", (1, 2)]
    assert t_adya.G2Checker().check({}, t_hist.History([])) == \
        r_adya.G2Checker().check({}, r_hist.History([]))


def test_g2_txn_history_raises_until_the_graph_is_ported():
    """A micro-op txn history takes the reference's dependency-graph
    route; the port raises NotImplementedError there rather than answer
    from the two-insert count."""
    i, o = t_ops.invoke_op, t_ops.ok_op
    h = t_hist.History([
        i(0, "txn", [["r", "x", None], ["w", "y", 1]]),
        o(0, "txn", [["r", "x", None], ["w", "y", 1]]),
        i(1, "txn", [["r", "y", None], ["w", "x", 1]]),
        o(1, "txn", [["r", "y", None], ["w", "x", 1]]),
    ])
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        t_adya.G2Checker().check({}, h)
    from jepsen_tpu.checker.txn_graph import is_txn_value

    for v in ([["r", "x", None]], [("append", 1, 2)], [], [["q", 1, 2]],
              [["r", 1]], "rw", None, [["w", 1, 2], 3]):
        assert t_adya.is_txn_value(v) == is_txn_value(v)


def test_factories():
    assert t_bank.bank_checker(True).negative_balances is True
    assert t_bank.bank_checker().device is None
    assert t_lf.long_fork_checker(3, device="cpu").n == 3
    assert isinstance(t_adya.g2_checker(), t_adya.G2Checker)
