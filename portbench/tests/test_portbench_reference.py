"""The plain reference: every known answer, brute force on tiny
histories, the port's host oracle on larger ones; and the control,
which the harness's own comparison fails."""

import random

import pytest

from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker.events import history_to_events
from jepsen_tpu_torch.checker.wgl_oracle import check_events
from jepsen_tpu_torch.history.history import History
from portbench.gen import keyed
from portbench.reference import judge, wgl
from portbench.tests._tiny import config


def _plain(h):
    return [{k: getattr(o, k) for k in ("type", "f", "value", "process")}
            for o in h.ops]


def _history(seed, n_ops, n_procs, n_values, p_crash, corrupt):
    h = sim.gen_register_history(random.Random(seed), n_ops=n_ops,
                                 n_procs=n_procs, n_values=n_values,
                                 p_crash=p_crash)
    if corrupt:
        h = sim.corrupt_history(h, random.Random(seed), n_values)
    return _plain(h)


@pytest.mark.parametrize("seed", range(40))
def test_reference_matches_brute_force(seed):
    ops = _history(seed, 6, 3, 3, 0.2, seed % 2)
    assert wgl.check(ops)["valid?"] == wgl.check_brute(ops)


@pytest.mark.parametrize("seed", range(6))
def test_reference_matches_the_host_oracle(seed):
    ops = _history(seed, 600, 6, 4, 0.01, seed % 2)
    valid, stats = check_events(
        history_to_events(History(ops), model="cas-register"),
        return_stats=True)
    r = wgl.check(ops)
    assert r["valid?"] == valid
    assert r["failed_op_index"] == stats["failed_op_index"]


def test_reference_gives_every_known_answer():
    """The etcd runs are valid by construction; each corrupted copy
    fails at its key alone, at the read turned to nil."""
    cfg = config(keys=16, ops_per_key=300, nemesis_interval_s=10.0,
                 timeout_s=5.0, election_s=1.0)
    tr = {"pool": 2, "corrupt": [[0, 0, 0.3], [1, 5, 0.5], [0, 10, 0.7],
                                 [1, 15, 0.9]]}
    valid, corrupted = keyed.build_pool(cfg, tr, 77)
    for it in valid:
        v = judge.verdict(it)
        assert v["valid"] and all(f is None for _, f in v["failed"])
        assert len(v["failed"]) == cfg["keys"]
    for (h, k, _frac), it in zip(tr["corrupt"], corrupted):
        v = judge.verdict(it)
        src = wgl.split_keys(valid[h]["ops"])[k]
        sub = wgl.split_keys(it["ops"])[k]
        at = [i for i, (a, b) in enumerate(zip(src, sub)) if a != b]
        assert not v["valid"]
        assert [[kk, f] for kk, f in v["failed"] if f is not None] == \
            [[k, at[0]]]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tmp_path, seed):
    """The control in the program's place, through the harness's run
    and its comparison at the tests' size: `correct` comes out false."""
    from portbench import control
    from portbench.tests._tiny import run, tiny_checkout

    root = tiny_checkout(tmp_path)
    res = run(root, "keyed-independent", seed=seed, seconds=2.0,
              entry=control.ControlEntry)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]
