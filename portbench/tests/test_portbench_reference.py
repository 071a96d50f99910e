"""The plain reference: every known answer, brute force on tiny
histories, the port's host oracle on larger ones; the control, which
the harness's own comparison fails; and the refusal of a control that
the configuration does not list."""

import os
import random
import subprocess
import sys

import pytest

from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker.events import history_to_events
from jepsen_tpu_torch.checker.wgl_oracle import check_events
from jepsen_tpu_torch.history.history import History
from portbench.gen import keyed
from portbench.reference import cas_register
from portbench.tests._tiny import config, control_readings, tiny_checkout
from portbench.tests.conftest import ROOT


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
    assert cas_register.check(ops)["valid?"] == \
        cas_register.check_brute(ops)


@pytest.mark.parametrize("seed", range(6))
def test_reference_matches_the_host_oracle(seed):
    ops = _history(seed, 600, 6, 4, 0.01, seed % 2)
    valid, stats = check_events(
        history_to_events(History(ops), model="cas-register"),
        return_stats=True)
    r = cas_register.check(ops)
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
        v = cas_register.verdict(it)
        assert v["valid"] and all(f is None for _, f in v["failed"])
        assert len(v["failed"]) == cfg["keys"]
    for (h, k, _frac), it in zip(tr["corrupt"], corrupted):
        v = cas_register.verdict(it)
        src = cas_register.split_keys(valid[h]["ops"])[k]
        sub = cas_register.split_keys(it["ops"])[k]
        at = [i for i, (a, b) in enumerate(zip(src, sub)) if a != b]
        assert not v["valid"]
        assert [[kk, f] for kk, f in v["failed"] if f is not None] == \
            [[k, at[0]]]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tmp_path, seed):
    """The control that etcd-keyed lists, `crashed`, found by its name
    and put in the program's place, through the harness's run and its
    comparison at the tests' size: `correct` comes out false."""
    root = tiny_checkout(tmp_path)
    res = control_readings(root, "keyed-independent", "crashed", seed=seed,
                           seconds=2.0)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


def test_a_control_the_configuration_does_not_list_is_refused(tmp_path):
    """By name in the harness, and by the command line before any run,
    with the configuration's list in the message."""
    root = tiny_checkout(tmp_path)
    with pytest.raises(LookupError, match=r"\['crashed'\], not 'fail-ok'"):
        control_readings(root, "keyed-independent", "fail-ok")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.control", "--workload",
         "register-clean", "--control", "crashed", "--seconds", "1",
         "--seeds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 2, p.stderr
    assert "['fail-ok'], not 'crashed'" in p.stderr
    assert p.stdout == ""
