"""The slice end to end: the port's linearizability check
(jepsen_tpu_torch.checker.linearizable, on the CPU through the kernels'
plain versions) against the JAX package's (bitset tier in interpret
mode, no native racer) on seeded histories: valid and invalid,
crash-free and crash-heavy, inside the bitset envelope and on the
K-frontier ladder (windows 24 and 36, beyond the bitset's 19).

Every verdict field must be equal. The method names map tpu-* to gpu-*
and any cpu-oracle-* to cpu-oracle-python (the port has the Python
oracle only); on the ladder's single-word rungs the port runs its
K-frontier kernel (gpu-wgl-kfrontier) where the reference on the CPU
runs its multi-word scan (tpu-wgl), so the method may differ there."""

import importlib
import random

import pytest
import torch

from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import linearizable as t_lin
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats
from jepsen_tpu_torch.history.history import History as THistory

r_lin = importlib.import_module("jepsen_tpu.checker.linearizable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one intra-op thread keeps
    torch's pool from oversubscribing the cores under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


METHOD = {
    "tpu-wgl-bitset": "gpu-wgl-bitset",
    "tpu-wgl": "gpu-wgl",
    "tpu-wgl-pallas": "gpu-wgl-kfrontier",
    "cpu-oracle-native": "cpu-oracle-python",
    "cpu-oracle-python": "cpu-oracle-python",
}


def _register(seed, n_ops, n_procs, p_crash, corrupt):
    h = gen_register_history(random.Random(seed), n_ops=n_ops,
                             n_procs=n_procs, p_crash=p_crash)
    if corrupt:
        h = corrupt_history(h, random.Random(seed))
    return h.to_dicts()


def _counter(corrupt, n_procs=24):
    h = t_sim.gen_cas_counter_history(random.Random(31), n_rounds=2,
                                      n_procs=n_procs)
    if corrupt:
        h = t_sim.corrupt_history(h, random.Random(32),
                                  n_values=n_procs + 1)
    return h.to_dicts()


#: id -> (history op dicts factory, the port's expected method)
CASES = {
    "valid": (lambda: _register(50, 50, 5, 0.0, False), "gpu-wgl-bitset"),
    "invalid": (lambda: _register(51, 50, 5, 0.0, True), "gpu-wgl-bitset"),
    "crashy": (lambda: _register(35, 50, 4, 0.15, False), "gpu-wgl-bitset"),
    "crashy-invalid": (lambda: _register(37, 50, 4, 0.15, True),
                       "gpu-wgl-bitset"),
    "crash-heavy": (lambda: _register(30, 45, 3, 0.2, False),
                    "gpu-wgl-bitset"),
    "crash-heavy-invalid": (lambda: _register(31, 45, 3, 0.2, True),
                            "gpu-wgl-bitset"),
    "ladder": (lambda: _counter(False), "gpu-wgl-kfrontier"),
    "ladder-invalid": (lambda: _counter(True), "gpu-wgl-kfrontier"),
    # window 36: two mask words, the multi-word torch scan's rung
    "ladder-two-words-invalid": (lambda: _counter(True, 36), "gpu-wgl"),
}


def _reference(ops):
    from jepsen_tpu.history.history import History

    ev = r_ev.history_to_events(History(ops))
    out = r_lin.check_events_bucketed(ev, interpret=True, race=False)
    r_lin._harvest_failure(ev, out, "cas-register")
    return ev, out


@pytest.mark.parametrize("case", list(CASES))
def test_check_matches_reference(case):
    make, method = CASES[case]
    ops = make()
    ev, want = _reference(ops)
    if case in ("ladder", "ladder-invalid"):
        assert 20 <= ev.window <= 32  # beyond the bitset's 19 slots

    reset_launch_stats()
    tev = t_ev.history_to_events(THistory(ops))
    got = t_lin.check_events_bucketed(tev, device="cpu")
    t_lin._harvest_failure(tev, got, "cas-register")
    if method is not None:
        assert got["method"] == method
    if got["method"] == "gpu-wgl-bitset":
        assert launch_stats_snapshot()["host_syncs"] == (
            1 if got["valid?"] else 2)
    mapped = METHOD[want["method"]]
    if not (got["method"] == "gpu-wgl-kfrontier" and mapped == "gpu-wgl"):
        assert got["method"] == mapped
    assert {k: v for k, v in got.items() if k != "method"} == {
        k: v for k, v in want.items() if k != "method"}

    # the checker's entry point returns the same verdict fields
    out = t_lin.LinearizableChecker(device="cpu").check(None, ops)
    for k in ("valid?", "failed_op_index", "failure", "method"):
        assert out.get(k) == got.get(k), k
    assert out["n_ops"] == ev.n_ops and out["window"] == ev.window
    if "invalid" not in case:
        assert out["valid?"] is True  # valid by construction


def test_window_overflow_goes_to_the_oracle():
    """A window past the masks' 128 slots (a 130-client contended
    counter): the oracle decides, as in the reference's WindowOverflow
    branch."""
    h = t_sim.gen_cas_counter_history(random.Random(3), n_rounds=1,
                                      n_procs=130)
    ops = t_sim.corrupt_history(h, random.Random(4), n_values=131).to_dicts()
    want = r_lin.LinearizableChecker(interpret=True, sentry=False).check(
        None, ops)
    out = t_lin.LinearizableChecker(device="cpu").check(None, ops)
    assert out["method"] == "cpu-oracle-python"
    assert METHOD[want["method"]] == out["method"]
    for k in ("valid?", "failed_op_index", "failure", "n_ops", "window"):
        assert out.get(k) == want.get(k), k
    assert out["valid?"] is False and out["window"] == 130
