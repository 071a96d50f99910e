"""The per-value queue check of the port
(jepsen_tpu_torch.checker.linearizable: split_queue_history_by_value,
check_queue_by_value and the unordered-queue route of
LinearizableChecker.check) against the JAX package's, on the CPU.

The route is a repair: before it, the port checked an unordered-queue
history as one joint stream, which outside the packed envelope (more
than 7 values) fell to the tuple-multiset Python oracle and returned its
verdict dict (another method, no n_values, no failed_value), where the
reference answers with one batched pass over the per-value substreams.

The reference runs with mesh=False and without its history sentry (the
port has none yet). On the CPU the reference's batch tier is its vmap
scan (tpu-wgl-batch) where the port's is kernel B's plain version
(gpu-wgl-kfrontier-batch), so inside the per-value method the tier name
may differ; every other field must be equal. Tolerance: exact."""

import importlib
import random

import pytest
import torch

from jepsen_tpu.history.history import History as RHistory

from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import linearizable as t_lin
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats
from jepsen_tpu_torch.history.history import History as THistory
from jepsen_tpu_torch.history.ops import invoke_op, ok_op

r_lin = importlib.import_module("jepsen_tpu.checker.linearizable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference's per-value tier names on the CPU -> the port's
TIERS = {
    "tpu-wgl-batch": "gpu-wgl-kfrontier-batch",
    "tpu-wgl-bitset-batch": "gpu-wgl-bitset-batch",
    "cpu-oracle-native": "cpu-oracle-native",
    "cpu-oracle-python": "cpu-oracle-python",
}


def _per_value(method: str) -> dict:
    assert method.startswith("per-value:"), method
    out = {}
    for part in method[len("per-value:"):].split(","):
        name, n = part.rsplit("x", 1)
        out[name] = int(n)
    return out


def _compare(got, want):
    assert want is not None and got is not None
    w_tiers = {TIERS[k]: n for k, n in _per_value(want["method"]).items()}
    assert _per_value(got["method"]) == w_tiers
    for k in ("valid?", "n_values", "failed_value", "failed_op_index",
              "escalations", "frontier_k"):
        assert got.get(k) == want.get(k), (k, got, want)
    assert ("failure" in got) == ("failure" in want)


def _history(seed, n_ops, n_values, bad_value=None):
    h = t_sim.gen_queue_history(random.Random(seed), n_ops=n_ops,
                                n_procs=5, n_values=n_values, p_crash=0.05)
    if bad_value is not None:
        h = t_sim.overdraw_queue_history(h, bad_value)
    return h.to_dicts()


#: id -> (seed, n_ops, n_values, overdrawn value)
CASES = {
    "valid": (500, 120, 12, None),
    "overdrawn": (501, 120, 12, 5),
    "crashy-overdrawn": (502, 90, 9, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_check_queue_by_value_matches_reference(case):
    ops = _history(*CASES[case])
    want = r_lin.check_queue_by_value(RHistory(ops), "unordered-queue",
                                      mesh=False, validate=False)
    got = t_lin.check_queue_by_value(THistory(ops), "unordered-queue",
                                     device="cpu")
    _compare(got, want)
    assert got["valid?"] is (CASES[case][3] is None)
    if not got["valid?"]:
        assert got["failed_value"] == CASES[case][3]


@pytest.mark.parametrize("bad", [None, 7], ids=["valid", "overdrawn"])
def test_checker_routes_queues_by_value(bad):
    """LinearizableChecker("unordered-queue").check: a history of 16
    values (past the joint packed envelope's 7) takes the per-value
    batch, kernel B once for all substreams, with the reference's
    valid?, n_values, failed_value and failed_op_index."""
    ops = _history(510, 200, 16, bad)
    want = r_lin.LinearizableChecker(
        model="unordered-queue", mesh=False, sentry=False,
    ).check(None, RHistory(ops))
    reset_launch_stats()
    got = t_lin.LinearizableChecker("unordered-queue", device="cpu").check(
        None, ops)
    _compare(got, want)
    assert got["n_values"] == 16
    assert _per_value(got["method"]) == {"gpu-wgl-kfrontier-batch": 16}
    assert got["n_ops"] == want["n_ops"] == len(ops)
    # one fetch for the batch; an invalid value's report adds its own
    # single-stream re-check
    assert launch_stats_snapshot()["host_syncs"] == (1 if bad is None else 2)


def test_drain_and_overlap_split_matches_reference():
    """Drains expand into per-value dequeues over the drain's interval,
    and every op keeps its real-time position: the same substreams (op
    by op) and verdicts as the reference."""
    histories = {
        "drain": [invoke_op(0, "enqueue", 1), ok_op(0, "enqueue", 1),
                  invoke_op(1, "enqueue", 2), ok_op(1, "enqueue", 2),
                  invoke_op(2, "drain"), ok_op(2, "drain", [1, 2])],
        "drain-phantom": [invoke_op(0, "enqueue", 1),
                          ok_op(0, "enqueue", 1),
                          invoke_op(2, "drain"), ok_op(2, "drain", [1, 7])],
        "overlap": [invoke_op(1, "dequeue"), invoke_op(0, "enqueue", 5),
                    ok_op(0, "enqueue", 5), ok_op(1, "dequeue", 5)],
        "no-overlap": [invoke_op(1, "dequeue"), ok_op(1, "dequeue", 5),
                       invoke_op(0, "enqueue", 5), ok_op(0, "enqueue", 5)],
    }
    verdicts = {}
    for name, hops in histories.items():
        ops = THistory(hops).to_dicts()
        want_subs = r_lin.split_queue_history_by_value(RHistory(ops))
        got_subs = t_lin.split_queue_history_by_value(THistory(ops))
        assert set(got_subs) == set(want_subs)
        for v in want_subs:
            assert got_subs[v].to_dicts() == want_subs[v].to_dicts(), name
        want = r_lin.check_queue_by_value(RHistory(ops), "unordered-queue",
                                          mesh=False, validate=False)
        got = t_lin.check_queue_by_value(THistory(ops), "unordered-queue",
                                         device="cpu")
        _compare(got, want)
        verdicts[name] = got["valid?"]
    assert verdicts == {"drain": True, "drain-phantom": False,
                        "overlap": True, "no-overlap": False}


def test_undecomposable_history_takes_the_joint_path():
    """A history with an op outside enqueue/dequeue does not split:
    check_queue_by_value returns None, as the reference's does, and the
    checker checks the joint stream."""
    ops = THistory([invoke_op(0, "enqueue", 1), ok_op(0, "enqueue", 1),
                    invoke_op(1, "peek"), ok_op(1, "peek", 1)]).to_dicts()
    assert r_lin.check_queue_by_value(RHistory(ops), "unordered-queue",
                                      mesh=False, validate=False) is None
    assert t_lin.check_queue_by_value(THistory(ops), "unordered-queue",
                                      device="cpu") is None
    out = t_lin.LinearizableChecker("unordered-queue", device="cpu").check(
        None, ops)
    assert not out["method"].startswith("per-value:")
