"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the program's plain kernels on
the CPU, one fault at a time in each cell that can have it."""

import pytest
import torch

from portbench.tests._tiny import run, tiny_checkout

CELLS = ["keyed-independent"]


def _state_unchanged(monkeypatch):
    """Every scan returns its input frontier and alive: a step that
    leaves its state as it was."""
    from jepsen_tpu_torch.checker import wgl_bitset as bs

    def scan(win, meta, fr_in, *a, **k):
        out = torch.zeros((win.shape[0], 1, bs.OUT_COLS), dtype=torch.int32,
                          device=win.device)
        out[:, 0, 0] = 1
        out[:, 0, 2] = -1
        return out, fr_in.clone()

    monkeypatch.setattr(bs, "bitset_scan", scan)


def _answer_altered(monkeypatch):
    """An invalid verdict names the op after the one that failed."""
    from jepsen_tpu_torch.checker import dispatch, linearizable

    orig = linearizable._bitset_verdict

    def altered(events, steps, alive, died, model):
        out = orig(events, steps, alive, died, model)
        if out.get("valid?") is False:
            out["failed_op_index"] += 1
        return out

    monkeypatch.setattr(linearizable, "_bitset_verdict", altered)
    monkeypatch.setattr(dispatch, "_bitset_verdict", altered)


def _half_the_keys(monkeypatch):
    """IndependentChecker checks half of a history's keys."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.history.history import History

    orig = independent.IndependentChecker.check

    def half(self, test, history, opts=None):
        h = history if isinstance(history, History) else History(
            list(history))
        keep = [o for o in h.ops if getattr(o.value, "key", 0) % 2 == 0]
        return orig(self, test, History(keep), opts)

    monkeypatch.setattr(independent.IndependentChecker, "check", half)


FAULTS = {
    "state_unchanged": (_state_unchanged, CELLS),
    "answer_altered": (_answer_altered, CELLS),
    "half_the_keys": (_half_the_keys, CELLS),
}


@pytest.mark.parametrize("fault,workload", [
    (f, w) for f, (_, cells) in FAULTS.items() for w in cells])
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault,
                                      workload):
    root = tiny_checkout(tmp_path)
    FAULTS[fault][0](monkeypatch)
    res = run(root, workload, seconds=1.5)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]
