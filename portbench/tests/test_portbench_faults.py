"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the program's plain kernels on
the CPU, one fault at a time in every cell whose path the fault
reaches."""

import pytest
import torch

from portbench.tests._tiny import run, tiny_checkout


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


def _first_half(monkeypatch):
    """LinearizableChecker checks the first half of each history (of
    each key's, under IndependentChecker)."""
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    orig = LinearizableChecker.check

    def half(self, test, history, opts=None, checkpoint=None):
        ops = list(history)
        return orig(self, test, ops[: len(ops) // 2], opts, checkpoint)

    monkeypatch.setattr(LinearizableChecker, "check", half)


FAULTS = {
    "state_unchanged": _state_unchanged,
    "answer_altered": _answer_altered,
    "half_the_keys": _half_the_keys,
    "first_half": _first_half,
}

#: (fault, cell, the checks a window needs to meet an input that shows
#: the fault). Both mixes make every 8th check a corrupted copy. Every
#: keyed check shows half its keys left out. The first corrupted copy
#: of each mix, a read at 30 % of its key's or its history's ops, lies
#: in the first half; the second, at 50 % or 70 %, beyond it.
#: half_the_keys does not reach register-clean, whose path has no keyed
#: split; no cell spans chips, so none can leave out the exchange
#: between them.
CASES = [
    ("state_unchanged", "keyed-independent", 8),
    ("state_unchanged", "register-clean", 8),
    ("answer_altered", "keyed-independent", 8),
    ("answer_altered", "register-clean", 8),
    ("half_the_keys", "keyed-independent", 1),
    ("first_half", "keyed-independent", 16),
    ("first_half", "register-clean", 16),
]

#: a generous upper bound on a tiny check's wall on the CPU
CHECK_S = {"keyed-independent": 0.1, "register-clean": 0.75}


@pytest.mark.parametrize("fault,workload,need", CASES)
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault,
                                      workload, need):
    root = tiny_checkout(tmp_path)
    FAULTS[fault](monkeypatch)
    res = run(root, workload, seconds=max(1.5, CHECK_S[workload] * need))
    assert res["attempted"] >= need, res["attempted"]
    assert res["correct"] is False, res["checks"]
