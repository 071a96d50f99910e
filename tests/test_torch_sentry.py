"""The port's history sentry (jepsen_tpu_torch.history.sentry) against
the JAX package's, on the CPU.

One corrupt history per corruption class of the reference's
CORRUPTION_CLASSES, built the same way with each package's own ops:

- validate_history gives the same report (detected classes, repairs,
  quarantined indices, counts) and the same repaired ops in both;
- strict mode raises HistorySentryError naming the class in both;
- the repaired history checks like the hand-cleaned one;
- LinearizableChecker(device="cpu") and the reference's default
  LinearizableChecker(interpret=True) (sentry on) give the same
  valid?, failed_op_index and history_report, and strict_history
  raises in both; check_queue_by_value validates by default.

Tolerance: exact equality. Every history here is a few ops: the
reference's interpret-mode bitset kernel compiles one 64-step shape.
"""

import types

import pytest
import torch

from jepsen_tpu.checker.linearizable import (
    LinearizableChecker as RefChecker,
    check_queue_by_value as ref_check_queue_by_value,
)
from jepsen_tpu.history import history as r_history
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.history import sentry as r_sentry

from jepsen_tpu_torch.checker.linearizable import (
    LinearizableChecker,
    check_queue_by_value,
)
from jepsen_tpu_torch.history import history as t_history
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history import sentry as t_sentry
from jepsen_tpu_torch.history.sentry import (
    CORRUPTION_CLASSES,
    HistorySentryError,
    validate_history,
)

REF = types.SimpleNamespace(ops=r_ops, History=r_history.History)
PORT = types.SimpleNamespace(ops=t_ops, History=t_history.History)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean_ops(ns, t0=0.0):
    """A well-formed concurrent register history: the base every
    corruption case mutates."""
    o = ns.ops
    ops = [
        o.invoke_op(0, "write", 1),
        o.invoke_op(1, "read"),
        o.ok_op(0, "write", 1),
        o.ok_op(1, "read", 1),
        o.invoke_op(0, "cas", [1, 2]),
        o.ok_op(0, "cas", [1, 2]),
        o.invoke_op(1, "read"),
        o.ok_op(1, "read", 2),
    ]
    return [op.with_(time=t0 + i) for i, op in enumerate(ops)]


# -- corruption cases: (corrupt ops, hand-cleaned ops) ----------------


def _case_duplicate_index(ns):
    ops = ns.History(_clean_ops(ns)).ops
    bad = list(ops)
    bad[3] = bad[3].with_(index=bad[2].index)
    return bad, ops


def _case_missing_index(ns):
    ops = ns.History(_clean_ops(ns)).ops
    bad = list(ops)
    bad[5] = bad[5].with_(index=-1)
    return bad, ops


def _case_orphan_completion(ns):
    ops = _clean_ops(ns)
    bad = list(ops)
    bad.insert(4, ns.ops.ok_op(7, "read", 9).with_(time=3.5))
    return bad, ops


def _case_double_completion(ns):
    ops = _clean_ops(ns)
    bad = list(ops)
    bad.insert(4, ns.ops.ok_op(1, "read", 1).with_(time=3.5))
    return bad, ops


def _case_inversion(ns):
    ops = _clean_ops(ns)
    bad = list(ops)
    bad[4], bad[5] = bad[5], bad[4]
    return bad, ops


def _case_unpaired_info(ns):
    ops = _clean_ops(ns)
    bad = list(ops)
    bad.append(ns.ops.info_op(3, "write", 5).with_(time=9.0))
    return bad, ops


def _case_non_monotone_time(ns):
    ops = _clean_ops(ns)
    bad = list(ops)
    bad[5] = bad[5].with_(time=0.5)
    good = list(ops)
    good[5] = good[5].with_(time=good[4].time)
    return bad, good


def _case_nemesis_interleaved(ns):
    o = ns.ops
    ops = _clean_ops(ns)
    bad = list(ops)
    bad.insert(0, o.invoke_op("nemesis", "start").with_(time=-1.0))
    bad.insert(1, o.ok_op("nemesis", "start").with_(time=-0.5))
    bad.insert(4, o.invoke_op(5, "start").with_(time=2.5))
    good = list(ops)
    good.insert(0, o.invoke_op("nemesis", "start").with_(time=-1.0))
    good.insert(1, o.ok_op("nemesis", "start").with_(time=-0.5))
    return bad, good


_CASES = {
    "duplicate_index": _case_duplicate_index,
    "missing_index": _case_missing_index,
    "orphan_completion": _case_orphan_completion,
    "double_completion": _case_double_completion,
    "inversion": _case_inversion,
    "unpaired_info": _case_unpaired_info,
    "non_monotone_time": _case_non_monotone_time,
    "nemesis_interleaved": _case_nemesis_interleaved,
}


def _pair(cls):
    """The corrupt history of class cls in both packages."""
    return (REF.History(_CASES[cls](REF)[0], indexed=True),
            PORT.History(_CASES[cls](PORT)[0], indexed=True))


def _verdict(h):
    out = LinearizableChecker(device="cpu", sentry=False).check(None, h)
    return (out["valid?"], out.get("failed_op_index"))


def test_every_corruption_class_has_a_case():
    assert CORRUPTION_CLASSES == r_sentry.CORRUPTION_CLASSES
    assert set(_CASES) == set(CORRUPTION_CLASSES)


@pytest.mark.parametrize("cls", CORRUPTION_CLASSES)
def test_report_and_repair_match_reference(cls):
    ref_h, port_h = _pair(cls)
    r_fixed, r_report = r_sentry.validate_history(ref_h)
    t_fixed, t_report = validate_history(port_h)
    assert t_report == r_report
    assert not t_report["clean"]
    assert cls in t_report["detected"] and cls in t_report["repairs"]
    assert "residue" not in t_report
    assert [o.to_dict() for o in t_fixed.ops] == [
        o.to_dict() for o in r_fixed.ops
    ]
    assert t_sentry.scan_history(port_h) == r_sentry.scan_history(ref_h)


@pytest.mark.parametrize("cls", CORRUPTION_CLASSES)
def test_strict_mode_raises_naming_the_class(cls):
    _, port_h = _pair(cls)
    with pytest.raises(HistorySentryError) as ei:
        validate_history(port_h, strict=True)
    assert cls in ei.value.classes
    assert cls in str(ei.value)


@pytest.mark.parametrize("cls", CORRUPTION_CLASSES)
def test_repaired_checks_like_hand_cleaned(cls):
    bad, good = _CASES[cls](PORT)
    fixed, report = validate_history(PORT.History(bad, indexed=True))
    assert not report["clean"]
    assert _verdict(fixed) == _verdict(PORT.History(good))


@pytest.mark.parametrize("cls", CORRUPTION_CLASSES)
def test_checker_matches_reference_checker(cls):
    """The port's checker (sentry on by default) against the
    reference's default checker in interpret mode: same verdict,
    failed_op_index and history_report for every corruption class."""
    ref_h, port_h = _pair(cls)
    want = RefChecker(interpret=True).check({}, ref_h)
    got = LinearizableChecker(device="cpu").check(None, port_h)
    for k in ("valid?", "failed_op_index", "history_report"):
        assert got.get(k) == want.get(k), (k, got, want)
    assert got["history_report"]["clean"] is False


@pytest.mark.parametrize("cls", ("double_completion", "inversion"))
def test_checker_strict_mode_raises_in_both(cls):
    ref_h, port_h = _pair(cls)
    with pytest.raises(r_sentry.HistorySentryError):
        RefChecker(interpret=True, strict_history=True).check({}, ref_h)
    with pytest.raises(HistorySentryError):
        LinearizableChecker(device="cpu", strict_history=True).check(
            None, port_h)


def test_clean_history_is_zero_copy():
    h = PORT.History(_clean_ops(PORT))
    out, report = validate_history(h)
    assert out is h
    assert report == {"clean": True, "repairs": {}, "quarantined": []}


def test_cross_process_time_jitter_is_healthy():
    o = PORT.ops
    ops = [
        o.invoke_op(0, "write", 1).with_(time=1.0),
        o.invoke_op(1, "read").with_(time=0.9),
        o.ok_op(0, "write", 1).with_(time=2.0),
        o.ok_op(1, "read", 1).with_(time=1.5),
    ]
    _, report = validate_history(PORT.History(ops))
    assert report["clean"]


def test_quarantine_lands_in_report_not_silence():
    _, port_h = _pair("orphan_completion")
    _, report = validate_history(port_h)
    assert len(report["quarantined"]) == 1
    assert report["n_out"] == report["n_in"] - 1


def test_reindex_preserves_original_indices():
    _, port_h = _pair("duplicate_index")
    fixed, _ = validate_history(port_h)
    assert [o.index for o in fixed.ops] == list(range(len(fixed)))
    assert any(o.extra.get("orig_index") is not None for o in fixed.ops)


@pytest.mark.parametrize("kind", ("crashed", "failed"))
def test_crash_and_fail_semantics_are_not_corruption(kind):
    o = PORT.ops
    if kind == "crashed":
        ops = [
            o.invoke_op(0, "write", 1).with_(time=0.0),
            o.info_op(0, "write", 1).with_(time=1.0),
            o.invoke_op(1, "write", 2).with_(time=2.0),
        ]
    else:
        ops = [
            o.invoke_op(0, "cas", [9, 1]).with_(time=0.0),
            o.fail_op(0, "cas", [9, 1]).with_(time=1.0),
        ]
    _, report = validate_history(PORT.History(ops))
    assert report["clean"]


def test_compound_corruption_matches_reference():
    """Several classes at once: one repair pass converges with no
    residue, the same report as the reference's, and the result still
    checks."""
    def build(ns):
        bad = list(ns.History(_clean_ops(ns)).ops)
        bad[4], bad[5] = bad[5], bad[4]
        bad.append(ns.ops.ok_op(7, "read", 9).with_(index=len(bad),
                                                   time=9.0))
        bad[2] = bad[2].with_(index=bad[1].index)
        return ns.History(bad, indexed=True)

    fixed, report = validate_history(build(PORT))
    _, want = r_sentry.validate_history(build(REF))
    assert report == want
    assert "residue" not in report
    for cls in ("inversion", "orphan_completion", "duplicate_index"):
        assert cls in report["detected"]
    assert _verdict(fixed)[0] is True


def test_checker_clean_history_attaches_nothing():
    out = LinearizableChecker(device="cpu").check(
        None, PORT.History(_clean_ops(PORT)))
    assert "history_report" not in out


def test_sentry_off_bypasses_validation():
    bad, _ = _CASES["orphan_completion"](PORT)
    out = LinearizableChecker(device="cpu", sentry=False).check(
        None, PORT.History(bad))
    assert "history_report" not in out


def _queue_ops(ns):
    o = ns.ops
    return [
        o.invoke_op(0, "enqueue", 1).with_(time=0.0),
        o.ok_op(0, "enqueue", 1).with_(time=1.0),
        o.invoke_op(1, "dequeue").with_(time=2.0),
        o.ok_op(1, "dequeue", 1).with_(time=3.0),
        o.ok_op(9, "dequeue", 4).with_(time=4.0),  # orphan completion
    ]


def test_queue_checker_validates_by_default():
    out = check_queue_by_value(PORT.History(_queue_ops(PORT)),
                               "unordered-queue", device="cpu")
    want = ref_check_queue_by_value(REF.History(_queue_ops(REF)),
                                    "unordered-queue", mesh=False)
    assert out is not None and out["valid?"] is True
    assert out["history_report"] == want["history_report"]
    assert out["history_report"]["clean"] is False
    with pytest.raises(HistorySentryError):
        check_queue_by_value(PORT.History(_queue_ops(PORT)),
                             "unordered-queue", device="cpu", strict=True)
    checked = LinearizableChecker("unordered-queue", device="cpu").check(
        None, PORT.History(_queue_ops(PORT)))
    assert checked["history_report"] == want["history_report"]
