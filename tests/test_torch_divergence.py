"""The port's host checkers that the CLI's workloads need
(checker/monotonic.py, checker/divergence.py, workloads/adya.py's
_KVG2Checker) against the JAX package's, on the CPU.

Each history is built twice from one recipe, with each package's own op
constructors (tests/test_divergence.py's and tests/test_cockroach.py's
histories, and a planted anomaly of each kind), or recorded by the
reference's runtime on its workloads (weak modes included) and carried
across through the stores' op JSON. Both checkers' results must be
equal. Tolerance: exact equality."""

import random

import pytest

from jepsen_tpu import independent as r_ind
from jepsen_tpu import store as r_store
from jepsen_tpu.checker import divergence as r_div
from jepsen_tpu.checker import monotonic as r_mono
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.workloads import adya as r_adya

from jepsen_tpu_torch import independent as t_ind
from jepsen_tpu_torch import store as t_store
from jepsen_tpu_torch.checker import divergence as t_div
from jepsen_tpu_torch.checker import monotonic as t_mono
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History as THistory
from jepsen_tpu_torch.workloads import adya as t_adya


def both(recipe):
    return (RHistory(recipe(r_ops, r_ind)), THistory(recipe(t_ops, t_ind)))


def same(r_checker, t_checker, recipe, **want):
    hr, ht = both(recipe)
    got_r = r_checker.check({}, hr)
    got_t = t_checker.check({}, ht)
    assert got_t == got_r
    for k, v in want.items():
        assert got_t[k] == v, (k, got_t)
    return got_t


# -- monotonic (tests/test_cockroach.py's histories) ----------------------


def mono(rows, adds=None):
    def recipe(o, _ind):
        ops = []
        for i, v in enumerate(adds if adds is not None
                              else [r[0] for r in rows]):
            ops.append(o.invoke_op(i % 3, "add"))
            ops.append(o.ok_op(i % 3, "add", {"val": v, "sts": 0}))
        ops.append(o.invoke_op(0, "read"))
        ops.append(o.ok_op(0, "read", [
            {"val": v, "sts": s, "proc": p} for v, s, p in rows]))
        return ops
    return recipe


def revived(o, _ind):
    return [
        o.invoke_op(0, "add"), o.ok_op(0, "add", {"val": 1, "sts": 10}),
        o.invoke_op(1, "add"), o.fail_op(1, "add", {"val": 2, "sts": 0}),
        o.invoke_op(2, "add"), o.info_op(2, "add", {"val": 3, "sts": 0}),
        o.invoke_op(0, "read"),
        o.ok_op(0, "read", [
            {"val": 1, "sts": 10, "proc": 0},
            {"val": 2, "sts": 20, "proc": 1},
            {"val": 3, "sts": 30, "proc": 2},
        ]),
    ]


def no_read(o, _ind):
    return [o.invoke_op(0, "add"), o.ok_op(0, "add", {"val": 1, "sts": 1})]


def tuple_rows(o, _ind):
    """Rows as (val, sts, proc) tuples, one duplicated, per-process
    order broken, timestamps out of order."""
    ops = []
    for v in (1, 2, 3, 4):
        ops += [o.invoke_op(v % 2, "add"), o.ok_op(v % 2, "add", v)]
    ops += [o.invoke_op(0, "read"),
            o.ok_op(0, "read", [(1, 5, 0), (3, 4, 1), (2, 6, 0),
                                (3, 7, 1), (4, 8, 0)])]
    return ops


@pytest.mark.parametrize("global_order", [True, False])
@pytest.mark.parametrize("recipe,valid", [
    (mono([(1, 10, 0), (2, 20, 1), (3, 30, 0)]), True),
    # value order against sts order: only the global check sees it
    (mono([(2, 10, 0), (1, 20, 1)], adds=[1, 2]), (False, True)),
    (mono([(1, 10, 0), (2, 20, 1)], adds=[1, 2, 3]), False),
    (revived, False),
    (no_read, "unknown"),
    (tuple_rows, False),
], ids=["valid", "off-order", "lost", "revived", "no-read", "tuples"])
def test_monotonic_checker_equals_the_reference(recipe, valid,
                                                global_order):
    if isinstance(valid, tuple):
        valid = valid[0] if global_order else valid[1]
    same(r_mono.MonotonicChecker(global_order),
         t_mono.MonotonicChecker(global_order), recipe, **{"valid?": valid})
    assert t_mono.monotonic_checker(False).global_order is False


# -- dirty reads, strong dirty read, multiversion ------------------------


def dirty_clean(o, _ind):
    return [
        o.invoke_op(0, "write", 1), o.ok_op(0, "write", 1),
        o.invoke_op(1, "read"), o.ok_op(1, "read", [1, 1, 1]),
        o.invoke_op(0, "write", 2), o.fail_op(0, "write", 2),
        o.invoke_op(1, "read"), o.ok_op(1, "read", [1, 1, 1]),
    ]


def dirty_filthy(o, _ind):
    return [
        o.invoke_op(0, "write", 2), o.fail_op(0, "write", 2),
        o.invoke_op(1, "read"), o.ok_op(1, "read", [2, 1, 1]),
    ]


def dirty_torn_only(o, _ind):
    """A torn read of committed values only, with tuple-valued rows
    (interned through intern_key): reported, and still valid."""
    return [
        o.invoke_op(0, "write", (1, "a")), o.ok_op(0, "write", (1, "a")),
        o.invoke_op(0, "write", (2, "b")), o.ok_op(0, "write", (2, "b")),
        o.invoke_op(1, "read"), o.ok_op(1, "read", [(1, "a"), (2, "b")]),
    ]


@pytest.mark.parametrize("recipe,valid", [
    (dirty_clean, True), (dirty_filthy, False), (dirty_torn_only, True),
], ids=["clean", "filthy", "torn"])
def test_dirty_reads_checker_equals_the_reference(recipe, valid):
    got = same(r_div.DirtyReadsChecker(), t_div.dirty_reads(), recipe,
               **{"valid?": valid})
    if recipe is dirty_filthy:
        assert got["dirty_reads"][0]["failed_values"] == [2]
    if recipe is dirty_torn_only:
        assert got["inconsistent_reads"][0]["op_index"] == 5


def strong_ok(o, _ind):
    return [
        o.invoke_op(0, "write", 1), o.ok_op(0, "write", 1),
        o.invoke_op(1, "read"), o.ok_op(1, "read", 1),
        o.invoke_op(0, "strong-read"), o.ok_op(0, "strong-read", [1]),
        o.invoke_op(1, "strong-read"), o.ok_op(1, "strong-read", [1]),
    ]


def strong_bad(o, _ind):
    return [
        o.invoke_op(0, "write", 1), o.ok_op(0, "write", 1),
        o.invoke_op(0, "write", 2), o.ok_op(0, "write", 2),
        o.invoke_op(1, "read"), o.ok_op(1, "read", 3),
        o.invoke_op(0, "strong-read"), o.ok_op(0, "strong-read", [1]),
        o.invoke_op(1, "strong-read"), o.ok_op(1, "strong-read", [1, 4]),
    ]


def versions(bad):
    def recipe(o, _ind):
        return [
            o.invoke_op(0, "read"),
            o.ok_op(0, "read", {"value": 1, "_version": 1}),
            o.invoke_op(1, "read"),
            o.ok_op(1, "read", {"value": 9 if bad else 2,
                                "_version": 1 if bad else 2}),
        ]
    return recipe


@pytest.mark.parametrize("name,recipe,valid", [
    ("strong", strong_ok, True), ("strong", strong_bad, False),
    ("multi", versions(False), True), ("multi", versions(True), False),
], ids=["strong-ok", "strong-bad", "multi-ok", "multi-bad"])
def test_strong_and_multiversion_checkers_equal_the_reference(
        name, recipe, valid):
    if name == "strong":
        got = same(r_div.StrongDirtyReadChecker(), t_div.strong_dirty_read(),
                   recipe, **{"valid?": valid})
        if not valid:
            assert got["lost"] == [2] and got["dirty"] == [3]
    else:
        got = same(r_div.MultiVersionChecker(), t_div.multiversion(),
                   recipe, **{"valid?": valid})
        if not valid:
            assert got["multis"] == {1: [1, 9]}


# -- _KVG2Checker ---------------------------------------------------------


def g2(committed_pairs):
    """Per key, two insert txns (a, then b); `committed_pairs` keys
    commit both, the planted G2-item anomaly."""
    def recipe(o, ind):
        ops, ids = [], 1
        for k in range(4):
            for side in ("a", "b"):
                v = ind.KV(k, (ids, None) if side == "a" else (None, ids))
                ids += 1
                p = 2 * k + (side == "b")
                ops.append(o.invoke_op(p, "insert", v))
                won = side == "a" or k in committed_pairs
                ops.append((o.ok_op if won else o.fail_op)(p, "insert", v))
        return ops
    return recipe


@pytest.mark.parametrize("pairs,valid", [((), True), ((2,), False),
                                         ((0, 3), False)],
                         ids=["serializable", "one-g2", "two-g2"])
def test_kv_g2_checker_equals_the_reference(pairs, valid):
    same(r_adya._KVG2Checker(), t_adya._KVG2Checker(device="cpu"),
         g2(pairs), **{"valid?": valid})


# -- histories the reference's runtime records ---------------------------


def recorded(spec, name):
    from jepsen_tpu.runtime import run

    out = run({**spec, "name": name, "concurrency": 4})
    hr = out["history"]
    ht = THistory([t_store.op_from_json(r_store.op_to_json(o))
                   for o in hr.ops], indexed=True)
    return out["results"], hr, ht


@pytest.mark.parametrize("weak", [False, True], ids=["strong", "weak"])
def test_recorded_workload_histories(weak):
    from jepsen_tpu.workloads import dirty_reads as r_dirty
    from jepsen_tpu.workloads import monotonic as r_mono_wl

    cases = [
        (r_mono_wl.workload(n_ops=80, skewed=weak, rng=random.Random(5)),
         r_mono.MonotonicChecker(), t_mono.MonotonicChecker()),
        (r_dirty.workload(n_ops=80, weak=weak, rng=random.Random(6)),
         r_div.DirtyReadsChecker(), t_div.DirtyReadsChecker()),
        (r_adya.workload(n_keys=12, serializable=not weak),
         r_adya._KVG2Checker(), t_adya._KVG2Checker(device="cpu")),
    ]
    for i, (spec, rc, tc) in enumerate(cases):
        res, hr, ht = recorded(spec, f"rec{i}")
        got = tc.check({}, ht)
        assert got == rc.check({}, hr) == res
