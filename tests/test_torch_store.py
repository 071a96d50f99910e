"""The port's run store (jepsen_tpu_torch.store, write and read halves)
against the JAX package's (jepsen_tpu.store), on the CPU.

The same ops, built with each package's own constructors (independent
KV values, tuples, sets and dicts with non-string keys among them),
serialize to the same JSON and read back equal; a run directory saved
by either package's Store loads in the other's with equal ops and
test.json; results.json crosses both ways; latest(), tests() and the
latest/current symlinks behave as the reference's on the same store
operations. Tolerance: exact equality."""

import json
import os

import numpy as np
import pytest

from jepsen_tpu import independent as r_ind
from jepsen_tpu import store as r_store
from jepsen_tpu.history import ops as r_ops
from jepsen_tpu.history.history import History as RHistory

from jepsen_tpu_torch import independent as t_ind
from jepsen_tpu_torch import store as t_store
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History as THistory


def op_list(ops, ind):
    """One history with every value shape the tag scheme carries."""
    KV = ind.KV
    return [
        ops.invoke_op(0, "write", KV(1, 3)),
        ops.ok_op(0, "write", KV(1, 3)),
        ops.invoke_op(1, "read", KV("k", None)),
        ops.ok_op(1, "read", KV("k", (1, 2))),
        ops.invoke_op(2, "add", {5, 2, 9}),
        ops.info_op(2, "add", {5, 2, 9}),
        ops.invoke_op(3, "txn", [["append", 1, 2], ["r", 1, None]]),
        ops.ok_op(3, "txn", [["append", 1, 2], ["r", 1, [2]]]),
        ops.invoke_op(4, "read", None),
        ops.ok_op(4, "read", {1: 10, 2: (3, 4)}),
        ops.invoke_op(0, "cas", [1, 2]),
        ops.fail_op(0, "cas", [1, 2]),
    ]


def both_histories():
    return (RHistory(op_list(r_ops, r_ind)),
            THistory(op_list(t_ops, t_ind)))


def as_json(history, store):
    return [json.dumps(store.op_to_json(o), sort_keys=True)
            for o in history.ops]


def test_op_json_round_trip_equals_the_reference():
    hr, ht = both_histories()
    assert as_json(hr, r_store) == as_json(ht, t_store)
    for o in ht.ops:
        back = t_store.op_from_json(json.loads(json.dumps(
            t_store.op_to_json(o))))
        assert back == o
    # the reference's JSON decodes into the port's own KV
    kv = t_store.op_from_json(r_store.op_to_json(hr.ops[3])).value
    assert isinstance(kv, t_ind.KV) and kv == t_ind.KV("k", (1, 2))


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_run_dir_interchanges_between_packages(tmp_path, direction):
    hr, ht = both_histories()
    writer, reader = ((r_store, t_store) if direction == "ref_to_port"
                      else (t_store, r_store))
    hist = hr if writer is r_store else ht
    test = {"name": "xrun", "history": hist, "nodes": ["n1", "n2"],
            "concurrency": 5, "workload": "register",
            "client": object(), "_private": 1}
    d = writer.Store(str(tmp_path)).save_1(test)
    assert sorted(os.listdir(d)) == ["history.jsonl", "test.json"]
    st = reader.Store(str(tmp_path))
    got = st.load_history(d)
    want = ht if reader is t_store else hr
    assert as_json(got, reader) == as_json(want, reader)
    assert [o.index for o in got.ops] == list(range(len(want.ops)))
    tj = st.load_test(d)
    assert tj == {"name": "xrun", "nodes": ["n1", "n2"],
                  "concurrency": 5, "workload": "register",
                  "run_dir": d}
    assert tj == writer.Store(str(tmp_path)).load_test(d)
    assert st.load_results(d) is None


def port_results():
    """A verdict shaped as the port's checkers return them: numpy
    scalars, tuples, sets and int-keyed dicts inside."""
    return {
        "valid?": False,
        "failed_op_index": np.int64(26),
        "window": 3,
        "failure": {"op": {"index": 26, "value": (1, 2)},
                    "configs": [{"state": 1, "pending": {3, 4}}]},
        "results": {0: {"valid?": True}, 1: {"valid?": False}},
        "engine_stats": {"launch": {"launches": 2, "host_syncs": 1}},
    }


def test_results_json_cross_reads(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for d in (a, b):
        os.makedirs(d)
    t_store.Store(str(tmp_path)).save_2({"run_dir": a,
                                         "results": port_results()})
    r_store.Store(str(tmp_path)).save_2({"run_dir": b,
                                         "results": port_results()})
    with open(os.path.join(a, "results.json")) as f1, \
            open(os.path.join(b, "results.json")) as f2:
        assert f1.read() == f2.read()
    for reader in (r_store, t_store):
        st = reader.Store(str(tmp_path))
        assert st.load_results(a) == st.load_results(b)
    got = t_store.Store(str(tmp_path)).load_results(a)
    # numpy scalars serialize as the reference's do (str), the rest
    # decodes to its Python shape
    assert got["failed_op_index"] == "26"
    assert got["failure"]["op"]["value"] == (1, 2)
    assert got["failure"]["configs"][0]["pending"] == {3, 4}
    assert got["results"][1] == {"valid?": False}


def store_ops(store, root):
    """One sequence of store operations: two tests, three runs."""
    st = store.Store(root)
    dirs = []
    for name, start in (("alpha", 1_700_000_000.25),
                        ("beta", 1_700_000_100.5),
                        ("alpha", 1_700_000_200.75)):
        t = {"name": name, "start_time": start, "history": None}
        dirs.append(st.save_1(t))
    return st, dirs


def tree(root):
    out = []
    for dp, dn, fn in os.walk(root):
        for n in sorted(dn + fn):
            p = os.path.join(dp, n)
            rel = os.path.relpath(p, root)
            out.append((rel, os.readlink(p) if os.path.islink(p) else None))
    return sorted(out)


def test_latest_tests_and_symlinks_equal_the_reference(tmp_path):
    r_root, t_root = str(tmp_path / "r"), str(tmp_path / "t")
    rs, rdirs = store_ops(r_store, r_root)
    ts, tdirs = store_ops(t_store, t_root)
    assert [os.path.relpath(d, t_root) for d in tdirs] == \
        [os.path.relpath(d, r_root) for d in rdirs]
    assert tree(t_root) == tree(r_root)
    assert ts.tests() == rs.tests()
    assert list(ts.tests()) == ["alpha", "beta"]
    assert len(ts.tests("alpha")["alpha"]) == 2
    for name in (None, "alpha", "beta", "gamma"):
        got, want = ts.latest(name), rs.latest(name)
        assert (got and os.path.relpath(got, t_root)) == \
            (want and os.path.relpath(want, r_root))
    assert ts.latest() == tdirs[2] and ts.latest("beta") == tdirs[1]
    # the swaps leave no temporary link behind and point at the newest
    assert os.readlink(os.path.join(t_root, "alpha", "latest")) == \
        os.path.basename(tdirs[2])
    assert os.readlink(os.path.join(t_root, "current")) == \
        os.path.relpath(tdirs[2], t_root)
    assert not any(".tmp." in rel for rel, _ in tree(t_root))
    assert t_store.Store(str(tmp_path / "empty")).latest() is None


def test_symlink_swap_replaces_a_stale_temporary(tmp_path):
    """A temporary link a killed writer left (same pid) does not stop
    the swap; the link ends at the new target."""
    link = str(tmp_path / "latest")
    os.symlink("old", link)
    os.symlink("junk", f"{link}.tmp.{os.getpid()}")
    t_store.Store._symlink(link, "new")
    assert os.readlink(link) == "new"
    assert sorted(os.listdir(tmp_path)) == ["latest"]


def test_service_checkpoint_path_and_save_run(tmp_path):
    for tenant in ("acme", "../../etc", "", "a b/c"):
        assert t_store.Store("root").service_checkpoint_path(
            tenant, "abc") == r_store.Store("root").service_checkpoint_path(
            tenant, "abc")
    _, ht = both_histories()
    test = {"name": "saved", "history": ht, "results": {"valid?": True}}
    d = t_store.save_run(test, root=str(tmp_path))
    assert sorted(os.listdir(d)) == ["history.jsonl", "results.json",
                                     "test.json"]
    assert r_store.Store(str(tmp_path)).load_results(d) == {"valid?": True}
    assert t_store.DEFAULT_ROOT == r_store.DEFAULT_ROOT
    assert t_store.STRIP_KEYS == r_store.STRIP_KEYS
