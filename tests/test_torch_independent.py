"""The port's independent-key checker (jepsen_tpu_torch.independent)
against the JAX package's jepsen_tpu.independent, on the CPU: KV values,
the merge lattice, engine_stats, the per-key artifact tree under a run
directory (byte for byte, with a deterministic sub-checker), the
per-key subhistories the split hands the sub-checker (every input form
the checker takes), and a keyed register history checked key by key through the port's
LinearizableChecker, with the reference's verdicts. Tolerance: exact."""

import copy
import importlib
import json
import random

import pytest
import torch

from jepsen_tpu import independent as r_ind
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.history.ops import Op as ROp
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch import independent as t_ind
from jepsen_tpu_torch.checker import linearizable as t_lin
from jepsen_tpu_torch.history.history import History as THistory
from jepsen_tpu_torch.history.ops import Op as TOp, invoke_op, ok_op

r_lin = importlib.import_module("jepsen_tpu.checker.linearizable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Fixed:
    """A sub-checker answering from a table by the subhistory's first
    value, with a tuple, a set and a non-string-keyed dict in its
    results (the store's tagged encodings)."""

    def __init__(self, table):
        self.table = table

    def check(self, test, history, opts=None):
        first = history.ops[0].value
        return {"valid?": self.table[first], "method": "fixed",
                "window": 2, "escalations": 1, "seen": (first, "x"),
                "keys": {first}, "by": {1: first}}


def _keyed_ops(KV, keys_values):
    ops = []
    for p, (k, v) in enumerate(keys_values):
        ops += [invoke_op(p, "write", None).to_dict(),
                ok_op(p, "write", None).to_dict()]
        ops[-2]["value"] = KV(k, v)
        ops[-1]["value"] = KV(k, v)
    return ops


def test_kv_values():
    a, b = t_ind.tuple_(1, "x"), t_ind.KV(1, "x")
    assert a == b and hash(a) == hash(b) and tuple(a) == (1, "x")
    assert repr(a) == repr(r_ind.tuple_(1, "x")) == "[1 'x']"
    assert t_ind.KV(1, [2]) == t_ind.KV(1, [2])  # unhashable value
    assert hash(t_ind.KV(1, [2])) == hash(1)


@pytest.mark.parametrize("table,want", [
    ({10: True, 20: True}, True),
    ({10: True, 20: "unknown"}, "unknown"),
    ({10: "unknown", 20: False}, False),
], ids=["all-valid", "unknown", "false-dominates"])
def test_merge_lattice_and_artifacts_match_reference(tmp_path, table, want):
    """Keys 1, "1", ".", "1~1" (colliding and dot names): the same merge,
    key_count, engine_stats, per-key directory names and file bytes as
    the reference's."""
    kvs = [(1, 10), ("1", 20), (".", 10), ("1~1", 20), (1, 20)]
    outs = {}
    for name, mod in (("ref", r_ind), ("port", t_ind)):
        run = tmp_path / name
        ops = _keyed_ops(mod.KV, kvs)
        hist = (RHistory if name == "ref" else THistory)(ops)
        out = mod.independent_checker(_Fixed(table)).check(
            {"run_dir": str(run)}, hist)
        files = {
            str(p.relative_to(run)): p.read_bytes()
            for p in sorted(run.rglob("*")) if p.is_file()
        }
        outs[name] = (out, files)
    (r_out, r_files), (t_out, t_files) = outs["ref"], outs["port"]
    assert t_out["valid?"] == r_out["valid?"] == want
    assert t_out["key_count"] == r_out["key_count"] == 4
    assert t_out["engine_stats"] == r_out["engine_stats"]
    assert t_out["engine_stats"]["escalations"] == 4
    assert list(t_out["results"]) == list(r_out["results"])
    assert t_files == r_files
    assert {f.split("/")[1] for f in t_files} == {
        "1", "1~1", "k__", "1~1~1"}
    rows = [json.loads(x) for x in
            t_files["independent/1/history.jsonl"].splitlines()]
    assert [r["value"] for r in rows] == [10, 10, 20, 20]


class _Recording:
    """A sub-checker that keeps each subhistory it is handed, as
    dicts, in the order it is called."""

    def __init__(self):
        self.seen = []

    def check(self, test, history, opts=None):
        self.seen.append(history.to_dicts())
        return {"valid?": True}


def _split_entries(KV):
    """Two processes on keys 1 and "1" side by side, a KV whose value is
    None, extra fields (`node`, an `error`), and nemesis ops between."""
    def op(type_, p, f, v, **kw):
        return dict(type=type_, f=f, value=v, process=p, **kw)

    return [
        op("invoke", 0, "write", KV(1, 3), time=10, node="n1"),
        op("invoke", "nemesis", "start", None, time=11),
        op("invoke", 1, "read", KV("1", None), time=12),
        op("ok", 0, "write", KV(1, 3), time=13, node="n1"),
        op("info", "nemesis", "start", ["n1", "n2"], time=14),
        op("fail", 1, "read", KV("1", None), time=15, error="timeout",
           node="n3"),
        op("invoke", 0, "cas", KV("1", [3, 4])),
        op("info", 0, "cas", KV("1", [3, 4]), error=["net", "down"]),
        op("invoke", 2, "read", KV(1, None), time=18),
        op("ok", 2, "read", KV(1, 3), time=19),
    ]


def _split_input(form, Op, History, KV):
    entries = _split_entries(KV)
    if form == "dicts":
        return entries
    if form == "iterator":
        return iter(entries)
    ops = [Op.from_dict(dict(e, index=1000 + 7 * i))
           for i, e in enumerate(entries)]
    return History(ops, indexed=True) if form == "history" else ops


@pytest.mark.parametrize("form", ["dicts", "ops", "history", "iterator"])
def test_split_hands_each_key_the_reference_subhistory(form):
    """Each key's subhistory, as dicts, equal to the reference's key for
    key and in the same order, for every input form; the caller's dicts
    and Ops unchanged by the check."""
    seen, outs = {}, {}
    for name, mod, Op, History in (("ref", r_ind, ROp, RHistory),
                                   ("port", t_ind, TOp, THistory)):
        given = _split_input(form, Op, History, mod.KV)
        kept = None if form == "iterator" else list(given)
        before = copy.deepcopy(kept)
        rec = _Recording()
        outs[name] = mod.IndependentChecker(rec).check({}, given)
        seen[name] = rec.seen
        if kept is not None:
            assert kept == before
    assert list(outs["port"]["results"]) == list(outs["ref"]["results"])
    assert list(outs["port"]["results"]) == [1, "1"]
    assert seen["port"] == seen["ref"]
    assert [len(s) for s in seen["port"]] == [4, 4]
    assert [o["index"] for o in seen["port"][1]] == [0, 1, 2, 3]
    assert seen["port"][1][1]["error"] == "timeout"
    assert seen["port"][1][1]["node"] == "n3"


def test_engine_stats_matches_reference():
    verdicts = [
        {"valid?": True, "method": "gpu-wgl-bitset", "window": 5,
         "escalations": 0},
        {"valid?": False, "method": "gpu-wgl-kfrontier", "window": 24,
         "escalations": 2, "taint": True},
        {"valid?": True, "method": "gpu-wgl-bitset", "window": 5},
        "not a verdict",
    ]
    assert t_ind.engine_stats(verdicts) == r_ind.engine_stats(verdicts)
    assert t_ind.engine_stats([{"valid?": True}]) is None
    assert r_ind.engine_stats([{"valid?": True}]) is None


def test_keyed_register_history_matches_reference():
    """Four register keys, two corrupted, interleaved into one keyed
    history: per key the reference's valid? and failed_op_index (the
    reference's bitset tier in interpret mode, no sentry)."""
    ops = []
    for k in range(4):
        h = gen_register_history(random.Random(700 + k), n_ops=30,
                                 n_procs=3, p_crash=0.05)
        if k % 2:
            h = corrupt_history(h, random.Random(700 + k))
        for o in h.to_dicts():
            o = dict(o, process=o["process"] + 10 * k)
            ops.append(o)
    for o in ops:
        o["value"] = ("key", o["process"] // 10, o["value"])
    want_ops = [dict(o, value=r_ind.KV(o["value"][1], o["value"][2]))
                for o in ops]
    got_ops = [dict(o, value=t_ind.KV(o["value"][1], o["value"][2]))
               for o in ops]
    want = r_ind.IndependentChecker(r_lin.LinearizableChecker(
        interpret=True, sentry=False)).check({}, RHistory(want_ops))
    got = t_ind.IndependentChecker(t_lin.LinearizableChecker(
        device="cpu")).check({}, THistory(got_ops))
    assert got["valid?"] is want["valid?"] is False
    assert got["key_count"] == want["key_count"] == 4
    for k in range(4):
        for f in ("valid?", "failed_op_index", "n_ops", "window"):
            assert got["results"][k].get(f) == want["results"][k].get(f)
    assert got["engine_stats"]["engines"] == {"gpu-wgl-bitset": 4}
