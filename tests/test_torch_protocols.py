"""The port's wire protocols (jepsen_tpu_torch.protocols) against the
JAX package's, on the CPU.

Every case of tests/test_resp.py, test_memcache.py, test_wire_clients.py
and test_wire_clients2.py runs against both packages, as one test
parametrised by package: each file's source is loaded once per package
with its imports pointed at that package (the port's checkers take
device="cpu"), its own protocol-peer servers included. A case's
fixtures defined in the file are set up from the loaded module, so each
package's case talks to a server built from that package's codecs; its
parametrize marks are expanded into one case each.

Then byte differentials on seeded inputs (numpy default_rng): RESP's
encode_command, BSON's encode and decode, Ignite's datum codec and
Java string hash, the ReQL query terms serialized to JSON, RobustIRC's
client message ids and the SQL CLIs' balance parser give equal bytes
or values in both packages. Tolerance: exact."""

import contextlib
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.protocols import ignite as r_ignite
from jepsen_tpu.protocols import mongo as r_mongo
from jepsen_tpu.protocols import resp as r_resp
from jepsen_tpu.protocols import rethinkdb as r_reql
from jepsen_tpu.protocols import robustirc as r_irc
from jepsen_tpu.protocols import sqlcli as r_sql

from jepsen_tpu_torch.protocols import ignite as t_ignite
from jepsen_tpu_torch.protocols import mongo as t_mongo
from jepsen_tpu_torch.protocols import resp as t_resp
from jepsen_tpu_torch.protocols import rethinkdb as t_reql
from jepsen_tpu_torch.protocols import robustirc as t_irc
from jepsen_tpu_torch.protocols import sqlcli as t_sql

from test_torch_generator import PKGS, load_cases, restored_run_logs

TESTS = Path(__file__).resolve().parent

#: the port's suite test maps and checkers run their checks on the CPU
CPU_SUBS = [
    ("LinearizableChecker()", 'LinearizableChecker(device="cpu")'),
    ("_test({", '_test({"device": "cpu", '),
]


def expand_cases(mod):
    """(id, function name, params) for every test function of ``mod``,
    one entry per point of its parametrize marks."""
    out = []
    for name, fn in sorted(vars(mod).items()):
        if not name.startswith("test_") or not inspect.isfunction(fn):
            continue
        grid = [{}]
        for mark in reversed(getattr(fn, "pytestmark", [])):
            if mark.name != "parametrize":
                continue
            names, values = mark.args[0], mark.args[1]
            if isinstance(names, str):
                names = [n.strip() for n in names.split(",")]
            grid = [{**g, **dict(zip(names, v if len(names) > 1 else (v,)))}
                    for g in grid for v in values]
        for g in grid:
            tag = "-".join(str(v) for v in g.values())
            out.append((f"{name}[{tag}]" if g else name, name, g))
    return out


def _local_fixture(mod, name):
    """The function under ``name`` when ``mod`` defines it as a pytest
    fixture, else None."""
    obj = getattr(mod, name, None)
    if obj is None or inspect.isfunction(obj):
        return None
    return getattr(obj, "__wrapped__", None)


def _fixture_value(mod, name, request, stack):
    fn = _local_fixture(mod, name)
    if fn is None:
        return request.getfixturevalue(name)
    args = {n: _fixture_value(mod, n, request, stack)
            for n in inspect.signature(fn).parameters}
    if not inspect.isgeneratorfunction(fn):
        return fn(**args)
    it = fn(**args)
    value = next(it)
    stack.callback(next, it, None)
    return value


def run_local_case(mod, name, params, request) -> None:
    """Call ``mod.name`` with ``params`` and the fixtures its signature
    names, those ``mod`` defines itself set up (and torn down) from
    ``mod``."""
    fn = getattr(mod, name)
    with contextlib.ExitStack() as stack:
        fn(**{n: params[n] if n in params
              else _fixture_value(mod, n, request, stack)
              for n in inspect.signature(fn).parameters})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one intra-op thread keeps
    torch's pool from oversubscribing the cores under parallel workers
    (a queue check's plain kernel-B scan took 100x longer without it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_run_logs():
    with restored_run_logs():
        yield


PROTOCOL_FILES = ("test_resp.py", "test_memcache.py",
                  "test_wire_clients.py", "test_wire_clients2.py")
PROTOCOL_CASES = {
    pkg: {f: load_cases(TESTS / f, pkg, subs=CPU_SUBS)
          for f in PROTOCOL_FILES}
    for pkg in PKGS
}
CASES = [(f, *c) for f in PROTOCOL_FILES
         for c in expand_cases(PROTOCOL_CASES["jepsen_tpu"][f])]


def test_the_cases_load_each_package():
    assert len(CASES) == 39
    for pkg, mods in PROTOCOL_CASES.items():
        assert mods["test_resp.py"].RespConnection.__module__ == \
            f"{pkg}.protocols.resp"
        assert mods["test_memcache.py"].ClientFailed.__module__ == \
            f"{pkg}.runtime.client"


@pytest.mark.parametrize("f,cid,name,params", CASES,
                         ids=[f"{f[5:-3]}::{cid}" for f, cid, _, _ in CASES])
@pytest.mark.parametrize("pkg", PKGS)
def test_protocol_case(pkg, f, cid, name, params, request):
    run_local_case(PROTOCOL_CASES[pkg][f], name, params, request)


# -- byte differentials on seeded inputs ---------------------------------


def _word(rng, n=8):
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789 _-:/é中")
    return "".join(rng.choice(alphabet, size=int(rng.integers(0, n + 1))))


def _datum(rng, depth=0):
    kind = int(rng.integers(0, 8 if depth < 2 else 5))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-2**31, 2**31))
    if kind == 3:
        return int(rng.integers(-2**62, 2**62))
    if kind == 4:
        return _word(rng)
    if kind == 5:
        return float(rng.normal() * 1e6)
    if kind == 6:
        return [_datum(rng, depth + 1)
                for _ in range(int(rng.integers(0, 4)))]
    return {_word(rng, 4) or "k": _datum(rng, depth + 1)
            for _ in range(int(rng.integers(0, 4)))}


@pytest.mark.parametrize("seed", range(4))
def test_resp_encode_command_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        args = []
        for _ in range(int(rng.integers(1, 6))):
            k = int(rng.integers(0, 3))
            args.append(int(rng.integers(-10**9, 10**9)) if k == 0
                        else _word(rng).encode() if k == 1 else _word(rng))
        assert t_resp.encode_command(*args) == r_resp.encode_command(*args)


@pytest.mark.parametrize("seed", range(4))
def test_bson_encode_decode_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        doc = {_word(rng, 6) or "k": _datum(rng)
               for _ in range(int(rng.integers(0, 6)))}
        raw = t_mongo.bson_encode(doc)
        assert raw == r_mongo.bson_encode(doc)
        assert t_mongo.bson_decode(raw) == r_mongo.bson_decode(raw)
        assert t_mongo.bson_decode(raw)[0] == {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in doc.items()}


@pytest.mark.parametrize("seed", range(4))
def test_ignite_codec_and_hash_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        v = _datum(rng, depth=2)  # scalars only: null, bool, ints, str
        raw = t_ignite.enc(v)
        assert raw == r_ignite.enc(v)
        assert t_ignite.dec(raw) == r_ignite.dec(raw) == (v, len(raw))
        s = _word(rng, 40)
        assert t_ignite.java_string_hash(s) == r_ignite.java_string_hash(s)


def _reql_terms(q, rng):
    d = q.db(_word(rng) or "jepsen")
    tbl = q.table(d, _word(rng) or "cas",
                  read_mode=[None, "majority", "single"][
                      int(rng.integers(0, 3))])
    key = int(rng.integers(0, 100))
    row = q.get(tbl, key)
    return [
        d, tbl, row,
        q.get_field(row, "val"),
        q.default(q.get_field(row, "val"), None),
        q.insert(tbl, {"id": key, "val": int(rng.integers(0, 5))},
                 conflict=[None, "update", "replace"][
                     int(rng.integers(0, 3))]),
        q.cas_update(row, "val", int(rng.integers(0, 5)),
                     int(rng.integers(0, 5))),
    ]


@pytest.mark.parametrize("seed", range(4))
def test_reql_terms_serialize_equal(seed):
    for i in range(25):
        got = _reql_terms(t_reql, np.random.default_rng([seed, i]))
        want = _reql_terms(r_reql, np.random.default_rng([seed, i]))
        assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("seed", range(4))
def test_robustirc_message_ids_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        data = f"PRIVMSG #jepsen :{_word(rng, 30)}"
        assert t_irc.client_message_id(data) == r_irc.client_message_id(data)


@pytest.mark.parametrize("seed", range(4))
def test_sqlcli_parse_balances_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        lines = []
        for _ in range(int(rng.integers(0, 12))):
            k = int(rng.integers(0, 4))
            a, b = int(rng.integers(-50, 50)), int(rng.integers(-500, 500))
            lines.append(
                f"{a}\t{b}" if k == 0 else f" {a} | {b} " if k == 1
                else "id\tbalance" if k == 2 else f"{_word(rng)}|{b}")
        out = "\n".join(lines)
        assert t_sql._parse_balances(out) == r_sql._parse_balances(out)
