"""POST /check/stream of the port's daemon against the JAX package's, on
the CPU.

A history cut into chunks of whole operations goes to both daemons as
the same bytes: every non-final chunk answers 202 with the same
provisional status, the final one 200 with the same verdict (method
aside), and that verdict agrees with the one-shot POST /check of the
whole history. An invalid stream's final verdict names the one-shot
check's failing op; a durable stream restarted from op 0 resumes from
its persisted frontier; chunks of one stream from many threads
serialize on the stream's own lock. Tolerance: exact equality."""

import json
import random
import threading

import pytest
from test_torch_service import port_daemon, post, ref_daemon, rows, strip

from jepsen_tpu_torch import sim
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.service.client import CheckerClient, encode_history

pytestmark = pytest.mark.service


def clean_cuts(ops, n_chunks):
    """Cut points near each 1/n_chunks of the wire ops where no invoke
    is open (chip_smoke.clean_cuts, over op dicts)."""
    open_ops, clean = {}, []
    for i, op in enumerate(ops):
        p = op["process"]
        if op["type"] == "invoke":
            open_ops[p] = open_ops.get(p, 0) + 1
        elif p in open_ops:
            open_ops[p] -= 1
            if not open_ops[p]:
                del open_ops[p]
        if not open_ops:
            clean.append(i + 1)
    cuts, j = [0], 0
    for k in range(1, n_chunks):
        want = k * len(ops) // n_chunks
        while j < len(clean) and clean[j] < want:
            j += 1
        if j < len(clean) and clean[j] > cuts[-1]:
            cuts.append(clean[j])
    if cuts[-1] != len(ops):
        cuts.append(len(ops))
    return cuts


def chunk_bodies(ops, n_chunks, stream_id="s1", **req):
    cuts = clean_cuts(ops, n_chunks)
    return [
        json.dumps({"stream_id": stream_id, "ops": ops[a:b],
                    "final": i == len(cuts) - 2, **req}).encode()
        for i, (a, b) in enumerate(zip(cuts, cuts[1:]))
    ]


def sstrip(out):
    return {k: v for k, v in strip(out).items() if k != "stream_id"}


def test_stream_chunks_equal_the_reference_and_the_one_shot(tmp_path):
    h = sim.gen_register_history(random.Random(9), n_ops=400, n_procs=4,
                                 p_crash=0.0)
    ops = encode_history(h)
    bodies = chunk_bodies(ops, 3)
    got = {}
    for name, mk in (("port", port_daemon), ("ref", ref_daemon)):
        with mk(tmp_path) as d:
            outs = [post(d, "/check/stream", b, tenant="a") for b in bodies]
            one = post(d, "/check", json.dumps({"history": ops}).encode())
            got[name] = (outs, one, rows(d))
    (pouts, pone, prow), (routs, rone, rrow) = got["port"], got["ref"]
    assert [s for s, _ in pouts] == [s for s, _ in routs] == [202, 202, 200]
    assert [sstrip(o) for _, o in pouts] == [sstrip(o) for _, o in routs]
    assert pouts[0][1]["stream_id"] == "s1"
    final = pouts[-1][1]
    assert final["valid?"] is pone[1]["valid?"] is True
    assert final["method"] == "gpu-wgl-bitset-streaming"
    assert prow == rrow
    assert prow["a"]["stream_chunks"] == 3
    assert strip(pone[1]) == strip(rone[1])


def test_invalid_stream_names_the_one_shot_failure(tmp_path):
    h = sim.corrupt_history(
        sim.gen_register_history(random.Random(103), n_ops=100, n_procs=4,
                                 p_crash=0.0), random.Random(55))
    ops = encode_history(h)
    with port_daemon(tmp_path) as d:
        outs = [post(d, "/check/stream", b, tenant="b")
                for b in chunk_bodies(ops, 4, stream_id="bad")]
        _, one = post(d, "/check", json.dumps({"history": ops}).encode())
        snap = d.ledger.snapshot()["b"]
    assert one["valid?"] is False
    assert outs[-1][0] == 200
    assert {s for s, _ in outs[:-1]} <= {202}
    final = outs[-1][1]
    assert final["valid?"] is False
    assert final["failed_op_index"] == one["failed_op_index"]
    assert snap["invalid"] == 1 and snap["completed"] == 1


def test_durable_stream_restart_resumes(tmp_path):
    """A durable stream persists its frontier under the service
    checkpoint root after its first chunk; a fresh daemon over the same
    store, fed the same chunks from op 0 with restart on the first,
    adopts that frontier at the first append (whose prefix hashes as
    the persisted one) instead of re-checking, to the same verdict."""
    h = sim.gen_register_history(random.Random(29), n_ops=300, n_procs=4,
                                 p_crash=0.0)
    ops = encode_history(h)
    root = str(tmp_path / "store")
    first = chunk_bodies(ops, 3, stream_id="d", durable=True)
    with port_daemon(tmp_path, root=root) as d:
        assert post(d, "/check/stream", first[0])[0] == 202
    again = chunk_bodies(ops, 3, stream_id="d", durable=True)
    again[0] = json.dumps({**json.loads(again[0]), "restart": True}).encode()
    with port_daemon(tmp_path, root=root) as d:
        outs = [post(d, "/check/stream", b) for b in again]
        snap = d.ledger.snapshot()["default"]
    final = outs[-1][1]
    assert outs[-1][0] == 200 and final["valid?"] is True
    assert final["streaming"]["resumed"] is True
    assert snap["durable_resumes"] == 1


def test_concurrent_chunks_of_one_stream_serialize(tmp_path):
    """Chunks of ONE stream posted from several threads serialize on
    the stream's lock: every append answers, and the final verdict
    counts every op (whole operations only, so any order is a valid
    history of the same ops)."""
    ops = []
    for i in range(40):
        ops += [t_ops.invoke_op(i % 4, "write", i % 3),
                t_ops.ok_op(i % 4, "write", i % 3)]
    wire = encode_history(History(ops))
    with port_daemon(tmp_path) as d:
        c = CheckerClient(port=d.port, tenant="m", retries=0)
        errs = []

        def go(k):
            try:
                c._roundtrip("POST", "/check/stream", json.dumps(
                    {"stream_id": "m", "ops": wire[k * 20:(k + 1) * 20]}
                ).encode())
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=go, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        out = c._roundtrip("POST", "/check/stream", json.dumps(
            {"stream_id": "m", "ops": [], "final": True}).encode())
    assert errs == []
    assert out["valid?"] is True and out["n_ops"] == 80
