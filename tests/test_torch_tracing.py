"""The port's per-op trace client (jepsen_tpu_torch.utils.tracing)
against the JAX package's, on the CPU.

Each package's in-memory register client, wrapped in its package's
`traced`, records the same seeded run through its package's runtime:
the ops are drawn up front and fed as `gen.once` lists to one worker,
so the order of the spans is the ops' own. The client raises on some
ops (a definite ClientFailed, and an indefinite error the runtime turns
into info) and answers others with a fail carrying an error. The two
trace.jsonl files must be equal once each span's start and duration
are masked: span numbers, trace names, op names, processes, outcomes
and errors. Tolerance: exact."""

import json
import random

import pytest

from jepsen_tpu.generator import pure as r_gen
from jepsen_tpu.runtime import client as r_client
from jepsen_tpu.runtime import run as r_run
from jepsen_tpu.utils import tracing as r_tracing

from jepsen_tpu_torch.generator import pure as t_gen
from jepsen_tpu_torch.runtime import client as t_client
from jepsen_tpu_torch.runtime import run as t_run
from jepsen_tpu_torch.utils import tracing as t_tracing

from test_torch_generator import restored_run_logs

SIDES = {
    "ref": (r_gen, r_client, r_run, r_tracing),
    "port": (t_gen, t_client, t_run, t_tracing),
}
MASKED = ("start_us", "duration_us")


@pytest.fixture(autouse=True)
def _restore_run_logs():
    with restored_run_logs():
        yield


def flaky_register(client):
    """An AtomClient that raises a ClientFailed on writes of 3, an
    indefinite error on writes of 4, and fails cas from 0 with an
    error of its own."""

    class FlakyRegister(client.AtomClient):
        def open(self, test, node):
            return FlakyRegister(self.register)

        def invoke(self, test, op):
            if op.f == "write" and op.value == 3:
                raise client.ClientFailed("refused")
            if op.f == "write" and op.value == 4:
                raise ConnectionResetError("socket closed")
            if op.f == "cas" and op.value[0] == 0:
                return op.with_(type="fail", error="precondition")
            return super().invoke(test, op)

    return FlakyRegister()


def seeded_ops(seed, n=60):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        f = rng.choice(("read", "write", "cas"))
        if f == "read":
            out.append({"f": "read"})
        elif f == "write":
            out.append({"f": "write", "value": rng.randrange(5)})
        else:
            out.append({"f": "cas",
                        "value": [rng.randrange(5), rng.randrange(5)]})
    return out


def traced_run(side, ops, run_dir):
    gen, client, run, tracing = SIDES[side]
    run_dir.mkdir()
    test = run({
        "nodes": ["n1"],
        "concurrency": 1,
        "client": tracing.traced(flaky_register(client), "register"),
        "generator": gen.clients([gen.once(dict(o)) for o in ops]),
        "run_dir": str(run_dir),
    })
    spans = [json.loads(line) for line in
             (run_dir / "trace.jsonl").read_text().splitlines()]
    history = [(o.type, o.f, o.value, o.process, o.get("error"))
               for o in test["history"].ops]
    return spans, history


def masked(spans):
    return [{k: v for k, v in s.items() if k not in MASKED} for s in spans]


@pytest.mark.parametrize("seed", range(3))
def test_traced_run_spans_equal(seed, tmp_path):
    ops = seeded_ops(seed)
    ref_spans, ref_hist = traced_run("ref", ops, tmp_path / "ref")
    port_spans, port_hist = traced_run("port", ops, tmp_path / "port")
    assert masked(port_spans) == masked(ref_spans)
    assert port_hist == ref_hist
    assert [s["span"] for s in port_spans] == list(
        range(1, len(ops) + 1))
    outcomes = {s["outcome"] for s in port_spans}
    assert {"ok", "fail", "exception"} <= outcomes
    assert any(s["error"] == "precondition" for s in port_spans)
    for s in port_spans:
        assert set(s) == {"trace", "name", "process", "start_us",
                          "duration_us", "outcome", "error", "span"}
        assert s["duration_us"] >= 0


def test_no_run_dir_writes_nothing(tmp_path):
    """Without a run directory the writer drops its spans in both."""
    for side in SIDES:
        gen, client, run, tracing = SIDES[side]
        c = tracing.traced(client.AtomClient(), "x")
        test = run({
            "nodes": ["n1"], "concurrency": 1, "client": c,
            "generator": gen.clients([gen.once({"f": "read"})]),
        })
        assert [o.type for o in test["history"].ops] == ["invoke", "ok"]
        assert c.writer.seq == 0
