"""Per-op distributed-tracing spans (the dgraph suite's OpenCensus →
Jaeger plane, dgraph/src/jepsen/dgraph/trace.clj:26-73).

TraceClient wraps any Client and exports one span per invocation —
{trace span name process f start_us duration_us outcome error} — to
<run_dir>/trace.jsonl. The reference pushes spans to a Jaeger
collector; here the export is a local JSONL the web dashboard's file
browser serves, which keeps the plane dependency-free while preserving
the queryable shape (span per op, timed, outcome-tagged)."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client


class _TraceWriter:
    def __init__(self):
        self.lock = threading.Lock()
        self.seq = 0

    def emit(self, test, span: dict) -> None:
        run_dir = test.get("run_dir")
        if not run_dir:
            return
        with self.lock:
            self.seq += 1
            span["span"] = self.seq
            path = os.path.join(run_dir, "trace.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps(span) + "\n")


class TraceClient(Client):
    """Wraps a client; every invoke emits a span (trace.clj's
    with-trace around client ops)."""

    def __init__(self, inner: Client, trace_name: str = "client",
                 _writer: Optional[_TraceWriter] = None):
        self.inner = inner
        self.trace_name = trace_name
        self.writer = _writer or _TraceWriter()

    def open(self, test, node):
        return TraceClient(
            self.inner.open(test, node), self.trace_name, self.writer
        )

    def setup(self, test):
        self.inner.setup(test)

    def invoke(self, test, op: Op) -> Op:
        t0 = time.time()
        try:
            out = self.inner.invoke(test, op)
            return out
        finally:
            t1 = time.time()
            try:
                outcome = out.type  # type: ignore[possibly-undefined]
                err = out.get("error")
            except (NameError, UnboundLocalError):
                outcome, err = "exception", None
            self.writer.emit(test, {
                "trace": self.trace_name,
                "name": str(op.f),
                "process": op.process,
                "start_us": int(t0 * 1e6),
                "duration_us": int((t1 - t0) * 1e6),
                "outcome": outcome,
                "error": err,
            })

    def teardown(self, test):
        self.inner.teardown(test)

    def close(self, test):
        self.inner.close(test)


def traced(inner: Client, trace_name: str = "client") -> TraceClient:
    return TraceClient(inner, trace_name)
