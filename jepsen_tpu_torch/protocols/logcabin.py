"""LogCabin client: drives the TreeOps CLI on the node over the
control session — the reference's client IS this binary (no wire
protocol involved: logcabin/src/jepsen/logcabin.clj:163-244 runs
/root/TreeOps via SSH for read/write/cas and classifies outcomes by
the exception text).

Semantics preserved from the reference:

- values are JSON-encoded into the tree node;
- cas is TreeOps's conditional write (`-p path:expected write path`),
  whose failure is a DEFINITE :fail recognized by the
  "has value ... not ... as required" exception pattern;
- a client-specified-timeout exception is indeterminate for mutations
  (the write may commit after the deadline) -> :info; reads time out
  to :fail (safe — no effect);
- any other nonzero exit is an unclassified crash -> :info (raise).
"""

from __future__ import annotations

import json
import re

from jepsen_tpu_torch.control.core import RemoteError, sessions_for
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

#: TreeOps binary as built by the suite recipe (scons puts Examples
#: binaries under build/; suites/simple.py "logcabin" entry)
TREEOPS = "/opt/logcabin/build/Examples/TreeOps"

#: conditional-write failure text (logcabin.clj:152-154's pattern)
CAS_FAILED = re.compile(
    r"has value '.*', not '.*' as required"
)

#: client-side deadline text (logcabin.clj:156-157's pattern)
TIMED_OUT = re.compile(r"Client-specified timeout elapsed")


class LogCabinRegisterClient(Client):
    """CAS register at a fixed tree path (logcabin.clj:212-244)."""

    def __init__(self, node=None, path: str = "/jepsen",
                 port: int = 5254, timeout_s: int = 3,
                 binary: str = TREEOPS):
        self.node = node
        self.path = path
        self.port = port
        self.timeout_s = timeout_s
        self.binary = binary

    def open(self, test, node):
        return LogCabinRegisterClient(
            node, self.path, self.port, self.timeout_s, self.binary
        )

    def _addrs(self, test) -> str:
        return ",".join(f"{n}:{self.port}" for n in test["nodes"])

    def _treeops(self, test, *args, stdin=None) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec(
            self.binary, "-c", self._addrs(test),
            "-q", "-t", str(self.timeout_s), *args,
            stdin=stdin, sudo=True,
        )

    def setup(self, test) -> None:
        try:
            self._treeops(
                test, "write", self.path, stdin=json.dumps(None)
            )
        except RemoteError:
            pass  # another worker's setup won the race

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                out = self._treeops(test, "read", self.path)
                return op.with_(type="ok", value=json.loads(out))
            if op.f == "write":
                self._treeops(
                    test, "write", self.path,
                    stdin=json.dumps(op.value),
                )
                return op.with_(type="ok")
            if op.f == "cas":
                expected, new = op.value
                try:
                    self._treeops(
                        test,
                        "-p", f"{self.path}:{json.dumps(expected)}",
                        "write", self.path,
                        stdin=json.dumps(new),
                    )
                    return op.with_(type="ok")
                except RemoteError as e:
                    if CAS_FAILED.search(str(e)):
                        return op.with_(type="fail")
                    raise
            raise ValueError(f"unknown op f={op.f!r}")
        except RemoteError as e:
            msg = str(e)
            if TIMED_OUT.search(msg):
                if op.f == "read":
                    return op.with_(type="fail", value="timed-out")
                raise  # mutation may commit after the deadline: :info
            if op.f == "read":
                raise ClientFailed(msg)  # reads never take effect
            raise
