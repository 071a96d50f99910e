"""Client protocol: the system-under-test adapter.

Mirrors the reference's 5-method Client protocol
(jepsen/src/jepsen/client.clj:8-27):

  open(test, node)   -> a connected clone of this client (one per worker)
  setup(test)        -> one-time data setup through this connection
  invoke(test, op)   -> apply an invocation Op, return the completion Op
  teardown(test)     -> undo setup
  close(test)        -> release the connection

invoke() must return a completion via op.with_(type=...):
  "ok"    the operation definitely happened
  "fail"  it definitely did NOT happen
  "info"  indeterminate — the runtime retires the process
          (jepsen/src/jepsen/core.clj:338-355)
Raising an exception is equivalent to "info" with the error recorded
(core.clj:199-232), unless it's a ClientFailed, which maps to "fail".

Includes the in-memory fakes the reference uses to test the whole
runtime with zero I/O (jepsen/src/jepsen/tests.clj:26-57): AtomRegister
(a lock-protected linearizable CAS register) and AtomClient.

The port's copy of jepsen_tpu.runtime.client, over the port's Op.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from jepsen_tpu_torch.history.ops import Op


class ClientFailed(Exception):
    """Raise from invoke() to mean the op definitely did not happen."""


class Client:
    """Base client: subclass and override. The default implementation
    is a no-op client (client.clj:29-36)."""

    def open(self, test, node) -> "Client":
        return self

    def setup(self, test) -> None:
        pass

    def invoke(self, test, op: Op) -> Op:
        return op.with_(type="ok")

    def teardown(self, test) -> None:
        pass

    def close(self, test) -> None:
        pass


noop = Client


class AtomRegister:
    """Lock-protected in-memory linearizable CAS register — the
    atom-db analog (tests.clj:26-34)."""

    def __init__(self, value: Any = None):
        self._lock = threading.Lock()
        self._value = value

    def read(self) -> Any:
        with self._lock:
            return self._value

    def write(self, v: Any) -> None:
        with self._lock:
            self._value = v

    def cas(self, old: Any, new: Any) -> bool:
        with self._lock:
            if self._value == old:
                self._value = new
                return True
            return False


class AtomClient(Client):
    """Client over an AtomRegister (tests.clj:36-57): linearizable by
    construction, so full-runtime histories must check valid."""

    def __init__(self, register: Optional[AtomRegister] = None):
        self.register = register if register is not None else AtomRegister()

    def open(self, test, node) -> "AtomClient":
        return AtomClient(self.register)

    def invoke(self, test, op: Op) -> Op:
        f = op.f
        if f == "read":
            return op.with_(type="ok", value=self.register.read())
        if f == "write":
            self.register.write(op.value)
            return op.with_(type="ok")
        if f == "cas":
            old, new = op.value
            if self.register.cas(old, new):
                return op.with_(type="ok")
            return op.with_(type="fail")
        raise ValueError(f"unknown op f={f!r}")
