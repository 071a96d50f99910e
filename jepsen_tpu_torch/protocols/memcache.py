"""Memcache text protocol client — the hazelcast real-wire path.

Hazelcast members expose a memcache-compatible text endpoint on the
member port when started with -Dhazelcast.memcache.enabled=true
(backed by an IMap named "hz_memcache"), which is the one wire
protocol of that era a Python control host can speak to an otherwise
JVM-embedded system (the reference's clients are in-process
data-structure handles, hazelcast/src/jepsen/hazelcast.clj:120-139).

Protocol subset implemented: get / set / add / delete / incr / decr —
enough for a read-write register (IMap values) and an atomic counter.
The endpoint does NOT serve `gets`/`cas`, so compare-and-set and the
CP structures (locks, id-gen) stay on the documented in-memory models;
real mode covers what the wire genuinely reaches, nothing more.

Completion semantics mirror protocols/clients.py: transport errors
desync the reply stream — close, complete reads :fail and mutations
:info; definite server rejections (NOT_STORED, CLIENT_ERROR on an
in-sync stream) complete :fail and keep the connection.
"""

from __future__ import annotations

import socket
from typing import Optional

from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

#: default hazelcast member port (memcache rides the same listener)
PORT = 5701


class McProtocolError(ConnectionError):
    """Reply stream desynced (unparseable frame): transport family."""


class McServerError(Exception):
    """Definite server rejection read off an in-sync stream."""


class MemcacheConnection:
    def __init__(self, host: str, port: int = PORT, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout)
        self.sock.settimeout(timeout)
        self._buf = b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("memcache connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("memcache connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _check_error(self, line: bytes) -> None:
        if line == b"ERROR" or line.startswith(
            (b"CLIENT_ERROR", b"SERVER_ERROR")
        ):
            raise McServerError(line.decode(errors="replace"))

    def get(self, key: str) -> Optional[bytes]:
        self.sock.sendall(f"get {key}\r\n".encode())
        line = self._read_line()
        self._check_error(line)
        if line == b"END":
            return None
        parts = line.split()
        if len(parts) != 4 or parts[0] != b"VALUE":
            raise McProtocolError(f"malformed VALUE line {line!r}")
        try:
            n = int(parts[3])
        except ValueError as e:
            raise McProtocolError(f"malformed length in {line!r}") from e
        data = self._read_exact(n)
        end = self._read_line()
        if end != b"END":
            raise McProtocolError(f"missing END, got {end!r}")
        return data

    def _store(self, verb: str, key: str, value: bytes) -> bool:
        self.sock.sendall(
            f"{verb} {key} 0 0 {len(value)}\r\n".encode()
            + value + b"\r\n"
        )
        line = self._read_line()
        self._check_error(line)
        if line == b"STORED":
            return True
        if line == b"NOT_STORED":
            return False
        raise McProtocolError(f"unexpected store reply {line!r}")

    def set(self, key: str, value: bytes) -> bool:
        return self._store("set", key, value)

    def add(self, key: str, value: bytes) -> bool:
        return self._store("add", key, value)

    def delete(self, key: str) -> bool:
        self.sock.sendall(f"delete {key}\r\n".encode())
        line = self._read_line()
        self._check_error(line)
        if line == b"DELETED":
            return True
        if line == b"NOT_FOUND":
            return False
        raise McProtocolError(f"unexpected delete reply {line!r}")

    def _arith(self, verb: str, key: str, n: int) -> Optional[int]:
        self.sock.sendall(f"{verb} {key} {n}\r\n".encode())
        line = self._read_line()
        self._check_error(line)
        if line == b"NOT_FOUND":
            return None
        try:
            return int(line)
        except ValueError as e:
            raise McProtocolError(
                f"unexpected {verb} reply {line!r}"
            ) from e

    def incr(self, key: str, n: int = 1) -> Optional[int]:
        return self._arith("incr", key, n)

    def decr(self, key: str, n: int = 1) -> Optional[int]:
        return self._arith("decr", key, n)


_TRANSPORT = (ConnectionError, OSError, EOFError)


class _McClientBase(Client):
    def __init__(self, node=None, port: int = PORT, timeout: float = 5.0):
        self.node = node
        self.port = port
        self.timeout = timeout
        self._conn: Optional[MemcacheConnection] = None

    def open(self, test, node):
        return type(self)(node=node, port=self.port, timeout=self.timeout)

    def conn(self) -> MemcacheConnection:
        if self._conn is None:
            self._conn = MemcacheConnection(
                self.node, self.port, self.timeout
            )
        return self._conn

    def _drop(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self, test) -> None:
        self._drop()


class MemcacheRegisterClient(_McClientBase):
    """Read-write register over a hazelcast IMap entry. No cas: the
    memcache endpoint has no `gets`/`cas` verbs (module docstring)."""

    def __init__(self, node=None, port: int = PORT, timeout: float = 5.0,
                 key: str = "jepsen-register"):
        super().__init__(node, port, timeout)
        self.key = key

    def open(self, test, node):
        return MemcacheRegisterClient(
            node, self.port, self.timeout, self.key
        )

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                raw = self.conn().get(self.key)
                val = int(raw) if raw is not None else None
                return op.with_(type="ok", value=val)
            if op.f == "write":
                self.conn().set(self.key, str(op.value).encode())
                return op.with_(type="ok")
            raise ValueError(f"unsupported op f={op.f!r} "
                             "(no cas on the memcache endpoint)")
        except McServerError as e:
            # definite rejection, stream still in sync
            raise ClientFailed(str(e))
        except _TRANSPORT:
            self._drop()
            if op.f == "read":
                raise ClientFailed("transport error on read")
            raise  # mutation may have applied: crash to :info


class MemcacheCounterClient(_McClientBase):
    """Counter over atomic incr/decr (the reference's atomic-long
    role). Decrement clamps at zero per the memcache protocol, so the
    workload must stay non-negative (generator discipline)."""

    def __init__(self, node=None, port: int = PORT, timeout: float = 5.0,
                 key: str = "jepsen-counter"):
        super().__init__(node, port, timeout)
        self.key = key

    def open(self, test, node):
        return MemcacheCounterClient(
            node, self.port, self.timeout, self.key
        )

    def setup(self, test) -> None:
        try:
            self.conn().add(self.key, b"0")  # NOT_STORED if racing: fine
        except McServerError:
            pass
        except _TRANSPORT:
            self._drop()

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                raw = self.conn().get(self.key)
                val = int(raw) if raw is not None else 0
                return op.with_(type="ok", value=val)
            if op.f == "add":
                n = int(op.value)
                fn = self.conn().incr if n >= 0 else self.conn().decr
                got = fn(self.key, abs(n))
                if got is None:
                    raise ClientFailed("counter key missing")
                return op.with_(type="ok")
            raise ValueError(f"unsupported op f={op.f!r}")
        except McServerError as e:
            raise ClientFailed(str(e))
        except _TRANSPORT:
            self._drop()
            if op.f == "read":
                raise ClientFailed("transport error on read")
            raise
