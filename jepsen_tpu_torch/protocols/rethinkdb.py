"""RethinkDB wire driver: the V0_4/JSON client protocol over TCP.

The reference uses the official Clojure driver
(rethinkdb/src/jepsen/rethinkdb.clj:23-25); this speaks the same
public protocol directly: a 4-byte version magic, empty auth key, the
JSON sub-protocol magic, then length-prefixed JSON queries
`[QueryType, term, opts]` with an 8-byte client token, answered by
`{t: response_type, r: [results...]}` frames.

The ReQL term AST is built as nested `[TERM_ID, args, opts]` arrays —
only the handful of terms the document-cas workload needs
(rethinkdb/src/jepsen/rethinkdb/document_cas.clj:72-105): db/table/
get/get_field/default for reads, insert-with-conflict-update for
writes, and update-with-branch(eq(old), {val: new}, error("abort"))
for the atomic cas, whose outcome is decided by the server-reported
`replaced`/`errors` counters exactly as the reference does.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Optional, Tuple

from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

PORT = 28015

#: protocol magics (public ql2 constants)
V0_4 = 0x400C2D20
PROTOCOL_JSON = 0x7E6970C7

#: QueryType
START = 1

#: ResponseType
SUCCESS_ATOM = 1
SUCCESS_SEQUENCE = 2
CLIENT_ERROR = 16
COMPILE_ERROR = 17
RUNTIME_ERROR = 18

#: ReQL term ids (public ql2 constants)
MAKE_ARRAY, VAR, ERROR, DB, TABLE, GET, EQ = 2, 10, 12, 14, 15, 16, 17
GET_FIELD, UPDATE, INSERT, BRANCH, FUNC, DEFAULT = 31, 53, 56, 65, 69, 92
DB_CREATE, TABLE_CREATE = 57, 60


class ReqlError(Exception):
    """Definite server-side rejection (runtime error) — in-sync
    stream, op did not apply."""


class ReqlProtocolError(ConnectionError):
    """Desynced or unparseable reply stream: transport family."""


def db(name: str):
    return [DB, [name]]


def table(d, name: str, read_mode: Optional[str] = None):
    t = [TABLE, [d, name]]
    if read_mode:
        t.append({"read_mode": read_mode})
    return t


def get(tbl, key):
    return [GET, [tbl, key]]


def get_field(row, name: str):
    return [GET_FIELD, [row, name]]


def default(term, value):
    return [DEFAULT, [term, value]]


def insert(tbl, doc: dict, conflict: Optional[str] = None):
    # JSON objects are literal datums in ReQL's JSON serialization.
    t = [INSERT, [tbl, doc]]
    if conflict:
        t.append({"conflict": conflict})
    return t


def cas_update(row, field: str, expected, new):
    """update(row -> branch(row[field] == expected, {field: new},
    error("abort"))) — the reference's atomic cas shape
    (document_cas.clj:93-102)."""
    var = [VAR, [1]]
    cond = [EQ, [get_field(var, field), expected]]
    branch = [BRANCH, [cond, {field: new}, [ERROR, ["abort"]]]]
    fn = [FUNC, [[MAKE_ARRAY, [1]], branch]]
    return [UPDATE, [row, fn]]


class ReqlConnection:
    def __init__(self, host: str, port: int = PORT,
                 timeout: float = 5.0, auth_key: str = ""):
        self.sock = socket.create_connection((host, port), timeout)
        self.sock.settimeout(timeout)
        self._buf = b""
        self._token = 0
        key = auth_key.encode()
        self.sock.sendall(
            struct.pack("<L", V0_4)
            + struct.pack("<L", len(key)) + key
            + struct.pack("<L", PROTOCOL_JSON)
        )
        greeting = self._read_nul_string()
        if greeting != b"SUCCESS":
            raise ReqlProtocolError(
                f"handshake rejected: {greeting[:120]!r}"
            )

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_nul_string(self) -> bytes:
        while b"\0" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("rethinkdb connection closed")
            self._buf += chunk
        s, self._buf = self._buf.split(b"\0", 1)
        return s

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("rethinkdb connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def run(self, term, opts: Optional[dict] = None) -> Any:
        """START the term, return the decoded result list/atom.
        Runtime errors raise ReqlError; client/compile errors are
        programming bugs and raise ValueError."""
        self._token += 1
        token = self._token
        q = json.dumps([START, term, opts or {}]).encode()
        self.sock.sendall(
            struct.pack("<q", token)
            + struct.pack("<L", len(q)) + q
        )
        rtoken = struct.unpack("<q", self._read_exact(8))[0]
        if rtoken != token:
            raise ReqlProtocolError(
                f"token mismatch: sent {token}, got {rtoken}"
            )
        (n,) = struct.unpack("<L", self._read_exact(4))
        try:
            resp = json.loads(self._read_exact(n))
        except ValueError as e:
            raise ReqlProtocolError("unparseable response body") from e
        t = resp.get("t")
        if t in (SUCCESS_ATOM, SUCCESS_SEQUENCE):
            r = resp.get("r", [])
            return r[0] if t == SUCCESS_ATOM and r else r
        if t == RUNTIME_ERROR:
            raise ReqlError(str(resp.get("r")))
        if t in (CLIENT_ERROR, COMPILE_ERROR):
            raise ValueError(f"bad ReQL query: {resp.get('r')}")
        raise ReqlProtocolError(f"unknown response type {t}")


_TRANSPORT = (ConnectionError, OSError, EOFError)


class RethinkRegisterClient(Client):
    """Document-cas over the wire (document_cas.clj:72-105): one
    document per key, field "val", read_mode=majority reads, insert
    conflict=update writes, branch-guarded cas."""

    def __init__(self, node=None, port: int = PORT,
                 db_name: str = "jepsen", tbl: str = "cas",
                 key: Any = 0, read_mode: str = "majority",
                 timeout: float = 5.0):
        self.node = node
        self.port = port
        self.db_name = db_name
        self.tbl = tbl
        self.key = key
        self.read_mode = read_mode
        self.timeout = timeout
        self._conn: Optional[ReqlConnection] = None

    def open(self, test, node):
        return RethinkRegisterClient(
            node, self.port, self.db_name, self.tbl, self.key,
            self.read_mode, self.timeout,
        )

    def conn(self) -> ReqlConnection:
        if self._conn is None:
            self._conn = ReqlConnection(
                self.node, self.port, self.timeout
            )
        return self._conn

    def _drop(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self, test) -> None:
        self._drop()

    def setup(self, test) -> None:
        try:
            c = self.conn()
            try:
                c.run([DB_CREATE, [self.db_name]])
            except ReqlError:
                pass  # exists
            try:
                c.run([TABLE_CREATE, [db(self.db_name), self.tbl]])
            except ReqlError:
                pass  # exists
        except _TRANSPORT:
            self._drop()

    def _row(self):
        return get(
            table(db(self.db_name), self.tbl, self.read_mode), self.key
        )

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                val = self.conn().run(
                    default(get_field(self._row(), "val"), None)
                )
                return op.with_(type="ok", value=val)
            if op.f == "write":
                self.conn().run(insert(
                    table(db(self.db_name), self.tbl),
                    {"id": self.key, "val": op.value},
                    conflict="update",
                ))
                return op.with_(type="ok")
            if op.f == "cas":
                expected, new = op.value
                try:
                    res = self.conn().run(
                        cas_update(self._row(), "val", expected, new)
                    )
                except ReqlError:
                    # the branch's error("abort") — definite miss
                    return op.with_(type="fail")
                ok = (
                    isinstance(res, dict)
                    and res.get("errors") == 0
                    and res.get("replaced") == 1
                )
                return op.with_(type="ok" if ok else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except ReqlError as e:
            # runtime rejection outside cas: reads are safe to fail,
            # mutations did not apply (server evaluated and refused)
            raise ClientFailed(str(e))
        except _TRANSPORT:
            self._drop()
            if op.f == "read":
                raise ClientFailed("transport error on read")
            raise  # mutation may have applied: :info
