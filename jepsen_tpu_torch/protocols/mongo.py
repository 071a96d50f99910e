"""MongoDB wire driver: OP_QUERY command path with a minimal BSON
codec — the document-cas/transfer role of the mongodb-smartos suite
(mongodb-smartos/src/jepsen/mongodb_smartos/document_cas.clj:40-99),
whose reference client goes through the Java driver.

That era's mongod (3.x) accepts commands as OP_QUERY against
`<db>.$cmd` with numberToReturn=-1 and replies with OP_REPLY carrying
one BSON document — the wire shape implemented here. Commands used:

- find {filter: {_id}, readConcern: majority} -> read
- update [{q: {_id}, u: {$set: {value}}, upsert: true}],
  writeConcern majority -> write
- update [{q: {_id, value: old}, u: {$set: {value: new}}}] -> cas:
  atomic on the server, ok iff nModified == 1 (the reference decides
  by the same counter through its driver).

BSON subset: documents, arrays, utf8 strings, int32/int64, double,
bool, null — all the workloads need. All constants are the public
wire protocol's.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

PORT = 27017

OP_QUERY = 2004
OP_REPLY = 1


class MongoError(Exception):
    """Server-reported command failure (ok: 0) — definite."""


class MongoProtocolError(ConnectionError):
    """Desynced/unparseable stream: transport family."""


# -- BSON --------------------------------------------------------------------


def bson_encode(doc: Dict[str, Any]) -> bytes:
    out = bytearray()
    for k, v in doc.items():
        key = k.encode() + b"\0"
        if isinstance(v, bool):
            out += b"\x08" + key + (b"\x01" if v else b"\x00")
        elif isinstance(v, int):
            if -(2**31) <= v < 2**31:
                out += b"\x10" + key + struct.pack("<i", v)
            else:
                out += b"\x12" + key + struct.pack("<q", v)
        elif isinstance(v, float):
            out += b"\x01" + key + struct.pack("<d", v)
        elif isinstance(v, str):
            raw = v.encode() + b"\0"
            out += b"\x02" + key + struct.pack("<i", len(raw)) + raw
        elif v is None:
            out += b"\x0a" + key
        elif isinstance(v, dict):
            out += b"\x03" + key + bson_encode(v)
        elif isinstance(v, (list, tuple)):
            arr = {str(i): x for i, x in enumerate(v)}
            out += b"\x04" + key + bson_encode(arr)
        else:
            raise TypeError(f"unsupported BSON value {type(v)}")
    return struct.pack("<i", len(out) + 5) + bytes(out) + b"\0"


def bson_decode(buf: bytes, off: int = 0) -> Tuple[Dict[str, Any], int]:
    (total,) = struct.unpack_from("<i", buf, off)
    end = off + total - 1  # trailing NUL
    off += 4
    doc: Dict[str, Any] = {}
    while off < end:
        t = buf[off]
        off += 1
        nul = buf.index(b"\0", off)
        key = buf[off:nul].decode()
        off = nul + 1
        if t == 0x10:
            (val,) = struct.unpack_from("<i", buf, off)
            off += 4
        elif t == 0x12:
            (val,) = struct.unpack_from("<q", buf, off)
            off += 8
        elif t == 0x01:
            (val,) = struct.unpack_from("<d", buf, off)
            off += 8
        elif t == 0x02:
            (n,) = struct.unpack_from("<i", buf, off)
            off += 4
            val = buf[off:off + n - 1].decode()
            off += n
        elif t == 0x08:
            val = bool(buf[off])
            off += 1
        elif t == 0x0A:
            val = None
        elif t == 0x03:
            val, off = bson_decode(buf, off)
        elif t == 0x04:
            sub, off = bson_decode(buf, off)
            val = [sub[str(i)] for i in range(len(sub))]
        else:
            raise MongoProtocolError(f"unsupported BSON type 0x{t:02x}")
        doc[key] = val
    return doc, end + 1


# -- connection --------------------------------------------------------------


class MongoConnection:
    def __init__(self, host: str, port: int = PORT, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout)
        self.sock.settimeout(timeout)
        self._req_id = 0

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("mongo connection closed")
            out += chunk
        return out

    def command(self, db: str, cmd: Dict[str, Any]) -> Dict[str, Any]:
        self._req_id += 1
        coll = f"{db}.$cmd".encode() + b"\0"
        body = (
            struct.pack("<i", 0)  # flags
            + coll
            + struct.pack("<ii", 0, -1)  # skip, numberToReturn
            + bson_encode(cmd)
        )
        header = struct.pack(
            "<iiii", 16 + len(body), self._req_id, 0, OP_QUERY
        )
        self.sock.sendall(header + body)
        (msglen, _rid, resp_to, opcode) = struct.unpack(
            "<iiii", self._read_exact(16)
        )
        rest = self._read_exact(msglen - 16)
        if opcode != OP_REPLY or resp_to != self._req_id:
            raise MongoProtocolError(
                f"bad reply opcode={opcode} to={resp_to}"
            )
        # responseFlags(4) cursorId(8) startingFrom(4) numberReturned(4)
        (n_ret,) = struct.unpack_from("<i", rest, 16)
        if n_ret < 1:
            raise MongoProtocolError("empty command reply")
        doc, _ = bson_decode(rest, 20)
        if not doc.get("ok"):
            raise MongoError(str(doc))
        return doc


_TRANSPORT = (ConnectionError, OSError, EOFError)


class MongoRegisterClient(Client):
    """Document-cas register (document_cas.clj:40-84): one document,
    field "value", majority read/write concerns."""

    def __init__(self, node=None, port: int = PORT,
                 db: str = "jepsen", coll: str = "cas", key: int = 0,
                 timeout: float = 5.0):
        self.node = node
        self.port = port
        self.db = db
        self.coll = coll
        self.key = key
        self.timeout = timeout
        self._conn: Optional[MongoConnection] = None

    def open(self, test, node):
        return MongoRegisterClient(
            node, self.port, self.db, self.coll, self.key, self.timeout
        )

    def conn(self) -> MongoConnection:
        if self._conn is None:
            self._conn = MongoConnection(
                self.node, self.port, self.timeout
            )
        return self._conn

    def _drop(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self, test) -> None:
        self._drop()

    def _update(self, q: Dict[str, Any], u: Dict[str, Any],
                upsert: bool) -> Dict[str, Any]:
        res = self.conn().command(self.db, {
            "update": self.coll,
            "updates": [{"q": q, "u": u, "upsert": upsert}],
            "writeConcern": {"w": "majority"},
        })
        # ok:1 does NOT mean applied-and-durable: classify the two
        # embedded error channels or record false :ok verdicts.
        if res.get("writeConcernError"):
            # Applied on the primary but the majority wait failed: the
            # write may roll back on failover — indeterminate, :info.
            raise RuntimeError(
                f"write concern unsatisfied: {res['writeConcernError']}"
            )
        if res.get("writeErrors"):
            # Per-item rejection: the update did not apply — definite.
            raise MongoError(f"write rejected: {res['writeErrors']}")
        return res

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                doc = self.conn().command(self.db, {
                    "find": self.coll,
                    "filter": {"_id": self.key},
                    "limit": 1,
                    "singleBatch": True,
                    "readConcern": {"level": "majority"},
                })
                batch = doc.get("cursor", {}).get("firstBatch", [])
                val = batch[0].get("value") if batch else None
                return op.with_(type="ok", value=val)
            if op.f == "write":
                self._update(
                    {"_id": self.key},
                    {"$set": {"value": op.value}},
                    upsert=True,
                )
                return op.with_(type="ok")
            if op.f == "cas":
                expected, new = op.value
                res = self._update(
                    {"_id": self.key, "value": expected},
                    {"$set": {"value": new}},
                    upsert=False,
                )
                ok = res.get("nModified", res.get("n", 0)) == 1
                return op.with_(type="ok" if ok else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except MongoError as e:
            raise ClientFailed(str(e))
        except _TRANSPORT:
            self._drop()
            if op.f == "read":
                raise ClientFailed("transport error on read")
            raise  # mutation may have applied: :info
