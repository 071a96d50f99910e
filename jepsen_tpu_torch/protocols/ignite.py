"""Apache Ignite binary thin-client protocol (the 2.x "thin client"
the reference reaches through the Java library — ignite/src/jepsen/
ignite/client.clj's role): TCP port 10800, little-endian framing.

Handshake: [len][op=1][ver 1.1.0 as 3 int16][client_code=2]; success
reply is [len][1]. Requests: [len][op_code int16][request_id int64]
[payload]; responses: [len][request_id int64][status int32][payload].
Cache values are binary-datum encoded (type byte + LE value); the
cache id is the Java String.hashCode of the cache name. All public
protocol constants.

The register client maps read/write/cas onto OP_CACHE_GET /
OP_CACHE_PUT / OP_CACHE_REPLACE_IF_EQUALS — the server-side atomic
compare-and-set, so cas outcomes are the cluster's own verdicts.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Optional

from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

PORT = 10800

#: op codes (public)
OP_CACHE_GET = 1000
OP_CACHE_PUT = 1001
OP_CACHE_REPLACE_IF_EQUALS = 1010
OP_CACHE_GET_OR_CREATE_WITH_NAME = 1052

#: binary datum type codes (public)
T_INT = 3
T_LONG = 4
T_STRING = 9
T_BOOL = 8
T_NULL = 101


class IgniteError(Exception):
    """Nonzero status from the server — definite rejection."""


class IgniteProtocolError(ConnectionError):
    """Desynced/unparseable stream: transport family."""


def java_string_hash(s: str) -> int:
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    if h >= 0x80000000:
        h -= 0x100000000
    return h


def enc(value: Any) -> bytes:
    if value is None:
        return struct.pack("<b", T_NULL)
    if isinstance(value, bool):
        return struct.pack("<bb", T_BOOL, int(value))
    if isinstance(value, int):
        return struct.pack("<bq", T_LONG, value)
    if isinstance(value, str):
        raw = value.encode()
        return struct.pack("<bi", T_STRING, len(raw)) + raw
    raise TypeError(f"unsupported ignite datum {type(value)}")


def dec(buf: bytes, off: int = 0):
    t = struct.unpack_from("<b", buf, off)[0]
    off += 1
    if t == T_NULL:
        return None, off
    if t == T_BOOL:
        return bool(buf[off]), off + 1
    if t == T_INT:
        return struct.unpack_from("<i", buf, off)[0], off + 4
    if t == T_LONG:
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if t == T_STRING:
        (n,) = struct.unpack_from("<i", buf, off)
        off += 4
        return buf[off:off + n].decode(), off + n
    raise IgniteProtocolError(f"unknown datum type {t}")


class IgniteConnection:
    def __init__(self, host: str, port: int = PORT, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout)
        self.sock.settimeout(timeout)
        self._req_id = 0
        payload = struct.pack("<bhhhb", 1, 1, 1, 0, 2)
        self.sock.sendall(struct.pack("<i", len(payload)) + payload)
        resp = self._read_frame()
        if not resp or resp[0] != 1:
            raise IgniteProtocolError(
                f"handshake rejected: {resp[:80]!r}"
            )

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
                raise ConnectionError("ignite connection closed")
            out += chunk
        return out

    def _read_frame(self) -> bytes:
        (n,) = struct.unpack("<i", self._read_exact(4))
        return self._read_exact(n)

    def request(self, op: int, payload: bytes) -> bytes:
        self._req_id += 1
        body = struct.pack("<hq", op, self._req_id) + payload
        self.sock.sendall(struct.pack("<i", len(body)) + body)
        resp = self._read_frame()
        if len(resp) < 12:
            raise IgniteProtocolError(f"short response {resp!r}")
        rid, status = struct.unpack_from("<qi", resp, 0)
        if rid != self._req_id:
            raise IgniteProtocolError(
                f"request id mismatch: {rid} != {self._req_id}"
            )
        if status != 0:
            msg, _ = dec(resp, 12)
            raise IgniteError(f"status {status}: {msg}")
        return resp[12:]

    # -- cache ops -----------------------------------------------------------

    def get_or_create_cache(self, name: str) -> None:
        raw = name.encode()
        self.request(
            OP_CACHE_GET_OR_CREATE_WITH_NAME,
            struct.pack("<bi", T_STRING, len(raw)) + raw,
        )

    def _cache_hdr(self, name: str) -> bytes:
        return struct.pack("<ib", java_string_hash(name), 0)

    def cache_get(self, name: str, key: Any) -> Any:
        out = self.request(
            OP_CACHE_GET, self._cache_hdr(name) + enc(key)
        )
        val, _ = dec(out)
        return val

    def cache_put(self, name: str, key: Any, value: Any) -> None:
        self.request(
            OP_CACHE_PUT, self._cache_hdr(name) + enc(key) + enc(value)
        )

    def cache_replace_if_equals(
        self, name: str, key: Any, expected: Any, new: Any
    ) -> bool:
        out = self.request(
            OP_CACHE_REPLACE_IF_EQUALS,
            self._cache_hdr(name) + enc(key) + enc(expected) + enc(new),
        )
        val, _ = dec(out)
        return bool(val)


_TRANSPORT = (ConnectionError, OSError, EOFError)


class IgniteRegisterClient(Client):
    """Linearizable register on an atomic cache entry
    (ignite/src/jepsen/ignite.clj register role)."""

    def __init__(self, node=None, port: int = PORT,
                 cache: str = "jepsen", key: int = 0,
                 timeout: float = 5.0):
        self.node = node
        self.port = port
        self.cache = cache
        self.key = key
        self.timeout = timeout
        self._conn: Optional[IgniteConnection] = None

    def open(self, test, node):
        return IgniteRegisterClient(
            node, self.port, self.cache, self.key, self.timeout
        )

    def conn(self) -> IgniteConnection:
        if self._conn is None:
            self._conn = IgniteConnection(
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
            self.conn().get_or_create_cache(self.cache)
        except (IgniteError, *_TRANSPORT):
            self._drop()

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                val = self.conn().cache_get(self.cache, self.key)
                return op.with_(type="ok", value=val)
            if op.f == "write":
                self.conn().cache_put(self.cache, self.key, op.value)
                return op.with_(type="ok")
            if op.f == "cas":
                expected, new = op.value
                ok = self.conn().cache_replace_if_equals(
                    self.cache, self.key, expected, new
                )
                return op.with_(type="ok" if ok else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except IgniteError as e:
            # definite server rejection off an in-sync stream
            raise ClientFailed(str(e))
        except _TRANSPORT:
            self._drop()
            if op.f == "read":
                raise ClientFailed("transport error on read")
            raise  # mutation may have applied: :info
