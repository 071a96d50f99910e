"""RESP (REdis Serialization Protocol) client.

The wire protocol of redis and disque — the two RESP-speaking suites
in the reference roster (raftis/src/jepsen/raftis.clj drives redis;
disque/src/jepsen/disque.clj drives disque via a jedis fork). Commands
go as arrays of bulk strings; replies are simple strings, errors,
integers, bulk strings, or (recursively) arrays. Implemented on a raw
socket with a read buffer — no external client library.
"""

from __future__ import annotations

import socket
from typing import Any, List, Optional, Union

CRLF = b"\r\n"


class RespError(Exception):
    """A server -ERR reply (a complete, in-sync frame)."""


class RespProtocolError(ConnectionError):
    """The reply stream is desynced or unintelligible — transport
    family: callers must drop the connection, never complete :fail."""


def encode_command(*args) -> bytes:
    """RESP array-of-bulk-strings encoding of a command."""
    out = [b"*%d" % len(args), CRLF]
    for a in args:
        if isinstance(a, bytes):
            data = a
        else:
            data = str(a).encode()
        out += [b"$%d" % len(data), CRLF, data, CRLF]
    return b"".join(out)


class RespConnection:
    """One RESP connection: call(*args) -> decoded reply.

    Decoding: simple strings and bulk strings come back as str (bulk
    payloads that aren't UTF-8 stay bytes), integers as int, nil bulk/
    array as None, arrays as lists; -ERR raises RespError. A socket
    timeout raises socket.timeout (callers map it to :info/:fail per
    the client contract).
    """

    def __init__(
        self, host: str, port: int, timeout_s: float = 5.0
    ):
        self.sock = socket.create_connection(
            (host, port), timeout=timeout_s
        )
        self._buf = b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "RespConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reply parsing -------------------------------------------------------

    def _read_line(self) -> bytes:
        while CRLF not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("RESP connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(CRLF, 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:  # payload + CRLF
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("RESP connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self) -> Any:
        """Parse one reply. Error frames come back as RespError VALUES
        (not raised): a nested error inside an array must not abort
        the parse mid-frame — the remaining elements would stay unread
        and desync every later reply. call() raises top-level errors.
        """
        line = self._read_line()
        kind, rest = line[:1], line[1:]

        def num(raw: bytes) -> int:
            # A malformed integer/length field means the stream is
            # desynced — classify as a transport error (like the
            # unknown-type-byte case below), NOT a bare ValueError,
            # which clients.py would mistake for an unknown-op
            # programming error and skip the connection reset.
            try:
                return int(raw)
            except ValueError as e:
                raise RespProtocolError(
                    f"malformed RESP number field {raw!r}"
                ) from e

        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            return RespError(rest.decode())
        if kind == b":":
            return num(rest)
        if kind == b"$":
            n = num(rest)
            if n < 0:
                return None
            data = self._read_exact(n)
            try:
                return data.decode()
            except UnicodeDecodeError:
                return data
        if kind == b"*":
            n = num(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        # Unknown type byte: the stream position is lost for good.
        raise RespProtocolError(f"unknown RESP type byte {kind!r}")

    def call(self, *args) -> Any:
        self.sock.sendall(encode_command(*args))
        reply = self._read_reply()
        if isinstance(reply, RespError):
            raise reply
        return reply
