"""RobustIRC client: the robustsession HTTP/JSON API the reference
drives with clj-http (robustirc/src/jepsen/robustirc.clj:102-135) —
RobustIRC replicates an IRC network over Raft and exposes messages
through HTTP, not a raw IRC socket.

API shape (public protocol, mirrored from the reference's calls):
- POST /robustirc/v1/session            -> {Sessionid, Sessionauth}
- POST /robustirc/v1/<sid>/message      {Data, ClientMessageId}
  (ClientMessageId derived from the message digest — retries of the
  same message dedupe server-side, robustirc.clj:111-122)
- GET  /robustirc/v1/<sid>/messages?lastseen=0.0 -> streaming JSON
  objects, one per IRC message.

The log client posts PRIVMSGs to a channel and reads the message
stream back until quiet — the reference's post-message/read-all pair,
checked as SET conservation (a channel is a pub/sub log: every
reader sees every message). Servers speak self-signed TLS on :13001;
tests run the same client against a plain-HTTP fake (tls=False).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import socket
import ssl
from typing import Any, List, Optional

from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

PORT = 13001


class RobustIrcError(Exception):
    """Definite HTTP-level rejection (4xx) — the op did not happen."""


def client_message_id(data: str) -> int:
    """Stable id from the message digest (the reference derives it
    from md5 low bits, robustirc.clj:113-114) so server-side dedupe
    makes retries safe."""
    return int(hashlib.md5(data.encode()).hexdigest()[17:], 16) & (
        (1 << 62) - 1
    )


class RobustIrcSession:
    def __init__(self, host: str, port: int = PORT,
                 timeout: float = 5.0, tls: bool = True):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.tls = tls
        self._http: Optional[http.client.HTTPConnection] = None
        self.sid: Optional[str] = None
        self.auth: Optional[str] = None

    def _connect(self) -> http.client.HTTPConnection:
        if self._http is None:
            if self.tls:
                ctx = ssl._create_unverified_context()
                self._http = http.client.HTTPSConnection(
                    self.host, self.port, timeout=self.timeout,
                    context=ctx,
                )
            else:
                self._http = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout
                )
        return self._http

    def close(self) -> None:
        if self._http is not None:
            try:
                self._http.close()
            except OSError:
                pass
            self._http = None

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> bytes:
        conn = self._connect()
        headers = {"Content-Type": "application/json"}
        if self.auth:
            headers["X-Session-Auth"] = self.auth
        conn.request(
            method, path,
            body=json.dumps(body) if body is not None else None,
            headers=headers,
        )
        resp = conn.getresponse()
        data = resp.read()
        if resp.status >= 500:
            raise ConnectionError(
                f"robustirc {resp.status}: {data[:120]!r}"
            )
        if resp.status >= 400:
            raise RobustIrcError(
                f"robustirc {resp.status}: {data[:120]!r}"
            )
        return data

    def open(self, nick: str, channel: str) -> None:
        out = json.loads(self._request(
            "POST", "/robustirc/v1/session", {}
        ))
        self.sid = out["Sessionid"]
        self.auth = out.get("Sessionauth")
        for line in (
            f"NICK {nick}",
            f"USER {nick} 0 * :{nick}",
            f"JOIN {channel}",
        ):
            self.post(line)

    def post(self, data: str) -> None:
        assert self.sid, "session not open"
        self._request(
            "POST", f"/robustirc/v1/{self.sid}/message",
            {"Data": data, "ClientMessageId": client_message_id(data)},
        )

    def read_messages(self, lastseen: str = "0.0") -> List[dict]:
        """One GET of the message stream, parsed as concatenated JSON
        objects until the server goes quiet (socket timeout) or closes
        — the reference's read-all (robustirc.clj:123-135)."""
        assert self.sid, "session not open"
        conn = self._connect()
        headers = {}
        if self.auth:
            headers["X-Session-Auth"] = self.auth
        conn.request(
            "GET",
            f"/robustirc/v1/{self.sid}/messages?lastseen={lastseen}",
            headers=headers,
        )
        resp = conn.getresponse()
        buf = b""
        try:
            while True:
                chunk = resp.read(65536)
                if not chunk:
                    break
                buf += chunk
        except (socket.timeout, TimeoutError, ssl.SSLError, OSError):
            pass  # stream went quiet: use what arrived
        finally:
            # the streaming GET never cleanly ends mid-session; drop
            # the connection so the next request starts fresh
            self.close()
        msgs = []
        dec = json.JSONDecoder()
        s = buf.decode(errors="replace")
        i = 0
        while i < len(s):
            while i < len(s) and s[i] in " \r\n\t":
                i += 1
            if i >= len(s):
                break
            try:
                obj, j = dec.raw_decode(s, i)
            except ValueError:
                break  # trailing partial object
            msgs.append(obj)
            i = j
        return msgs


_TRANSPORT = (ConnectionError, OSError, EOFError, socket.timeout)


class RobustIrcLogClient(Client):
    """Replicated-log SET semantics over a channel: add = PRIVMSG,
    read = fetch the whole message stream and collect PRIVMSG payloads
    — the reference's post-message / read-all shape
    (robustirc.clj:111-135). An IRC channel is a pub/sub log, not a
    competing-consumer queue: every reader sees every message, so the
    honest workload is set conservation (acked adds must appear in the
    final read), NOT per-op dequeue."""

    def __init__(self, node=None, port: int = PORT,
                 channel: str = "#jepsen", timeout: float = 5.0,
                 tls: bool = True):
        self.node = node
        self.port = port
        self.channel = channel
        self.timeout = timeout
        self.tls = tls
        self._session: Optional[RobustIrcSession] = None

    def open(self, test, node):
        return RobustIrcLogClient(
            node, self.port, self.channel, self.timeout, self.tls
        )

    def session(self) -> RobustIrcSession:
        if self._session is None:
            s = RobustIrcSession(
                self.node, self.port, self.timeout, self.tls
            )
            s.open(f"jepsen-{self.node}", self.channel)
            self._session = s
        return self._session

    def _drop(self) -> None:
        if self._session is not None:
            self._session.close()
            self._session = None

    def close(self, test) -> None:
        self._drop()

    def _payloads(self, msgs: List[dict]) -> List[Any]:
        out = []
        for m in msgs:
            data = m.get("Data", "")
            if "PRIVMSG" in data and " :" in data:
                text = data.split(" :", 1)[1]
                try:
                    out.append(json.loads(text))
                except ValueError:
                    continue  # server notices etc.
        return out

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                self.session().post(
                    f"PRIVMSG {self.channel} :{json.dumps(op.value)}"
                )
                return op.with_(type="ok")
            if op.f == "read":
                vals = self._payloads(self.session().read_messages())
                return op.with_(type="ok", value=vals)
            raise ValueError(f"unknown op f={op.f!r}")
        except RobustIrcError as e:
            raise ClientFailed(str(e))
        except _TRANSPORT:
            self._drop()
            if op.f == "read":
                raise ClientFailed("transport error on read")
            raise  # the add may have applied: :info
