"""Client-protocol adapters speaking real wire protocols.

The registry suites' real mode (suites/simple.py) uses these instead
of generic in-memory clients wherever the database speaks a protocol
this package implements — the rethinkdb/disque discipline of the
reference (their clients speak the actual wire protocol from the
control node, rethinkdb.clj / disque.clj), applied with RESP.

Completion semantics on a STATEFUL stream (unlike the per-op CLI/HTTP
transports elsewhere in the suites):

- Transport errors (timeout, reset) leave the reply stream desynced:
  the connection is always closed before completing and the next op
  reconnects lazily. Reads then complete :fail (safe — no effect);
  mutations crash to :info (they may have applied).
- A server error reply (-ERR) is a DEFINITE rejection read off an
  in-sync stream: mutations complete :fail and the connection stays.
- Dequeue-family ops that may already have consumed a job when the
  error hits complete :info, never :fail — a :fail would erase the
  consumed element from the history and manufacture false data-loss
  verdicts.
"""

from __future__ import annotations

from typing import Any, List, Optional

from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.protocols.resp import RespConnection, RespError
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

#: CAS as an atomic server-side script (redis has no CAS primitive;
#: EVAL is the standard idiom). KEYS[1]=key ARGV=[old, new].
CAS_LUA = (
    "if redis.call('get', KEYS[1]) == ARGV[1] then "
    "redis.call('set', KEYS[1], ARGV[2]) return 1 else return 0 end"
)

#: transport-level failures: the reply stream is no longer
#: trustworthy (socket.timeout is an OSError subclass)
_TRANSPORT_ERRORS = (ConnectionError, OSError)


class _RespClientBase(Client):
    """Lazy-reconnecting RESP connection management shared by the
    protocol clients: a transport error invalidates the stream (close
    + None) and the next op dials fresh."""

    def __init__(
        self,
        port: int,
        node: Optional[str] = None,
        timeout_s: float = 5.0,
    ):
        self.port = port
        self.node = node
        self.timeout_s = timeout_s
        self._conn: Optional[RespConnection] = None

    def _ensure(self) -> RespConnection:
        if self._conn is None:
            self._conn = RespConnection(
                self.node, self.port, self.timeout_s
            )
        return self._conn

    def _reset(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self, test) -> None:
        self._reset()


class RespRegisterClient(_RespClientBase):
    """Linearizable register over RESP (raftis.clj's redis register
    role): read=GET, write=SET, cas=EVAL CAS_LUA."""

    def __init__(
        self,
        port: int = 6379,
        key: str = "jepsen",
        node: Optional[str] = None,
        timeout_s: float = 5.0,
    ):
        super().__init__(port, node, timeout_s)
        self.key = key

    def open(self, test, node):
        c = RespRegisterClient(
            self.port, self.key, node, self.timeout_s
        )
        c._ensure()
        return c

    def invoke(self, test, op: Op) -> Op:
        try:
            conn = self._ensure()
            if op.f == "read":
                v = conn.call("GET", self.key)
                return op.with_(
                    type="ok", value=None if v is None else int(v)
                )
            if op.f == "write":
                conn.call("SET", self.key, int(op.value))
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                applied = conn.call(
                    "EVAL", CAS_LUA, 1, self.key, int(old), int(new)
                )
                return op.with_(type="ok" if applied else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except RespError as e:
            # Definite server rejection on an in-sync stream.
            if op.f == "read":
                raise ClientFailed(str(e))
            return op.with_(type="fail")
        except _TRANSPORT_ERRORS as e:
            self._reset()  # desynced stream: never reuse
            if op.f == "read":
                raise ClientFailed(str(e))
            raise  # mutations may have applied -> :info


class _JobConsumed(Exception):
    """A job was (possibly) consumed before the error hit: the op's
    outcome is indeterminate — it must complete :info, never :fail."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


class DisqueQueueClient(_RespClientBase):
    """Queue over disque's RESP commands (disque.clj's client role):
    enqueue=ADDJOB (synchronous replication timeout), dequeue=GETJOB
    NOHANG + ACKJOB, drain=dequeue until empty."""

    def __init__(
        self,
        port: int = 7711,
        queue: str = "jepsen",
        node: Optional[str] = None,
        timeout_s: float = 5.0,
        addjob_timeout_ms: int = 1000,
    ):
        super().__init__(port, node, timeout_s)
        self.queue = queue
        self.addjob_timeout_ms = addjob_timeout_ms

    def open(self, test, node):
        c = DisqueQueueClient(
            self.port, self.queue, node, self.timeout_s,
            self.addjob_timeout_ms,
        )
        c._ensure()
        return c

    def _dequeue_one(self, conn: RespConnection) -> Optional[Any]:
        # A failure in THIS call is safe: nothing was consumed yet...
        jobs = conn.call("GETJOB", "NOHANG", "FROM", self.queue)
        if not jobs:
            return None
        # ...but from here a job is in hand — errors are indeterminate
        # (the ACK may or may not have landed server-side).
        try:
            _q, job_id, body = jobs[0][:3]
            conn.call("ACKJOB", job_id)
        except (RespError, *_TRANSPORT_ERRORS) as e:
            raise _JobConsumed(e)
        try:
            return int(body)
        except (TypeError, ValueError):
            return body

    def _drain(self, conn: RespConnection, op: Op) -> Op:
        out: List[Any] = []
        while True:
            try:
                v = self._dequeue_one(conn)
            except _JobConsumed:
                raise
            except (RespError, *_TRANSPORT_ERRORS) as e:
                if out:
                    # Elements already drained are consumed; a :fail
                    # completion would erase them from the history.
                    raise _JobConsumed(e)
                raise
            if v is None:
                return op.with_(type="ok", value=out)
            out.append(v)

    def invoke(self, test, op: Op) -> Op:
        try:
            conn = self._ensure()
            if op.f == "enqueue":
                conn.call(
                    "ADDJOB", self.queue, int(op.value),
                    self.addjob_timeout_ms,
                )
                return op.with_(type="ok")
            if op.f == "dequeue":
                v = self._dequeue_one(conn)
                if v is None:
                    return op.with_(type="fail")
                return op.with_(type="ok", value=v)
            if op.f == "drain":
                return self._drain(conn, op)
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except _JobConsumed as e:
            # Indeterminate: crash to :info; drop the stream if the
            # underlying failure was transport-level.
            if isinstance(e.cause, _TRANSPORT_ERRORS):
                self._reset()
            raise e.cause
        except RespError as e:
            # Definite rejection read off an in-sync stream: the
            # request never took effect.
            if op.f in ("dequeue", "drain"):
                raise ClientFailed(str(e))
            return op.with_(type="fail")
        except _TRANSPORT_ERRORS as e:
            self._reset()
            if op.f in ("dequeue", "drain"):
                # The GETJOB request itself failed: nothing consumed.
                raise ClientFailed(str(e))
            raise  # enqueue may have applied -> :info
