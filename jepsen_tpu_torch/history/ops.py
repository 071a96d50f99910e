"""Operations: the atoms of a history (a copy of jepsen_tpu.history.ops).

An operation is a small record with the same shape as the reference's op maps
(ref: jepsen/src/jepsen/core.clj:299-358 builds them; knossos consumes them):

  type     one of :invoke :ok :fail :info
  f        the function being applied (e.g. :read, :write, :cas, :transfer)
  value    argument/result payload (for :invoke the argument; for :ok the
           result; checkers usually look at the completion's value)
  process  logical process id (int) or "nemesis"
  time     relative nanoseconds since test start
  index    dense position in the history (assigned by History.index())

Semantics that checkers depend on (ref: jepsen/src/jepsen/core.clj:199-232):
  :invoke  a logical process began an operation
  :ok      it completed successfully
  :fail    it definitely did NOT happen
  :info    indeterminate (crash/timeout) — the op may take effect at any
           moment after its invocation, indefinitely; the process is retired
           (ref: jepsen/src/jepsen/core.clj:338-355).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

TYPES = (INVOKE, OK, FAIL, INFO)

NEMESIS = "nemesis"


@dataclass
class Op:
    """One history entry. Mutation is discouraged; use .with_(...)."""

    type: str
    f: Any = None
    value: Any = None
    process: Any = None
    time: int = -1
    index: int = -1
    error: Any = None
    extra: dict = field(default_factory=dict)

    def with_(self, **kw) -> "Op":
        """Functional update (like assoc on the reference's op maps)."""
        extra_updates = {k: v for k, v in kw.items() if k not in _FIELDS}
        base = {k: v for k, v in kw.items() if k in _FIELDS}
        new = replace(self, **base)
        if extra_updates:
            new.extra = {**self.extra, **extra_updates}
        return new

    def get(self, key: str, default=None):
        if key in _FIELDS:
            return getattr(self, key)
        return self.extra.get(key, default)

    # -- type predicates ----------------------------------------------------
    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    @property
    def is_client_op(self) -> bool:
        return isinstance(self.process, int)

    @property
    def is_nemesis_op(self) -> bool:
        return self.process == NEMESIS

    def to_dict(self) -> dict:
        d = {
            "type": self.type,
            "f": self.f,
            "value": self.value,
            "process": self.process,
            "time": self.time,
            "index": self.index,
        }
        if self.error is not None:
            d["error"] = self.error
        d.update(self.extra)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Op":
        extra = {k: v for k, v in d.items() if k not in _FIELDS}
        return cls(
            type=d.get("type"),
            f=d.get("f"),
            value=d.get("value"),
            process=d.get("process"),
            time=d.get("time", -1),
            index=d.get("index", -1),
            error=d.get("error"),
            extra=extra,
        )

    def __repr__(self) -> str:  # compact, log-friendly (ref: util.clj:147-206)
        err = f" err={self.error!r}" if self.error is not None else ""
        return (
            f"Op[{self.index} {self.process}\t{self.type}\t"
            f"{self.f}\t{self.value!r}{err}]"
        )


_FIELDS = {"type", "f", "value", "process", "time", "index", "error"}


def invoke_op(process, f, value=None, **kw) -> Op:
    return Op(type=INVOKE, f=f, value=value, process=process, **kw)


def ok_op(process, f, value=None, **kw) -> Op:
    return Op(type=OK, f=f, value=value, process=process, **kw)


def fail_op(process, f, value=None, **kw) -> Op:
    return Op(type=FAIL, f=f, value=value, process=process, **kw)


def info_op(process, f, value=None, **kw) -> Op:
    return Op(type=INFO, f=f, value=value, process=process, **kw)


def op(d) -> Op:
    """Coerce a dict or Op to an Op."""
    if isinstance(d, Op):
        return d
    return Op.from_dict(d)
