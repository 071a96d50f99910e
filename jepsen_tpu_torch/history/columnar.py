"""Columnar tensor view of a history (a copy of
jepsen_tpu.history.columnar, on the port's own History and Op).

The analysis plane consumes histories as dense int32/int64 columns, not
Python records. This is the day-one design decision called out in SURVEY.md §7:
the record view (ops.Op) and the columnar view (this module) are two views of
the same history, and every device checker consumes only the columnar view.

Encoding (one row per op):
  index    int32   dense history position
  type     int32   0=invoke 1=ok 2=fail 3=info
  f        int32   interned function code (per-test Encoder registry)
  process  int32   client process id; -1 for nemesis/non-int processes
  time     int64   relative nanoseconds
  key      int32   independent-key code (-1 when not keyed)
  v0, v1   int32   interned value payload: write v -> (v, NIL); read v ->
                   (v, NIL); cas [u, v] -> (u, v); None -> NIL
  pair     int32   index of the matching completion/invocation (-1 if none)

Design ancestry: jepsen.txn micro-ops are [op k v] int-friendly triples
(jepsen txn library: README.md:7-70); knossos ops carry {:f :value :process}.
Dense int columns make every checker a segment reduction or gather/scatter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, OK, Op

TYPE_CODES = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}
TYPE_NAMES = {v: k for k, v in TYPE_CODES.items()}

NIL = -1  # encoded None / unknown


def intern_key(v):
    """Canonicalize a payload to a hashable interning key: set-workload reads
    are lists, txn payloads can be dicts. Scalars key on (kind, value) so
    True/1 and 0/False intern to distinct codes — int vs float also stay
    distinct, matching the reference's Clojure equality where (= 1 1.0) is
    false — while numpy scalars normalize to their Python kind."""
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return ("bool", bool(v))
    if isinstance(v, (int, np.integer)):
        return ("int", int(v))
    if isinstance(v, (float, np.floating)):
        return ("float", float(v))
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(intern_key(x) for x in v))
    if isinstance(v, (set, frozenset)):
        return ("set", frozenset(intern_key(x) for x in v))
    if isinstance(v, dict):
        return (
            "map",
            tuple(
                sorted(
                    ((intern_key(k), intern_key(x)) for k, x in v.items()),
                    key=repr,
                )
            ),
        )
    return (type(v).__name__, v)


_hashable = intern_key  # backward-compat alias


class Encoder:
    """Interns f symbols and values to dense int32 codes.

    Values are interned in first-seen order starting at 0; None encodes to
    NIL (-1). The mapping is retained for decoding verdict artifacts back to
    user-facing values.
    """

    def __init__(self):
        self.f_codes: Dict[Any, int] = {}
        self.value_codes: Dict[Any, int] = {}
        self._f_rev: List[Any] = []
        self._value_rev: List[Any] = []

    def f_code(self, f) -> int:
        c = self.f_codes.get(f)
        if c is None:
            c = len(self._f_rev)
            self.f_codes[f] = c
            self._f_rev.append(f)
        return c

    def value_code(self, v) -> int:
        if v is None:
            return NIL
        k = _hashable(v)
        c = self.value_codes.get(k)
        if c is None:
            c = len(self._value_rev)
            self.value_codes[k] = c
            self._value_rev.append(v)
        return c

    def decode_f(self, code: int):
        return None if code < 0 else self._f_rev[code]

    def decode_value(self, code: int):
        return None if code < 0 else self._value_rev[code]

    @property
    def n_values(self) -> int:
        return len(self._value_rev)

    #: fs whose 2-element payload is semantically an (old, new) pair and
    #: spreads across (v0, v1). Everything else — including a 2-element
    #: set-workload read — interns as a single value code.
    PAIR_FS = frozenset({"cas", "compare-and-set", "transfer"})

    def encode_payload(self, op: Op) -> tuple:
        """(v0, v1) for an op's value. Only pair-semantics fs (PAIR_FS, e.g.
        cas [old new]) spread across both slots; any other payload — scalar
        or collection — interns whole into v0, so decode is unambiguous."""
        v = op.value
        if v is None:
            return (NIL, NIL)
        if (
            op.f in self.PAIR_FS
            and isinstance(v, (list, tuple))
            and len(v) == 2
        ):
            return (self.value_code(v[0]), self.value_code(v[1]))
        return (self.value_code(v), NIL)


@dataclass
class ColumnarHistory:
    """Dense columns over one history (numpy; feed to torch via
    torch.from_numpy)."""

    index: np.ndarray
    type: np.ndarray
    f: np.ndarray
    process: np.ndarray
    time: np.ndarray
    key: np.ndarray
    v0: np.ndarray
    v1: np.ndarray
    pair: np.ndarray
    encoder: Encoder
    extra: Dict[str, np.ndarray] = field(default_factory=dict)
    #: raw numeric value (int64) for arithmetic checkers (counter, bank);
    #: valid only where num_ok is True — interned codes lose numerics.
    num: np.ndarray = None  # type: ignore[assignment]
    num_ok: np.ndarray = None  # type: ignore[assignment]

    def __len__(self) -> int:
        return int(self.index.shape[0])

    @classmethod
    def from_history(
        cls,
        history: History,
        encoder: Optional[Encoder] = None,
        key_fn=None,
    ) -> "ColumnarHistory":
        """Encode a record history. key_fn(op) -> hashable key or None, for
        independent-keyed histories (ref: jepsen/src/jepsen/independent.clj).
        """
        enc = encoder or Encoder()
        n = len(history)
        idx = np.empty(n, np.int32)
        typ = np.empty(n, np.int32)
        fc = np.empty(n, np.int32)
        proc = np.empty(n, np.int32)
        time = np.empty(n, np.int64)
        key = np.full(n, NIL, np.int32)
        v0 = np.empty(n, np.int32)
        v1 = np.empty(n, np.int32)
        pairc = np.full(n, -1, np.int32)
        num = np.zeros(n, np.int64)
        num_ok = np.zeros(n, bool)

        key_codes: Dict[Any, int] = {}
        pairs = history.pairs()
        for i, op in enumerate(history):
            idx[i] = op.index
            typ[i] = TYPE_CODES[op.type]
            fc[i] = enc.f_code(op.f)
            proc[i] = op.process if isinstance(op.process, int) else -1
            time[i] = op.time
            a, b = enc.encode_payload(op)
            v0[i] = a
            v1[i] = b
            if isinstance(op.value, (int, np.integer)) and not isinstance(
                op.value, bool
            ):
                num[i] = int(op.value)
                num_ok[i] = True
            if key_fn is not None:
                k = key_fn(op)
                if k is not None:
                    kc = key_codes.get(k)
                    if kc is None:
                        kc = len(key_codes)
                        key_codes[k] = kc
                    key[i] = kc
            j = pairs.get(op.index)
            if j is not None:
                pairc[i] = j
        ch = cls(
            index=idx,
            type=typ,
            f=fc,
            process=proc,
            time=time,
            key=key,
            v0=v0,
            v1=v1,
            pair=pairc,
            num=num,
            num_ok=num_ok,
            encoder=enc,
        )
        ch.extra["key_codes"] = key_codes  # type: ignore[assignment]
        return ch

    def select(self, mask: np.ndarray) -> "ColumnarHistory":
        """Row-filter by boolean mask (keeps original indices and pair links,
        which may dangle — checkers that need pairing should re-derive)."""
        return ColumnarHistory(
            index=self.index[mask],
            type=self.type[mask],
            f=self.f[mask],
            process=self.process[mask],
            time=self.time[mask],
            key=self.key[mask],
            v0=self.v0[mask],
            v1=self.v1[mask],
            pair=self.pair[mask],
            num=self.num[mask],
            num_ok=self.num_ok[mask],
            encoder=self.encoder,
            extra=self.extra,
        )
