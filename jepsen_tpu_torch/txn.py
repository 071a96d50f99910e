"""Micro-op transaction model (a copy of jepsen_tpu.txn).

Transactions are sequences of micro-ops; a micro-op is a tuple
("r", k, v) or ("w", k, v) — the typed core of multi-object histories.
Ref: jepsen txn library: src/jepsen/txn/micro_op.clj:1-33 and
jepsen txn library: README.md:7-70 (states, op interpreters, simulators).

This representation maps directly onto dense tensors: a transaction of m
micro-ops over a history of n txns is an int32 [n, m, 3] block of
(op_code, key, value) rows (op codes: r=0, w=1, append=2; value NIL=-1
for unconstrained reads).
"""

from __future__ import annotations

import random
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

R = "r"
W = "w"
APPEND = "append"

OP_CODES = {R: 0, W: 1, APPEND: 2}
NIL = -1

MicroOp = Tuple[str, Any, Any]


def r(k, v=None) -> MicroOp:
    return (R, k, v)


def w(k, v) -> MicroOp:
    return (W, k, v)


def append(k, v) -> MicroOp:
    """List-append micro-op: push v onto the list at k (Elle's :append)."""
    return (APPEND, k, v)


def op_type(mop: MicroOp) -> str:
    return mop[0]


def key(mop: MicroOp):
    return mop[1]


def value(mop: MicroOp):
    return mop[2]


def is_read(mop: MicroOp) -> bool:
    return mop[0] == R


def is_write(mop: MicroOp) -> bool:
    return mop[0] == W


def reads(txn: Sequence[MicroOp]) -> List[MicroOp]:
    return [m for m in txn if is_read(m)]


def writes(txn: Sequence[MicroOp]) -> List[MicroOp]:
    return [m for m in txn if is_write(m)]


def ext_reads(txn: Sequence[MicroOp]) -> dict:
    """External reads: first read of each key before any write of it.
    Ref: jepsen.txn/ext-reads semantics (txn library)."""
    written = set()
    out = {}
    for f, k, v in txn:
        if f == W or f == APPEND:
            written.add(k)
        elif f == R and k not in written and k not in out:
            out[k] = v
    return out


def ext_writes(txn: Sequence[MicroOp]) -> dict:
    """External writes: last write of each key."""
    out = {}
    for f, k, v in txn:
        if f == W:
            out[k] = v
    return out


# -- state interpreters (ref: txn/README.md "op interpreters") ---------------


def apply_mop(state: dict, mop: MicroOp) -> Tuple[dict, MicroOp]:
    """Apply one micro-op to a key->value state; returns (state', completed
    mop) where reads are filled in with the observed value."""
    f, k, v = mop
    if f == R:
        return state, (R, k, state.get(k))
    if f == W:
        s = dict(state)
        s[k] = v
        return s, mop
    if f == APPEND:
        s = dict(state)
        s[k] = tuple(s.get(k) or ()) + (v,)
        return s, mop
    raise ValueError(f"unknown micro-op type {f!r}")


def apply_txn(state: dict, txn: Sequence[MicroOp]) -> Tuple[dict, list]:
    out = []
    for mop in txn:
        state, done = apply_mop(state, mop)
        out.append(done)
    return state, out


def gen_txn(
    keys: Sequence[Any],
    max_len: int = 4,
    max_value: int = 16,
    rng: Optional[random.Random] = None,
    mode: str = "register",
    counter: Optional[List[int]] = None,
) -> List[MicroOp]:
    """Random transaction generator (simulation aid; ref txn/README.md
    simulators for producing histories at a known isolation level).

    mode="register" emits r/w mops with small random values; mode="append"
    emits r/append mops whose appended values are globally unique (drawn
    from the shared mutable `counter` cell), so every version has exactly
    one writer and wr edges are recoverable (Elle's list-append trick)."""
    rng = rng or random
    n = rng.randint(1, max_len)
    txn = []
    keys = list(keys)
    for _ in range(n):
        k = rng.choice(keys)
        if rng.random() < 0.5:
            txn.append(r(k))
        elif mode == "append":
            if counter is None:
                counter = [0]
            counter[0] += 1
            txn.append(append(k, counter[0]))
        else:
            txn.append(w(k, rng.randint(0, max_value)))
    return txn


# -- tensor view -------------------------------------------------------------


def encode_txns(
    txns: Sequence[Sequence[MicroOp]],
    key_codes: Optional[dict] = None,
    value_codes: Optional[dict] = None,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, dict, dict]:
    """Encode transactions as int32 [n, m, 3] (op, key, value), padded with
    (-1,-1,-1) rows. Returns (tensor, key_codes, value_codes)."""
    key_codes = dict(key_codes or {})
    value_codes = dict(value_codes or {})

    from jepsen_tpu_torch.history.columnar import intern_key

    def kc(k):
        # Canonical (kind, value) keys so True/1 and 0/False stay distinct.
        k = intern_key(k)
        if k not in key_codes:
            key_codes[k] = len(key_codes)
        return key_codes[k]

    def vc(v):
        if v is None:
            return NIL
        v = intern_key(v)
        if v not in value_codes:
            value_codes[v] = len(value_codes)
        return value_codes[v]

    m = max_len or max((len(t) for t in txns), default=0)
    out = np.full((len(txns), m, 3), -1, np.int32)
    for i, t in enumerate(txns):
        if len(t) > m:
            raise ValueError(f"txn {i} longer ({len(t)}) than max_len {m}")
        for j, (f, k, v) in enumerate(t):
            out[i, j, 0] = OP_CODES[f]
            out[i, j, 1] = kc(k)
            out[i, j, 2] = vc(v)
    return out, key_codes, value_codes
