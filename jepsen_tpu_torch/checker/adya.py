"""Adya G2 (anti-dependency cycle) checker (a port of
jepsen_tpu.checker.adya).

Reference semantics: jepsen/src/jepsen/tests/adya.clj:62-88 — the G2
workload issues exactly two predicate-guarded inserts per key (one per
transaction); under serializability at most ONE may commit, because
each transaction's predicate read must observe the other's insert if it
committed first. Two ok inserts for one key witness an anti-dependency
cycle (write-skew on predicates).

The check is a per-key group count over the insert ops, on the
host: the reference has no device program here either. The record-view path below keeps the reference's one-dict-pass
shape; the COLUMNAR path (`encode` -> `G2Plane` -> `check`) is the
framework-native one — per-op key codes and outcome flags as dense int
columns, so the verdict is two bincounts and a comparison, exactly
the plane a columnar history store hands the analyze seam.

General micro-op txn histories go to the reference's dependency-graph
plane (TxnGraphChecker restricted to G2-item), which the port does not
have yet (ROADMAP queue 1 item 6): such a history raises
NotImplementedError rather than being answered by the two-insert
bincount, which cannot see it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from jepsen_tpu_torch.utils.util import natural_key


def is_txn_value(v) -> bool:
    """True when v looks like a txn payload: a non-empty sequence of
    (f, k, v) micro-op triples with f in r/w/append (a copy of
    jepsen_tpu.checker.txn_graph.is_txn_value)."""
    if not isinstance(v, (list, tuple)) or not v:
        return False
    for m in v:
        if not isinstance(m, (list, tuple)) or len(m) != 3:
            return False
        if m[0] not in ("r", "w", "append"):
            return False
    return True


@dataclass
class G2Plane:
    """Columnar view of a G2 insert history: one row per insert op
    (invocations and completions alike)."""

    key_code: np.ndarray  # [n] int32 — dense per-key codes
    is_ok: np.ndarray  # [n] bool — ok completion
    keys: List[Any]  # code -> user-facing key

    def __len__(self) -> int:
        return int(self.key_code.shape[0])


class G2Checker:
    """g2-checker analog (adya.clj:62-88). Ops look like
    {f: "insert", value: (key, (a_id, b_id))}; ok completions count."""

    @staticmethod
    def encode(history) -> G2Plane:
        """Intern insert keys into dense codes (one host pass — part of
        history persistence/precompilation, like events.history_to_events
        for the WGL plane)."""
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        codes: Dict[Any, int] = {}
        keys: List[Any] = []
        kc: List[int] = []
        okc: List[bool] = []
        for o in history.ops:
            v = o.value
            if o.f != "insert" or not isinstance(v, (list, tuple)) \
                    or len(v) != 2:
                continue
            k = v[0]
            c = codes.get(k)
            if c is None:
                c = len(keys)
                codes[k] = c
                keys.append(k)
            kc.append(c)
            okc.append(o.type == "ok")
        return G2Plane(
            key_code=np.asarray(kc, np.int32),
            is_ok=np.asarray(okc, bool),
            keys=keys,
        )

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, G2Plane):
            from jepsen_tpu_torch.history.history import History

            if not isinstance(history, History):
                history = History(list(history))
            if any(
                o.type == "ok" and is_txn_value(o.value)
                for o in history.ops
            ):
                # General micro-op txn history: the two-insert
                # bincount below can't see these. The reference routes
                # them through its dependency-graph plane restricted
                # to G2-item; the port raises until it has that plane.
                return self._check_txn_history(test, history, opts)
        plane = (
            history
            if isinstance(history, G2Plane)
            else self.encode(history)
        )
        n_keys = len(plane.keys)
        if n_keys == 0:
            return {
                "valid?": True,
                "key_count": 0,
                "legal_count": 0,
                "illegal_count": 0,
                "illegal": {},
            }
        # Vectorized group counts: ok inserts per key; every insert op
        # touches its key, so key_count is just the code space.
        ok_counts = np.bincount(
            plane.key_code[plane.is_ok], minlength=n_keys
        )
        bad = np.nonzero(ok_counts > 1)[0]
        pairs = [(plane.keys[i], int(ok_counts[i])) for i in bad]
        # natural key order (adya.clj's sorted map), total over mixed
        # key types
        pairs.sort(key=lambda kv: natural_key(kv[0]))
        illegal = dict(pairs)
        insert_count = int(np.count_nonzero(ok_counts))
        return {
            "valid?": not illegal,
            "key_count": n_keys,
            "legal_count": insert_count - len(illegal),
            "illegal_count": len(illegal),
            "illegal": illegal,
        }

    @staticmethod
    def _check_txn_history(test, history, opts) -> dict:
        """G2 over general txn histories: the reference runs its
        dependency-graph checker (classes=("G2-item",)) here, which the
        port does not have yet."""
        raise NotImplementedError(
            "G2 over micro-op txn histories needs the transactional "
            "dependency-graph checker (txn_graph), not yet ported: "
            "ROADMAP queue 1 item 6"
        )


def g2_checker() -> G2Checker:
    return G2Checker()
