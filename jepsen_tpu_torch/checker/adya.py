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

General micro-op txn histories go to the dependency-graph checker
(txn_graph.TxnGraphChecker restricted to G2-item), as in the reference:
the two-insert bincount cannot see them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from jepsen_tpu_torch.checker.txn_graph import is_txn_value
from jepsen_tpu_torch.utils.util import natural_key


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
    {f: "insert", value: (key, (a_id, b_id))}; ok completions count.

    device: where a micro-op txn history's dependency graph runs (None
    means the CUDA card, "cpu" the torch ops on the CPU); the insert
    counts are host code on every device."""

    def __init__(self, device=None):
        self.device = device

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
                # bincount below can't see these — route them through
                # the dependency-graph plane restricted to G2-item.
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

    def _check_txn_history(self, test, history, opts) -> dict:
        """G2 over general txn histories via the dependency-graph
        checker (classes=("G2-item",)): illegal maps each key carrying
        an rw edge of the minimal witness cycle to the G2-item census
        (distinct rw pairs closed by a cycle); the full graph verdict
        rides along under "txn_graph"."""
        from jepsen_tpu_torch.checker.txn_graph import TxnGraphChecker

        tg = TxnGraphChecker(classes=("G2-item",),
                             device=self.device).check(test, history, opts)
        count = int(tg.get("census", {}).get("G2-item", 0))
        wit = (tg.get("anomalies") or {}).get("G2-item") or {}
        bad_keys = sorted(
            {s["key"] for s in wit.get("steps", ())
             if s["type"] == "rw"},
            key=natural_key,
        )
        n_keys = tg.get("n_keys")
        return {
            "valid?": tg.get("valid?"),
            "key_count": n_keys,
            "legal_count": (
                None if n_keys is None else n_keys - len(bad_keys)
            ),
            "illegal_count": count,
            "illegal": {k: count for k in bad_keys},
            "txn_graph": tg,
        }


def g2_checker(**kw) -> G2Checker:
    return G2Checker(**kw)
