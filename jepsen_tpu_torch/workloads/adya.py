"""Adya G2 workload: predicate-guarded insert pairs.

Reference: jepsen/src/jepsen/tests/adya.clj:12-60 — per key, two
transactions each run a predicate read over both tables and insert into
table a or b only if both predicates saw nothing; serializability
allows at most one to commit. The in-memory G2Client simulates the
predicate-vs-key distinction: in `serializable=True` mode the
read+insert runs under one lock (at most one commit per key); in
`serializable=False` mode the predicate read ignores uncommitted
neighbors — both inserts can commit, the G2 anomaly.

The port's copy of jepsen_tpu.workloads.adya: the generator and the
in-memory client are the reference's; ``_KVG2Checker`` is what the
CLI's ``g2`` workload checks a run with.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict

from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.adya import G2Checker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed


def g2_generator(n_keys: int):
    """Two insert txns per key, two threads per key
    (adya.clj:12-60): op values are KV(key, (a_id, b_id)) with exactly
    one id present."""
    ids = itertools.count(1)

    def per_key(k):
        # Dicts are constant (emit-forever) generators in the pure
        # contract, so each insert is wrapped in once().
        return [
            gen.once({"f": "insert", "value": (None, next(ids))}),
            gen.once({"f": "insert", "value": (next(ids), None)}),
        ]

    return independent.concurrent_generator(2, list(range(n_keys)), per_key)


class G2Client(Client):
    """In-memory G2 table pair."""

    def __init__(self, serializable: bool = True, _shared=None):
        self.serializable = serializable
        if _shared is not None:
            self._lock, self._rows = _shared
        else:
            self._lock = threading.Lock()
            #: key -> set of committed (table, id)
            self._rows: Dict = {}

    def open(self, test, node):
        return G2Client(self.serializable, (self._lock, self._rows))

    def invoke(self, test, op: Op) -> Op:
        kv = op.value
        if not isinstance(kv, independent.KV):
            raise ValueError(f"expected KV value, got {kv!r}")
        k = kv.key
        a_id, b_id = kv.value
        table = "a" if a_id is not None else "b"
        row_id = a_id if a_id is not None else b_id
        if self.serializable:
            with self._lock:
                if self._rows.get(k):
                    raise ClientFailed("predicate read found a row")
                self._rows.setdefault(k, set()).add((table, row_id))
            return op.with_(type="ok")
        # Weak mode: predicate read sees only OUR table's committed
        # rows (stale predicate over the other table) -> both txns of a
        # key can commit, producing the G2 anomaly.
        rows = self._rows.get(k, set())
        if any(t == table for t, _ in rows):
            raise ClientFailed("predicate read found a row")
        with self._lock:
            self._rows.setdefault(k, set()).add((table, row_id))
        return op.with_(type="ok")


def workload(n_keys: int = 20, serializable: bool = True,
             device=None) -> dict:
    """Test-map slots; ``device`` is the checker's (None: the CUDA
    card)."""
    return {
        "client": G2Client(serializable=serializable),
        "generator": g2_generator(n_keys),
        "checker": _KVG2Checker(device=device),
    }


class _KVG2Checker:
    """G2Checker over KV-wrapped values: unwraps (key, (a, b)) pairs
    into the flat (key, ids) shape the checker counts."""

    def __init__(self, device=None):
        self.device = device

    def check(self, test, history, opts=None):
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        flat = [
            o.with_(value=(o.value.key, o.value.value))
            for o in history.ops
            if isinstance(o.value, independent.KV)
        ]
        return G2Checker(device=self.device).check(
            test, History(flat), opts)
