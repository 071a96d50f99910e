"""Monotonic-insert workload (cockroachdb's monotonic test).

Reference: cockroachdb/src/jepsen/cockroach/monotonic.clj — clients
:add strictly-increasing values; the database stamps each row with its
cluster timestamp (sts); a final :read returns every row in sts order,
and the checker (checker/monotonic.py) verifies the timestamp order
agrees with the value order (clock skew is exactly what breaks this).

The in-memory client models the database: a shared log of
(val, sts, proc) rows under a lock, sts from a monotonic counter. With
skewed=True the "cluster timestamps" jitter backwards occasionally —
the off-order-sts anomaly a clock-skew nemesis induces in the real DB.
"""

from __future__ import annotations

import random
import threading
from typing import Optional

from jepsen_tpu_torch.checker.monotonic import MonotonicChecker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client


class _SharedTable:
    def __init__(self, skewed: bool = False, rng=None):
        self.rows = []  # (val, sts, proc)
        self.sts = 0
        self.lock = threading.Lock()
        self.skewed = skewed
        self.rng = rng or random.Random(0)


class MonotonicClient(Client):
    """In-memory monotonic-insert client (monotonic.clj's client role,
    against the shared table instead of a SQL connection)."""

    def __init__(self, table: Optional[_SharedTable] = None,
                 skewed: bool = False, rng=None):
        self.table = table or _SharedTable(skewed=skewed, rng=rng)

    def open(self, test, node):
        return MonotonicClient(self.table)

    def invoke(self, test, op: Op) -> Op:
        t = self.table
        if op.f == "add":
            # max(val)+1 read and insert in one transaction (the lock),
            # as the reference's txn does (monotonic.clj:57,133) — val
            # order IS commit order; only the timestamp can lie.
            with t.lock:
                val = (max(r[0] for r in t.rows) + 1) if t.rows else 1
                t.sts += 10
                sts = t.sts
                if t.skewed and t.rng.random() < 0.2:
                    sts -= 15  # clock skew: timestamp behind a
                    # previously-committed row's
                t.rows.append((val, sts, op.process))
            return op.with_(type="ok", value={"val": val, "sts": sts})
        if op.f == "read":
            with t.lock:  # "select * order by sts" (monotonic.clj:134)
                rows = sorted(t.rows, key=lambda r: r[1])
            return op.with_(
                type="ok",
                value=[
                    {"val": v, "sts": s, "proc": p} for v, s, p in rows
                ],
            )
        raise ValueError(f"unknown op f={op.f!r}")


def generator(n_ops: int = 200):
    """The add stream (monotonic.clj's main phase)."""
    return gen.clients(gen.limit(n_ops, {"f": "add"}))


def final_generator():
    """One final read per thread, after the adds — composed outside any
    time limit via the runtime's final_generator slot."""
    return gen.clients(gen.each_thread(gen.once({"f": "read"})))


def workload(
    n_ops: int = 200,
    skewed: bool = False,
    rng: Optional[random.Random] = None,
    global_order: bool = True,
) -> dict:
    return {
        "client": MonotonicClient(skewed=skewed, rng=rng),
        "generator": generator(n_ops),
        "final_generator": final_generator(),
        "checker": MonotonicChecker(global_order=global_order),
    }
