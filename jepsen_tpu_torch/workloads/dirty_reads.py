"""Dirty-reads workload (galera/percona suites).

Reference: galera/src/jepsen/galera/dirty_reads.clj — writers set
EVERY row of an n-row table to their unique value in one serializable
transaction; readers read all rows. The checker
(checker/divergence.DirtyReadsChecker) hunts reads that observed a
FAILED transaction's value (dirty read) and reads whose rows differ
(inconsistent/torn read).

The in-memory client models the table under a lock. weak=True models
the anomaly pair: the 5th write applies half its rows and then aborts
(reported :fail, rows left behind) — every later read observes the
failed value (dirty) through a torn row set (inconsistent), so the
checker's catch is deterministic."""

from __future__ import annotations

import itertools
import random
import threading
from typing import Optional

from jepsen_tpu_torch.checker.divergence import DirtyReadsChecker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client


class _Table:
    def __init__(self, n_rows: int, weak: bool):
        self.rows = [-1] * n_rows
        self.lock = threading.Lock()
        self.weak = weak
        self.write_count = 0


class DirtyReadsClient(Client):
    ABORT_AT = 5

    def __init__(self, table: Optional[_Table] = None,
                 n_rows: int = 8, weak: bool = False):
        self.table = table or _Table(n_rows, weak)

    def open(self, test, node):
        return DirtyReadsClient(self.table)

    def invoke(self, test, op: Op) -> Op:
        t = self.table
        with t.lock:
            if op.f == "read":
                return op.with_(type="ok", value=list(t.rows))
            if op.f == "write":
                t.write_count += 1
                if t.weak and t.write_count == self.ABORT_AT:
                    # half-applied then aborted: rows keep the failed
                    # value — the dirty/torn anomaly pair
                    for i in range(len(t.rows) // 2):
                        t.rows[i] = op.value
                    return op.with_(type="fail")
                for i in range(len(t.rows)):
                    t.rows[i] = op.value
                return op.with_(type="ok")
        raise ValueError(f"unknown op f={op.f!r}")


def generator(n_ops: int = 200, rng: Optional[random.Random] = None):
    rng = rng or random.Random(0)
    counter = itertools.count(1)

    def write():
        return {"f": "write", "value": next(counter)}

    return gen.clients(gen.limit(
        n_ops, gen.mix([write, {"f": "read"}], rng=rng)
    ))


def workload(
    n_ops: int = 200,
    n_rows: int = 8,
    weak: bool = False,
    rng: Optional[random.Random] = None,
) -> dict:
    return {
        "client": DirtyReadsClient(n_rows=n_rows, weak=weak),
        "generator": generator(n_ops, rng),
        "checker": DirtyReadsChecker(),
    }
