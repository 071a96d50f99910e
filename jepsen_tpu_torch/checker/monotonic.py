"""Monotonic-insert checker (cockroachdb's monotonic workload). A copy
of jepsen_tpu.checker.monotonic (numpy, host).

Reference semantics: cockroachdb/src/jepsen/cockroach/monotonic.clj
:166-238 — clients :add strictly-increasing values stamped with the
database's cluster timestamp (sts); a final :read returns every row.
The checker verifies, over the final read (rows in sts order):

- timestamps non-decreasing in read order (off-order-sts),
- values strictly increasing globally (off-order-vals, only when
  global=True) and per process (off-order-vals-per-process),
- no lost adds (acked but absent), no duplicates, no revived rows
  (failed adds that appear), and reports recovered rows (indeterminate
  adds that appear).

Vectorized design: the final read decomposes into dense (val, sts, proc)
int64 columns; every check above is a vectorized diff / membership test
on those columns (np.diff, np.isin, np.unique) — no per-row Python.
Rows are dicts {val, sts, proc, node, tb} or (val, sts, proc) tuples.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def _col(rows: List[Any], key: str, idx: int) -> np.ndarray:
    if rows and isinstance(rows[0], dict):
        return np.asarray([r.get(key, -1) for r in rows], np.int64)
    return np.asarray([r[idx] for r in rows], np.int64)


def _pairs(vals: np.ndarray, where: np.ndarray) -> List[List[int]]:
    """[prev, cur] value pairs at violation positions (diag artifact)."""
    return [
        [int(vals[i]), int(vals[i + 1])] for i in np.nonzero(where)[0]
    ]


class MonotonicChecker:
    """check-monotonic analog (monotonic.clj:166-238)."""

    def __init__(self, global_order: bool = True):
        self.global_order = global_order

    def check(self, test, history, opts=None) -> dict:
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        adds, fails, infos = [], [], []
        final_read = None
        for o in history.ops:
            if o.f == "add":
                v = o.value
                val = v.get("val") if isinstance(v, dict) else v
                if val is None:
                    continue  # unvalued fail/info add: nothing to track
                if o.type == "ok":
                    adds.append(val)
                elif o.type == "fail":
                    fails.append(val)
                elif o.type == "info":
                    infos.append(val)
            elif o.f == "read" and o.is_ok and o.value is not None:
                final_read = o.value  # last ok read wins
        if final_read is None:
            return {"valid?": "unknown", "error": "Set was never read"}

        rows = list(final_read)
        vals = _col(rows, "val", 0)
        stss = _col(rows, "sts", 1)
        procs = _col(rows, "proc", 2)

        # Vectorized order checks over the sts-ordered read.
        off_sts = _pairs(stss, np.diff(stss) < 0) if len(rows) > 1 else []
        off_vals = (
            _pairs(vals, np.diff(vals) <= 0) if len(rows) > 1 else []
        )
        off_proc: Dict[int, list] = {}
        for p in np.unique(procs):
            pv = vals[procs == p]
            if len(pv) > 1:
                bad = _pairs(pv, np.diff(pv) <= 0)
                if bad:
                    off_proc[int(p)] = bad

        add_set = np.asarray(sorted(set(adds)), np.int64)
        fail_set = np.asarray(sorted(set(fails)), np.int64)
        info_set = np.asarray(sorted(set(infos)), np.int64)
        uniq, counts = np.unique(vals, return_counts=True)
        dups = uniq[counts > 1]
        lost = add_set[~np.isin(add_set, vals)] if len(add_set) else add_set
        revived = fail_set[np.isin(fail_set, vals)]
        recovered = info_set[np.isin(info_set, vals)]

        valid = (
            not len(lost)
            and not len(dups)
            and not len(revived)
            and not off_sts
            and (not off_vals if self.global_order else True)
            and not off_proc
        )
        return {
            "valid?": valid,
            "row_count": len(rows),
            "off_order_sts": off_sts,
            "off_order_vals": off_vals,
            "off_order_vals_per_process": off_proc,
            "lost": [int(x) for x in lost],
            "dups": [int(x) for x in dups],
            "revived": [int(x) for x in revived],
            "recovered": [int(x) for x in recovered],
        }


def monotonic_checker(global_order: bool = True) -> MonotonicChecker:
    return MonotonicChecker(global_order)
