"""Causal-consistency checkers.

1. CausalChecker — a causal-order register fold
   (jepsen/src/jepsen/tests/causal.clj:12-110): each process issues a
   causal chain (read-init, write 1, read, write 2, read) against one
   key; every ok op must extend the issuing site's causal order. The
   model steps through ok ops, tracking (value, counter, last_pos);
   writes must write counter+1, reads must observe the current value
   (or nil), and each op must link to the previously seen position.

2. CausalReverseChecker — strict-serializability reverse anomaly
   (jepsen/src/jepsen/tests/causal_reverse.clj): with blind unique-key
   inserts and group reads, a write w_i observed without some w_j whose
   ok strictly preceded w_i's invoke is a violation (T1 < T2 realtime,
   but T2 visible without T1).

Both are single forward folds over the history — O(n) host passes over
small per-key subhistories (these workloads cap per-key ops by
construction); the columnar plane is not needed here.

The port's copy of jepsen_tpu.checker.causal;
tests/test_torch_perf_graphs.py holds the two against each other.
"""

from __future__ import annotations

from typing import Any, List, Optional, Set


class CausalChecker:
    """Causal register fold (causal.clj:33-110). Ops carry value plus
    optional extras: position (this op's position id) and link (the
    position this op causally follows; "init" starts a chain)."""

    def check(self, test, history, opts=None) -> dict:
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        value, counter, last_pos = 0, 0, None
        for op in history.ops:
            if not op.is_ok:
                continue
            link = op.get("link")
            pos = op.get("position")
            if link not in ("init", last_pos):
                return {
                    "valid?": False,
                    "error": f"cannot link {link!r} to last-seen "
                             f"position {last_pos!r}",
                    "op_index": op.index,
                }
            if op.f == "write":
                expect = counter + 1
                if op.value != expect:
                    return {
                        "valid?": False,
                        "error": f"expected value {expect}, attempting "
                                 f"to write {op.value} instead",
                        "op_index": op.index,
                    }
                value, counter, last_pos = op.value, expect, pos
            elif op.f == "read-init":
                if counter == 0 and op.value not in (None, 0):
                    return {
                        "valid?": False,
                        "error": f"expected init value 0, read {op.value}",
                        "op_index": op.index,
                    }
                if op.value is not None and counter != 0 \
                        and op.value != value:
                    return {
                        "valid?": False,
                        "error": f"can't read {op.value} from register "
                                 f"{value}",
                        "op_index": op.index,
                    }
                last_pos = pos
            elif op.f == "read":
                if op.value is not None and op.value != value:
                    return {
                        "valid?": False,
                        "error": f"can't read {op.value} from register "
                                 f"{value}",
                        "op_index": op.index,
                    }
                last_pos = pos
        return {"valid?": True, "counter": counter, "value": value}


class CausalReverseChecker:
    """Strict-serializability reverse-visibility check
    (causal_reverse.clj:21-50 graph + its checker): for each write w,
    the set of writes whose :ok strictly preceded w's :invoke must be
    visible in any read that observes w."""

    def check(self, test, history, opts=None) -> dict:
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        completed: Set[Any] = set()
        expected = {}  # written value -> set of values that must precede
        errors: List[dict] = []
        for op in history.ops:
            if op.f == "write":
                if op.is_invoke:
                    expected[op.value] = set(completed)
                elif op.is_ok:
                    completed.add(op.value)
            elif op.f == "read" and op.is_ok and isinstance(
                op.value, (list, tuple, set)
            ):
                seen = {v for v in op.value if v is not None}
                for v in seen:
                    missing = expected.get(v, set()) - seen
                    if missing:
                        errors.append({
                            "op_index": op.index,
                            "observed": v,
                            "missing": sorted(missing),
                        })
        return {"valid?": not errors, "errors": errors}


def causal_checker() -> CausalChecker:
    return CausalChecker()


def causal_reverse_checker() -> CausalReverseChecker:
    return CausalReverseChecker()
