"""Checker protocol, validity lattice, and combinators (a copy of
jepsen_tpu.checker.core).

A checker examines a history and returns a verdict map with at least
``{"valid?": True | False | "unknown"}``. This mirrors the reference's
Checker protocol and its merge semantics
(ref: jepsen/src/jepsen/checker.clj:26-119):

- ``valid?`` forms a lattice  True < "unknown" < False  — a composed
  verdict is False if any part is False, else "unknown" if any part is
  unknown, else True.
- ``compose`` runs a named map of checkers and merges their validity.
- ``check_safe`` converts checker crashes into ``"unknown"`` verdicts so
  one broken checker can't mask the others' results.
- ``concurrency_limit`` bounds how many memory-hungry checks run at once.
"""

from __future__ import annotations

import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Protocol, runtime_checkable

UNKNOWN = "unknown"

#: Lattice rank: higher rank wins when merging (checker.clj:26-47).
_RANK = {True: 0, UNKNOWN: 1, False: 2}


def merge_valid(vals) -> Any:
    """Merge validity values: False dominates, then unknown, then True.

    Ref: jepsen/src/jepsen/checker.clj:38-47 (merge-valid).
    """
    out = True
    for v in vals:
        # Any non-lattice value (e.g. a raw error) degrades to unknown.
        v = v if v in _RANK else UNKNOWN
        if _RANK[v] > _RANK[out]:
            out = v
    return out


@runtime_checkable
class Checker(Protocol):
    """check(test, history, opts) -> verdict dict with "valid?".

    Ref: jepsen/src/jepsen/checker.clj:49-69.
    """

    def check(self, test, history, opts: Optional[dict] = None) -> dict:
        ...


class NoopChecker:
    """Always-valid checker (ref: checker.clj:71-75 unbridled-optimism)."""

    def check(self, test, history, opts=None) -> dict:
        return {"valid?": True}


class FnChecker:
    """Lift a plain function (test, history, opts) -> verdict to a Checker."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def check(self, test, history, opts=None) -> dict:
        return self.fn(test, history, opts)


def check_safe(checker, test, history, opts: Optional[dict] = None) -> dict:
    """Run a checker, converting exceptions into an unknown verdict.

    Ref: jepsen/src/jepsen/checker.clj:77-88 (check-safe).
    """
    try:
        return checker.check(test, history, opts)
    except Exception as e:  # noqa: BLE001 - by design: any crash -> unknown
        return {
            "valid?": UNKNOWN,
            "error": "".join(
                traceback.format_exception(type(e), e, e.__traceback__)
            ),
        }


class ComposeChecker:
    """Run a named map of checkers in parallel and merge their validity.

    Verdict: {"valid?": merged, name: sub-verdict, ...}.
    Ref: jepsen/src/jepsen/checker.clj:90-102 (compose).
    """

    def __init__(self, checkers: Dict[str, Any]):
        self.checkers = dict(checkers)

    def check(self, test, history, opts=None) -> dict:
        names = list(self.checkers)
        with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
            futs = {
                name: ex.submit(
                    check_safe, self.checkers[name], test, history, opts
                )
                for name in names
            }
            results = {name: f.result() for name, f in futs.items()}
        out: dict = {"valid?": merge_valid(r.get("valid?") for r in results.values())}
        out.update(results)
        return out


def compose(checkers: Dict[str, Any]) -> ComposeChecker:
    return ComposeChecker(checkers)


class ConcurrencyLimitChecker:
    """Wrap a checker so at most n instances run concurrently — for
    memory-hungry checkers like linearizability over huge frontiers.
    The semaphore belongs to the wrapper: share ONE wrapper across the
    call sites whose concurrency should be jointly bounded.

    Ref: jepsen/src/jepsen/checker.clj:104-119 (concurrency-limit).
    """

    def __init__(self, limit: int, checker):
        self.limit = limit
        self.checker = checker
        self._sem = threading.Semaphore(limit)

    def check(self, test, history, opts=None) -> dict:
        with self._sem:
            return self.checker.check(test, history, opts)


def concurrency_limit(limit: int, checker) -> ConcurrencyLimitChecker:
    return ConcurrencyLimitChecker(limit, checker)
