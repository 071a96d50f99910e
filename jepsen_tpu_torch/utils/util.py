"""Host-side utilities: copies of jepsen_tpu.utils.util's majority and
minority (the nemeses), nemesis_intervals (the timeline and perf
graphs), integer_interval_set_str and natural_key (the reductions and
G2 checkers). The rest of the module has no user in the port yet."""

from __future__ import annotations


def majority(n: int) -> int:
    """Smallest majority of n nodes: majority(5) == 3."""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest minority: minority(5) == 2."""
    return (n - 1) // 2


def nemesis_intervals(history, start_fs=("start",), stop_fs=("stop",)) -> list:
    """Pair nemesis start/stop ops into [start_op, stop_op] intervals.

    FIFO pairing over every nemesis op whose :f matches, regardless of type —
    a nemesis usually goes :start :start :stop :stop (invoke/complete), so the
    first start pairs with the first stop and the second with the second.
    Stops with no outstanding start yield [None, stop]; starts with no stop
    yield [start, None]. Ref: util.clj:635-658.
    """
    from collections import deque

    starts: deque = deque()
    out = []
    for op in history:
        if getattr(op, "process", None) != "nemesis":
            continue
        if op.f in start_fs:
            starts.append(op)
        elif op.f in stop_fs:
            out.append([starts.popleft() if starts else None, op])
    out.extend([[s, None] for s in starts])
    return out


def integer_interval_set_str(xs) -> str:
    """Render a set of integers as compact interval notation, e.g.
    "#{1..3 5 7..9}" (ref: jepsen/src/jepsen/util.clj
    integer-interval-set-str, used by checker set results). Non-integer
    collections render as a plain sorted set string."""
    xs = list(xs)
    if not xs:
        return "#{}"
    if not all(isinstance(x, int) and not isinstance(x, bool) for x in xs):
        return "#{" + " ".join(repr(x) for x in sorted(xs, key=repr)) + "}"
    xs = sorted(set(xs))
    runs = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        runs.append((lo, prev))
        lo = prev = x
    runs.append((lo, prev))
    body = " ".join(
        str(a) if a == b else f"{a}..{b}" for a, b in runs
    )
    return "#{" + body + "}"


def natural_key(v) -> tuple:
    """Deterministic total-order sort key for mixed-type values.

    Numbers sort among themselves by value (bools as 0/1), strings after
    numbers, everything else last by repr. For homogeneous int inputs the
    order matches a plain sort, so hot paths that sort int keys keep their
    results byte-identical. Replaces the ad-hoc try/except sorts that threw
    on e.g. [3, "a"] key mixes.
    """
    if isinstance(v, bool):
        return (0, float(v), 1, "", "")
    if isinstance(v, (int, float)):
        return (0, float(v), 0, "", "")
    if isinstance(v, str):
        return (1, 0.0, 0, v, "")
    return (2, 0.0, 0, type(v).__name__, repr(v))
