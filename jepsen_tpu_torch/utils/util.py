"""Host-side utilities: a copy of jepsen_tpu.utils.util, stdlib only.

Reimplements the load-bearing pieces of jepsen/src/jepsen/util.clj for the
Python control plane: unbounded/bounded parallel map over real threads
(util.clj:46-52; dom-top bounded-pmap), majority (util.clj:59-62), relative
time base (util.clj:276-289), timeout/retry control flow (util.clj:312-494),
nemesis interval pairing (util.clj:635-658), and named locks
(util.clj:736-775).
"""

from __future__ import annotations

import concurrent.futures
import math
import random
import threading
import time as _time
from contextlib import contextmanager
from typing import Any, Callable, Iterable, List, Optional, Sequence


def majority(n: int) -> int:
    """Smallest majority of n nodes: majority(5) == 3."""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest minority: minority(5) == 2."""
    return (n - 1) // 2


def real_pmap(f: Callable, xs: Iterable) -> List:
    """Map f over xs with one real thread each, propagating the first
    exception (ref: util.clj:46-52 / dom-top real-pmap). Unbounded: intended
    for node fan-out, not data parallelism."""
    xs = list(xs)
    if not xs:
        return []
    results: List[Any] = [None] * len(xs)
    errors: List = []
    lock = threading.Lock()

    def run(i, x):
        try:
            results[i] = f(x)
        except BaseException as e:  # noqa: BLE001 - must propagate anything
            with lock:
                errors.append(e)

    threads = [
        threading.Thread(target=run, args=(i, x), daemon=True)
        for i, x in enumerate(xs)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def bounded_pmap(f: Callable, xs: Iterable, bound: Optional[int] = None) -> List:
    """Parallel map bounded to `bound` workers (default: cpu count).
    Ref: dom-top bounded-pmap used by independent.clj:266-288."""
    xs = list(xs)
    if not xs:
        return []
    import os

    bound = bound or min(len(xs), os.cpu_count() or 4)
    with concurrent.futures.ThreadPoolExecutor(max_workers=bound) as ex:
        return list(ex.map(f, xs))


class JepsenTimeout(Exception):
    pass


def timeout(seconds: float, f: Callable, *args, default=JepsenTimeout):
    """Run f in a worker thread; if it exceeds `seconds`, return `default`
    (or raise JepsenTimeout if default is the sentinel). The worker is
    abandoned, mirroring the reference's interrupt-based `timeout` macro
    (util.clj:312-330) under Python's no-kill thread model."""
    result: list = []
    error: list = []

    def run():
        try:
            result.append(f(*args))
        except BaseException as e:  # noqa: BLE001
            error.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        if default is JepsenTimeout:
            raise JepsenTimeout(f"timed out after {seconds}s")
        return default
    if error:
        raise error[0]
    return result[0]


def retry(dt: float, f: Callable, *args):
    """Retry f every dt seconds until it stops throwing
    (ref: util.clj:332-340)."""
    while True:
        try:
            return f(*args)
        except Exception:  # noqa: BLE001
            _time.sleep(dt)


def with_retry(
    f: Callable,
    retries: int = 5,
    backoff: float = 1.0,
    backoff_jitter: float = 0.0,
    retryable: Callable[[Exception], bool] = lambda e: True,
):
    """Call f(); on retryable exceptions, retry up to `retries` times with
    `backoff` (+ uniform jitter) sleeps. Ref: dom-top with-retry usage, e.g.
    control.clj:141-158 SSH retries."""
    attempt = 0
    while True:
        try:
            return f()
        except Exception as e:  # noqa: BLE001
            attempt += 1
            if attempt > retries or not retryable(e):
                raise
            _time.sleep(backoff + random.random() * backoff_jitter)


class RelativeTime:
    """Relative-nanoseconds clock anchored at construction
    (ref: util.clj:276-289 with-relative-time)."""

    def __init__(self):
        self.origin = _time.monotonic_ns()

    def nanos(self) -> int:
        return _time.monotonic_ns() - self.origin

    def seconds(self) -> float:
        return self.nanos() / 1e9


_global_rt: Optional[RelativeTime] = None
_global_rt_lock = threading.Lock()


def relative_time_nanos(reset: bool = False) -> int:
    """Process-global relative clock; first call (or reset=True) anchors it."""
    global _global_rt
    with _global_rt_lock:
        if _global_rt is None or reset:
            _global_rt = RelativeTime()
        return _global_rt.nanos()


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


def longest_common_prefix(seqs: Sequence[Sequence]) -> list:
    if not seqs:
        return []
    out = []
    for vals in zip(*seqs):
        if all(v == vals[0] for v in vals[1:]):
            out.append(vals[0])
        else:
            break
    return out


def fcatch(f: Callable) -> Callable:
    """Wrap f to return exceptions instead of raising
    (ref: util.clj fcatch, used by db.clj:39)."""

    def wrapped(*args, **kw):
        try:
            return f(*args, **kw)
        except Exception as e:  # noqa: BLE001
            return e

    return wrapped


def rand_exp(mean: float, rng: Optional[random.Random] = None) -> float:
    """Exponentially distributed random delay with given mean — the
    distribution behind generator `stagger` (ref: pure.clj stagger docs)."""
    rng = rng or random
    return -math.log(1.0 - rng.random()) * mean


class NamedLocks:
    """A family of locks keyed by name (ref: util.clj:736-775)."""

    def __init__(self):
        self._locks: dict = {}
        self._guard = threading.Lock()

    def lock(self, name) -> threading.Lock:
        with self._guard:
            if name not in self._locks:
                self._locks[name] = threading.Lock()
            return self._locks[name]

    @contextmanager
    def locking(self, name):
        lk = self.lock(name)
        with lk:
            yield


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
