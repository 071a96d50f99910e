"""The flight recorder: a process-wide, per-thread ring-buffer span
recorder for plane crossings and the host stages of a check (stdlib
only). Its records are jepsen_tpu.obs.trace's, with two fields more:
an ``id`` and the ``parent`` span that caused the event.

Design constraints, in order:

1. **Disabled is free.** The recorder ships enabled=False; every
   emission helper's first action is one attribute check on the
   module singleton and an immediate return. No ring is ever
   allocated, no id is drawn, no clock is read: the instrumentation
   stays on the hot paths permanently.
2. **No cross-thread locking on the hot path.** Each thread appends
   to its OWN ring (a plain list) and keeps its OWN stack of open
   span ids; under the GIL a single-owner append is atomic, so
   emission takes no lock. The registry of rings takes a lock only
   on a thread's FIRST emission (ring creation) and in snapshot
   readers.
3. **Bounded memory.** Rings trim themselves (owner-side ``del``)
   back to ``capacity`` once they reach twice it; trimmed events
   count in ``dropped`` so a truncated trace is detectable.
4. **Monotonic clock.** Timestamps are ``time.perf_counter_ns()``:
   spans measure real elapsed wall on one host, immune to wall-clock
   steps.
5. **Cause.** Every event carries an ``id``, unique in the process,
   and ``parent``: the id of the innermost span open on the same
   thread when it was emitted (None at the top). A stage's self time
   is its span's duration minus its children's.
6. **One timeline with the device.** While a ``torch.profiler``
   capture is recording, each span also opens a
   ``torch.profiler.record_function`` annotation of its name for its
   duration, so the profiler's trace holds the program's spans on its
   own clock, above the CUDA kernels. torch is looked up in
   ``sys.modules``, never imported: with no capture running a span
   touches nothing of torch beyond reading one flag. Instants are not
   mirrored.

Event records are plain dicts (the export layer's wire shape)::

    {"name", "kind", "ph": "X"|"i", "ts": ns, "dur": ns (X only),
     "id", "parent", "tid", "tname", "args": {...}}

Emission discipline: ``span(...)`` is ALWAYS used as a context
manager, and never while holding a plane lock.
"""

from __future__ import annotations

import functools
import itertools
import sys
import threading
import time
from typing import Any, Dict, List, Optional

#: default ring capacity per thread (events kept after a trim)
DEFAULT_CAPACITY = 1 << 16

#: event ids, unique in the process (count's next() is atomic under
#: the GIL)
_ids = itertools.count(1)


class _NoopSpan:
    """The disabled-mode span: a process-wide singleton whose enter/
    exit/set do nothing and allocate nothing (``__slots__ = ()``)."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


def _profiler_annotation(name: str):
    """An entered ``torch.profiler.record_function(name)`` while a
    torch.profiler capture is recording, else None. Never imports
    torch: without it in sys.modules there is no capture."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """A live duration span. ``__enter__`` draws its id, takes the
    innermost open span of the thread as its parent and pushes itself;
    ``__exit__`` pops it and records one complete event into the
    owner thread's ring (no separate begin/end records to pair up)."""

    __slots__ = ("_tracer", "name", "kind", "args", "_t0", "_ent", "_rf",
                 "id", "parent")

    def __init__(self, tracer: "Tracer", name: str, kind: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.kind = kind
        self.args = args

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (admission verdicts,
        response status) to the eventual record."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        ent = self._ent = self._tracer._ent()
        stack = ent["stack"]
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._rf = _profiler_annotation(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._ent["stack"].remove(self.id)
        self._tracer._emit(self._ent, {
            "name": self.name,
            "kind": self.kind,
            "ph": "X",
            "ts": self._t0,
            "dur": t1 - self._t0,
            "id": self.id,
            "parent": self.parent,
            "args": self.args,
        })
        return False


class Tracer:
    """The process-wide recorder. One instance (``TRACER``) lives for
    the process; ``enable()``/``disable()`` flip it."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        #: tid -> {"ring": list, "tname": str, "stack": open span ids};
        #: created lazily on a thread's first emission, under
        #: _rings_lock
        self._rings: Dict[int, dict] = {}
        self._rings_lock = threading.Lock()
        self._local = threading.local()
        self._dropped = 0

    # -- lifecycle -----------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        """Turn recording on (every kind, every emission)."""
        if capacity is not None:
            self.capacity = int(capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every recorded event (rings stay registered — their
        owner threads still hold references, and their open spans
        stay open)."""
        with self._rings_lock:
            for ent in self._rings.values():
                del ent["ring"][:]
            self._dropped = 0

    def clear(self) -> None:
        """Forget rings entirely (test teardown)."""
        with self._rings_lock:
            self._rings.clear()
            self._dropped = 0
        self._local = threading.local()

    # -- emission (hot path) -------------------------------------------

    def _ent(self) -> dict:
        ent = getattr(self._local, "ent", None)
        if ent is None:
            t = threading.current_thread()
            ent = {"ring": [], "tname": t.name, "stack": []}
            with self._rings_lock:
                self._rings[t.ident] = ent
            self._local.ent = ent
        return ent

    def _emit(self, ent: dict, rec: dict) -> None:
        ring = ent["ring"]
        ring.append(rec)
        # owner-side trim: only this thread ever mutates its ring, so
        # the del cannot race another writer; snapshot readers copy
        # under the GIL and tolerate a concurrent trim (they slice)
        if len(ring) >= 2 * self.capacity:
            drop = len(ring) - self.capacity
            del ring[:drop]
            self._dropped += drop

    # -- snapshot readers ----------------------------------------------

    def spans(self) -> List[dict]:
        """Point-in-time copy of every ring, stamped with tid/tname,
        sorted by start timestamp."""
        with self._rings_lock:
            ents = [(tid, e["tname"], e["ring"][:])
                    for tid, e in self._rings.items()]
        out: List[dict] = []
        for tid, tname, ring in ents:
            for rec in ring:
                r = dict(rec)
                r["tid"] = tid
                r["tname"] = tname
                out.append(r)
        out.sort(key=lambda r: r["ts"])
        return out

    def trace_stats(self) -> dict:
        """Counter view for the engine snapshot / metric lines:
        event totals by phase and per-kind counts."""
        evs = self.spans()
        by_kind: Dict[str, int] = {}
        n_spans = n_instants = 0
        for r in evs:
            by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + 1
            if r["ph"] == "X":
                n_spans += 1
            else:
                n_instants += 1
        return {
            "enabled": self.enabled,
            "events": len(evs),
            "spans": n_spans,
            "instants": n_instants,
            "dropped": self._dropped,
            "by_kind": by_kind,
        }


#: THE process-wide recorder; module helpers below are the hot-path
#: entry points (one attribute check when disabled)
TRACER = Tracer()


def enable(capacity: Optional[int] = None) -> None:
    TRACER.enable(capacity)


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def span(name: str, kind: str = "span", **attrs):
    """Open a duration span (ALWAYS ``with span(...):``). Disabled
    mode returns the no-op singleton (no clock read, no record)."""
    if not TRACER.enabled:
        return _NOOP
    return _Span(TRACER, name, kind, attrs)


def traced(name: str, kind: str = "host"):
    """Decorator: each call of the function is one span ``name``
    around its whole body. Disabled, a call costs the attribute check
    and one more frame."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not TRACER.enabled:
                return fn(*args, **kwargs)
            with _Span(TRACER, name, kind, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def instant(name: str, kind: str = "instant", **attrs) -> None:
    """Record a zero-duration event (stat bumps, retries, ejections)
    under the thread's innermost open span."""
    if not TRACER.enabled:
        return
    ent = TRACER._ent()
    stack = ent["stack"]
    TRACER._emit(ent, {
        "name": name,
        "kind": kind,
        "ph": "i",
        "ts": time.perf_counter_ns(),
        "id": next(_ids),
        "parent": stack[-1] if stack else None,
        "args": attrs,
    })


def spans() -> List[dict]:
    return TRACER.spans()


def trace_stats() -> dict:
    return TRACER.trace_stats()
