"""The flight recorder: a process-wide, per-thread ring-buffer span
recorder for plane crossings. A copy of jepsen_tpu.obs.trace (stdlib
only): the same records, rings, kind mask and sampling, so a trace of
either package reads the same.

Design constraints, in order:

1. **Disabled is free.** The recorder ships enabled=False; every
   emission helper's first action is one attribute check on the
   module singleton and an immediate return. No ring is ever
   allocated, no clock is read: the instrumentation stays on the
   dispatch plane's hot paths (stream appends, submit) permanently.
2. **No cross-thread locking on the hot path.** Each thread appends
   to its OWN ring (a plain list); under the GIL a single-owner
   append is atomic, so emission takes no lock. The registry of
   rings takes a lock only on a thread's FIRST emission (ring
   creation) and in snapshot readers.
3. **Bounded memory.** Rings trim themselves (owner-side ``del``)
   back to ``capacity`` once they reach twice it; trimmed events
   count in ``dropped`` so a truncated trace is detectable.
4. **Monotonic clock.** Timestamps are ``time.perf_counter_ns()``:
   spans measure real elapsed wall on one host, immune to wall-clock
   steps.
5. **Production-rate emission is tunable, not all-or-nothing.**
   ``enable(kinds=..., sample_n=N)`` installs a per-kind enable mask
   (kinds outside it emit nothing) and 1-in-N sampling for the kinds
   that remain: every Nth emission records, the rest count in the
   owner ring's ``sampled_out`` metadata (surfaced by trace_stats, so
   a sampled trace is detectable exactly like a trimmed one). The
   sampled-out path reads no clock and touches no ring.

Event records are plain dicts (the export layer's wire shape)::

    {"name", "kind", "ph": "X"|"i", "ts": ns, "dur": ns (X only),
     "tid", "tname", "args": {...}}

Emission discipline: ``span(...)`` is ALWAYS used as a context
manager, and never while holding a plane lock.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

#: default ring capacity per thread (events kept after a trim)
DEFAULT_CAPACITY = 1 << 16


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


class _Span:
    """A live duration span; records itself into the owner thread's
    ring at ``__exit__`` (one complete event — no separate begin/end
    records to pair up)."""

    __slots__ = ("_tracer", "name", "kind", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, kind: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.kind = kind
        self.args = args
        self._t0 = time.perf_counter_ns()

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (admission verdicts,
        response status) to the eventual record."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._tracer._emit({
            "name": self.name,
            "kind": self.kind,
            "ph": "X",
            "ts": self._t0,
            "dur": t1 - self._t0,
            "args": self.args,
        })
        return False


class Tracer:
    """The process-wide recorder. One instance (``TRACER``) lives for
    the process; ``enable()``/``disable()`` flip it."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        #: record only these kinds (None = every kind)
        self.kinds: Optional[frozenset] = None
        #: record every Nth surviving emission (1 = all)
        self.sample_n = 1
        #: tid -> {"ring": list, "tname": str, "seq", "sampled_out"};
        #: created lazily on a thread's first emission, under
        #: _rings_lock
        self._rings: Dict[int, dict] = {}
        self._rings_lock = threading.Lock()
        self._local = threading.local()
        self._dropped = 0

    # -- lifecycle -----------------------------------------------------

    def enable(
        self,
        capacity: Optional[int] = None,
        kinds=None,
        sample_n: Optional[int] = None,
    ) -> None:
        """Turn recording on. ``kinds`` (an iterable of kind strings)
        installs the per-kind enable mask; ``sample_n`` the 1-in-N
        sampler. Omitted knobs RESET to record-everything — a plain
        ``enable()`` is the historical full-fidelity mode."""
        if capacity is not None:
            self.capacity = int(capacity)
        self.kinds = frozenset(kinds) if kinds is not None else None
        self.sample_n = max(int(sample_n), 1) if sample_n else 1
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every recorded event (rings stay registered — their
        owner threads still hold references)."""
        with self._rings_lock:
            for ent in self._rings.values():
                del ent["ring"][:]
                ent["seq"] = 0
                ent["sampled_out"] = 0
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
            ent = {
                "ring": [], "tname": t.name,
                "seq": 0, "sampled_out": 0,
            }
            with self._rings_lock:
                self._rings[t.ident] = ent
            self._local.ent = ent
        return ent

    def _admit(self, kind: str) -> bool:
        """The sampling gate, decided BEFORE any clock read or record
        allocation. Masked-out kinds vanish silently (they were never
        enabled); sampled-out emissions of enabled kinds count in the
        owner ring's metadata so the thinning is visible."""
        if self.kinds is not None and kind not in self.kinds:
            return False
        n = self.sample_n
        if n <= 1:
            return True
        ent = self._ent()
        seq = ent["seq"] = ent["seq"] + 1
        if seq % n:
            ent["sampled_out"] += 1
            return False
        return True

    def _emit(self, rec: dict) -> None:
        ring = self._ent()["ring"]
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
        event totals by phase and per-kind counts, plus the sampling
        config and how many emissions it thinned away."""
        evs = self.spans()
        by_kind: Dict[str, int] = {}
        n_spans = n_instants = 0
        for r in evs:
            by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + 1
            if r["ph"] == "X":
                n_spans += 1
            else:
                n_instants += 1
        with self._rings_lock:
            sampled_out = sum(
                e["sampled_out"] for e in self._rings.values()
            )
        return {
            "enabled": self.enabled,
            "events": len(evs),
            "spans": n_spans,
            "instants": n_instants,
            "dropped": self._dropped,
            "sample_n": self.sample_n,
            "kinds": sorted(self.kinds) if self.kinds is not None else None,
            "sampled_out": sampled_out,
            "by_kind": by_kind,
        }


#: THE process-wide recorder; module helpers below are the hot-path
#: entry points (one attribute check when disabled)
TRACER = Tracer()


def enable(
    capacity: Optional[int] = None,
    kinds=None,
    sample_n: Optional[int] = None,
) -> None:
    TRACER.enable(capacity, kinds=kinds, sample_n=sample_n)


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def span(name: str, kind: str = "span", **attrs):
    """Open a duration span (ALWAYS ``with span(...):``). Disabled mode returns the no-op singleton; so do
    masked-out kinds and sampled-out emissions (no clock read, no
    record)."""
    if not TRACER.enabled:
        return _NOOP
    if not TRACER._admit(kind):
        return _NOOP
    return _Span(TRACER, name, kind, attrs)


def instant(name: str, kind: str = "instant", **attrs) -> None:
    """Record a zero-duration event (stat bumps, retries, ejections)."""
    if not TRACER.enabled:
        return
    if not TRACER._admit(kind):
        return
    TRACER._emit({
        "name": name,
        "kind": kind,
        "ph": "i",
        "ts": time.perf_counter_ns(),
        "args": attrs,
    })


def spans() -> List[dict]:
    return TRACER.spans()


def trace_stats() -> dict:
    return TRACER.trace_stats()
