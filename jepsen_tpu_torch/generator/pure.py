"""Pure (v2) generators: immutable values that map a context to the next
invocation and evolve functionally.

Reimplements the reference's migration-target design
(jepsen/src/jepsen/generator/pure.clj — the 145-line design essay at
:1-145 and protocol at :153-157), which this framework adopts outright
(SURVEY.md §7.3): a generator is an immutable value; asking it for work
returns both the op and the generator's successor.

    op(gen, test, ctx)      -> (op_map, gen')   next invocation
                               (PENDING, gen')  can't tell yet
                               None             exhausted forever
    update(gen, test, ctx, event) -> gen'       react to invoke/complete

Contexts are plain dicts:

    {"time": int nanos, "free_threads": sorted tuple of idle threads,
     "workers": {thread: process}}

Base generators (pure.clj:211-258): None is the empty generator; a dict
is an op template that fills type/process/time from the context; a
list/tuple runs its elements in order; a callable is invoked with
(test, ctx) (or no args) and may return a dict template, an (op, gen')
pair, or None.

Notable divergences from the reference, on purpose:
- `reserve` is implemented (the reference left it commented out,
  pure.clj:507-570); semantics follow v1 generator.clj:591-651.
- `time_limit` tolerates exhausted/pending children (the reference
  version would NPE on them).
- `mix` and `stagger` accept an explicit random.Random for reproducible
  schedules.
- `limit` does not decrement its budget when the child is PENDING
  (the reference decrements unconditionally, pure.clj:634-639, so a
  pending poll burns an op from the quota); counting only emitted ops
  is the intended semantics here.

The port's copy of jepsen_tpu.generator.pure, stdlib only: the same
contract, op for op (tests/test_torch_generator.py holds the two
against each other on seeded compositions).
"""

from __future__ import annotations

import inspect
import random as _random
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

PENDING = "pending"

NEMESIS = "nemesis"


# -- context helpers (pure.clj:168-206) --------------------------------------


def context(time=0, free_threads=(), workers=None) -> dict:
    return {
        "time": time,
        "free_threads": _sorted_threads(free_threads),
        "workers": dict(workers or {}),
    }


def _thread_key(t):
    # ints sort before named threads like "nemesis"
    return (1, str(t)) if isinstance(t, str) else (0, t)


def _sorted_threads(ts) -> tuple:
    return tuple(sorted(ts, key=_thread_key))


def free_threads(ctx) -> tuple:
    return ctx["free_threads"]


def all_threads(ctx) -> list:
    return list(ctx["workers"].keys())


def free_processes(ctx) -> list:
    w = ctx["workers"]
    return [w[t] for t in ctx["free_threads"]]


def all_processes(ctx) -> list:
    return list(ctx["workers"].values())


def process_to_thread(ctx, process):
    for t, p in ctx["workers"].items():
        if p == process:
            return t
    return None


def next_process(ctx, thread):
    """Process id a thread adopts after its current process crashes:
    current + count of numeric processes (pure.clj:198-206)."""
    if isinstance(thread, str):
        return thread
    numeric = sum(1 for p in all_processes(ctx) if not isinstance(p, str))
    return ctx["workers"][thread] + numeric


def with_free_threads(ctx, ts) -> dict:
    out = dict(ctx)
    out["free_threads"] = _sorted_threads(ts)
    return out


def on_threads_context(pred, ctx) -> dict:
    """Restrict a context to threads satisfying pred
    (pure.clj:372-382)."""
    out = dict(ctx)
    out["free_threads"] = tuple(
        t for t in ctx["free_threads"] if pred(t)
    )
    out["workers"] = {t: p for t, p in ctx["workers"].items() if pred(t)}
    return out


# -- core dispatch (pure.clj:211-258) ----------------------------------------


def _fn_arity(f) -> int:
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return 2
    n = 0
    for p in sig.parameters.values():
        if p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        ):
            n += 1
        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
            return 2
    return n


def op(gen, test, ctx):
    """Ask a generator for its next invocation. Returns (op, gen'),
    (PENDING, gen'), or None."""
    if gen is None:
        return None

    if isinstance(gen, dict):
        fp = free_processes(ctx)
        if fp:
            o = dict(gen)
            o.setdefault("time", ctx["time"])
            o.setdefault("process", fp[0])
            o.setdefault("type", "invoke")
            return (o, gen)
        return (PENDING, gen)

    if isinstance(gen, (list, tuple)):
        rest = list(gen)
        while rest:
            head = rest[0]
            pair = op(head, test, ctx)
            if pair is not None:
                o, g2 = pair
                return (o, [g2] + rest[1:])
            rest = rest[1:]
        return None

    if callable(gen) and not hasattr(gen, "op"):
        x = gen(test, ctx) if _fn_arity(gen) >= 2 else gen()
        if x is None:
            return None
        if isinstance(x, dict):
            pair = op(x, test, ctx)
            return (pair[0], gen)
        if isinstance(x, (list, tuple)) and len(x) == 2:
            return tuple(x)
        raise TypeError(f"function generator returned {x!r}")

    return gen.op(test, ctx)


def update(gen, test, ctx, event):
    """Let a generator react to an invoke/complete event."""
    if gen is None or isinstance(gen, dict) or callable(gen) and not hasattr(gen, "update"):
        return gen
    if isinstance(gen, (list, tuple)):
        return gen  # seqs don't propagate updates (pure.clj:233-236)
    return gen.update(test, ctx, event)


class Generator:
    """Base class for combinator generators (optional — anything with
    .op/.update works)."""

    def op(self, test, ctx):  # pragma: no cover - interface
        raise NotImplementedError

    def update(self, test, ctx, event):
        return self


# -- validate (pure.clj:260-298) ---------------------------------------------


class InvalidOp(Exception):
    def __init__(self, gen, ctx, o, problems):
        super().__init__(f"invalid op {o!r}: {problems}")
        self.gen = gen
        self.ctx = ctx
        self.op = o
        self.problems = problems


class Validate(Generator):
    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        pair = op(self.gen, test, ctx)
        if pair is None:
            return None
        o, g2 = pair
        if o != PENDING:
            problems = []
            if not isinstance(o, dict):
                problems.append("should be either PENDING or a dict")
            else:
                if o.get("type") != "invoke":
                    problems.append("type should be 'invoke'")
                if not isinstance(o.get("time"), (int, float)):
                    problems.append("time is not a number")
                if o.get("process") is None:
                    problems.append("no process")
                elif o["process"] not in free_processes(ctx):
                    problems.append(
                        f"process {o['process']!r} is not free"
                    )
            if problems:
                raise InvalidOp(self.gen, ctx, o, problems)
        return (o, Validate(g2))

    def update(self, test, ctx, event):
        return Validate(update(self.gen, test, ctx, event))


def validate(gen) -> Validate:
    return Validate(gen)


# -- map / f_map / filter / ignore_updates / log (pure.clj:300-370) ----------


class Map(Generator):
    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        pair = op(self.gen, test, ctx)
        if pair is None:
            return None
        o, g2 = pair
        return (o if o == PENDING else self.f(o), Map(self.f, g2))

    def update(self, test, ctx, event):
        return Map(self.f, update(self.gen, test, ctx, event))


def gmap(f, gen) -> Map:
    """Transform ops from gen with f (pure.clj:300-315 map)."""
    return Map(f, gen)


def f_map(mapping: dict, gen) -> Map:
    """Rewrite op :f values through a mapping — for composed nemeses
    (pure.clj:317-323)."""

    def transform(o):
        o = dict(o)
        o["f"] = mapping.get(o.get("f"), o.get("f"))
        return o

    return Map(transform, gen)


class Filter(Generator):
    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        g = self.gen
        while True:
            pair = op(g, test, ctx)
            if pair is None:
                return None
            o, g2 = pair
            if o == PENDING or self.f(o):
                return (o, Filter(self.f, g2))
            g = g2

    def update(self, test, ctx, event):
        return Filter(self.f, update(self.gen, test, ctx, event))


def gfilter(f, gen) -> Filter:
    return Filter(f, gen)


class IgnoreUpdates(Generator):
    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        return op(self.gen, test, ctx)

    def update(self, test, ctx, event):
        return self


def ignore_updates(gen) -> IgnoreUpdates:
    return IgnoreUpdates(gen)


class Log(Generator):
    def __init__(self, msg, logger=None):
        self.msg = msg
        self.logger = logger

    def op(self, test, ctx):
        import logging

        (self.logger or logging.getLogger("jepsen_tpu_torch.generator")).info(
            "%s", self.msg
        )
        return None


def log(msg) -> Log:
    return Log(msg)


# -- thread routing (pure.clj:372-400, 566-590) ------------------------------


class OnThreads(Generator):
    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = gen

    def op(self, test, ctx):
        pair = op(self.gen, test, on_threads_context(self.pred, ctx))
        if pair is None:
            return None
        o, g2 = pair
        return (o, OnThreads(self.pred, g2))

    def update(self, test, ctx, event):
        t = process_to_thread(ctx, event.get("process"))
        if t is not None and self.pred(t):
            return OnThreads(
                self.pred,
                update(
                    self.gen, test, on_threads_context(self.pred, ctx), event
                ),
            )
        return self


def on_threads(pred, gen) -> OnThreads:
    return OnThreads(pred, gen)


on = on_threads


def clients(client_gen, nemesis_gen=None):
    """Route client threads to client_gen (and optionally the nemesis
    thread to nemesis_gen) — pure.clj:572-583."""
    c = on_threads(lambda t: t != NEMESIS, client_gen)
    if nemesis_gen is None:
        return c
    return any_gen(c, nemesis(nemesis_gen))


def nemesis(nemesis_gen, client_gen=None):
    n = on_threads(lambda t: t == NEMESIS, nemesis_gen)
    if client_gen is None:
        return n
    return any_gen(n, clients(client_gen))


# -- any / each-thread (pure.clj:402-504) ------------------------------------


def soonest_op_vec(a, b):
    """Of two (op, ...) tuples, the one whose op occurs first; real ops
    before PENDING before None (pure.clj:402-432)."""
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == PENDING:
        return b
    if b[0] == PENDING:
        return a
    return a if a[0]["time"] <= b[0]["time"] else b


class Any(Generator):
    def __init__(self, gens):
        self.gens = list(gens)

    def op(self, test, ctx):
        soonest = None
        for i, g in enumerate(self.gens):
            pair = op(g, test, ctx)
            if pair is not None:
                soonest = soonest_op_vec(soonest, (pair[0], pair[1], i))
        if soonest is None:
            return None
        o, g2, i = soonest
        gens = list(self.gens)
        gens[i] = g2
        return (o, Any(gens))

    def update(self, test, ctx, event):
        return Any([update(g, test, ctx, event) for g in self.gens])


def any_gen(*gens):
    if len(gens) == 0:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(gens)


class EachThread(Generator):
    """Independent copy of a generator per thread (pure.clj:456-504)."""

    def __init__(self, fresh_gen, gens: Optional[dict] = None):
        self.fresh_gen = fresh_gen
        self.gens = dict(gens or {})

    def op(self, test, ctx):
        free = free_threads(ctx)
        everyone = all_threads(ctx)
        soonest = None
        for t in free:
            g = self.gens.get(t, self.fresh_gen)
            p = ctx["workers"][t]
            tctx = dict(ctx)
            tctx["free_threads"] = (t,)
            tctx["workers"] = {t: p}
            pair = op(g, test, tctx)
            if pair is not None:
                soonest = soonest_op_vec(soonest, (pair[0], pair[1], t))
        if soonest is not None:
            o, g2, t = soonest
            gens = dict(self.gens)
            gens[t] = g2
            return (o, EachThread(self.fresh_gen, gens))
        if len(free) != len(everyone):
            return (PENDING, self)  # busy threads may free up later
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        t = process_to_thread(ctx, event.get("process"))
        if t is None:
            return self
        g = self.gens.get(t, self.fresh_gen)
        tctx = dict(ctx)
        tctx["free_threads"] = tuple(
            x for x in ctx["free_threads"] if x == t
        )
        tctx["workers"] = {t: ctx["workers"][t]}
        gens = dict(self.gens)
        gens[t] = update(g, test, tctx, event)
        return EachThread(self.fresh_gen, gens)


def each_thread(gen) -> EachThread:
    return EachThread(gen)


# -- reserve (v1 generator.clj:591-651; v2 left unfinished) ------------------


class Reserve(Generator):
    """Partition client threads into fixed ranges, each served by its own
    generator, with a default generator for the remainder (incl. the
    nemesis). The reference's v2 sketch is commented out
    (pure.clj:507-570); semantics follow v1 generator.clj:591-651."""

    def __init__(self, ranges: List[frozenset], gens: list, default):
        self.ranges = ranges  # list of frozensets of threads
        self.gens = gens  # generator per range
        self.default = default

    @classmethod
    def build(cls, *args):
        *pairs, default = args
        if len(pairs) % 2:
            raise ValueError(
                "reserve takes count, gen pairs + a default gen"
            )
        counts = pairs[0::2]
        gens = list(pairs[1::2])
        return cls._from_counts(counts, gens, default)

    @classmethod
    def _from_counts(cls, counts, gens, default):
        # Thread ranges are resolved lazily against the context the
        # first time we see it (we don't know the thread pool here).
        return _ReserveUnresolved(list(counts), list(gens), default)

    def _route(self, thread) -> int:
        for i, r in enumerate(self.ranges):
            if thread in r:
                return i
        return len(self.ranges)  # default

    def op(self, test, ctx):
        soonest = None
        claimed = frozenset().union(*self.ranges) if self.ranges else frozenset()
        for i, (r, g) in enumerate([*zip(self.ranges, self.gens)]):
            rctx = on_threads_context(lambda t, r=r: t in r, ctx)
            pair = op(g, test, rctx)
            if pair is not None:
                soonest = soonest_op_vec(soonest, (pair[0], pair[1], i))
        dctx = on_threads_context(lambda t: t not in claimed, ctx)
        pair = op(self.default, test, dctx)
        if pair is not None:
            soonest = soonest_op_vec(
                soonest, (pair[0], pair[1], len(self.ranges))
            )
        if soonest is None:
            return None
        o, g2, i = soonest
        gens = list(self.gens)
        default = self.default
        if i == len(self.ranges):
            default = g2
        else:
            gens[i] = g2
        return (o, Reserve(self.ranges, gens, default))

    def update(self, test, ctx, event):
        t = process_to_thread(ctx, event.get("process"))
        if t is None:
            return self
        i = self._route(t)
        gens = list(self.gens)
        default = self.default
        claimed = frozenset().union(*self.ranges) if self.ranges else frozenset()
        if i == len(self.ranges):
            dctx = on_threads_context(lambda x: x not in claimed, ctx)
            default = update(self.default, test, dctx, event)
        else:
            r = self.ranges[i]
            rctx = on_threads_context(lambda x, r=r: x in r, ctx)
            gens[i] = update(gens[i], test, rctx, event)
        return Reserve(self.ranges, gens, default)


class _ReserveUnresolved(Generator):
    """Reserve before thread ranges are known: resolves against the
    first context it sees, then behaves as Reserve."""

    def __init__(self, counts, gens, default):
        self.counts = counts
        self.gens = gens
        self.default = default

    def _resolve(self, ctx) -> Reserve:
        int_threads = sorted(
            t for t in ctx["workers"] if not isinstance(t, str)
        )
        ranges = []
        lo = 0
        for n in self.counts:
            ranges.append(frozenset(int_threads[lo : lo + n]))
            lo += n
        return Reserve(ranges, list(self.gens), self.default)

    def op(self, test, ctx):
        return self._resolve(ctx).op(test, ctx)

    def update(self, test, ctx, event):
        return self._resolve(ctx).update(test, ctx, event)


def reserve(*args):
    """reserve(5, write_gen, 10, cas_gen, read_gen): first 5 client
    threads draw from write_gen, next 10 from cas_gen, everyone else
    (incl. the nemesis) from read_gen."""
    return Reserve.build(*args)


# -- mix / limit / process-limit / time-limit (pure.clj:605-696) -------------


class Mix(Generator):
    def __init__(self, gens, rng: Optional[_random.Random] = None, i=None):
        self.gens = list(gens)
        self.rng = rng or _random
        self.i = (
            i
            if i is not None
            else (self.rng.randrange(len(self.gens)) if self.gens else 0)
        )

    def op(self, test, ctx):
        if not self.gens:
            return None
        pair = op(self.gens[self.i], test, ctx)
        if pair is not None:
            o, g2 = pair
            gens = list(self.gens)
            gens[self.i] = g2
            return (o, Mix(gens, self.rng, self.rng.randrange(len(gens))))
        gens = self.gens[: self.i] + self.gens[self.i + 1 :]
        if not gens:
            return None
        return Mix(gens, self.rng, self.rng.randrange(len(gens))).op(
            test, ctx
        )

    def update(self, test, ctx, event):
        return self  # mixes ignore updates (pure.clj:618-627)


def mix(gens, rng=None) -> Mix:
    return Mix(list(gens), rng)


class Limit(Generator):
    def __init__(self, remaining, gen):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        pair = op(self.gen, test, ctx)
        if pair is None:
            return None
        o, g2 = pair
        # PENDING doesn't consume the budget.
        n = self.remaining if o == PENDING else self.remaining - 1
        return (o, Limit(n, g2))

    def update(self, test, ctx, event):
        return Limit(self.remaining, update(self.gen, test, ctx, event))


def limit(remaining, gen) -> Limit:
    return Limit(remaining, gen)


def once(gen) -> Limit:
    return Limit(1, gen)


class ProcessLimit(Generator):
    """Emit ops for at most n distinct processes (pure.clj:656-680)."""

    def __init__(self, n, procs: frozenset, gen):
        self.n = n
        self.procs = procs
        self.gen = gen

    def op(self, test, ctx):
        pair = op(self.gen, test, ctx)
        if pair is None:
            return None
        o, g2 = pair
        if o == PENDING:
            return (o, ProcessLimit(self.n, self.procs, g2))
        procs = self.procs | frozenset(all_processes(ctx))
        if len(procs) <= self.n:
            return (o, ProcessLimit(self.n, procs, g2))
        return None

    def update(self, test, ctx, event):
        return ProcessLimit(
            self.n, self.procs, update(self.gen, test, ctx, event)
        )


def process_limit(n, gen) -> ProcessLimit:
    return ProcessLimit(n, frozenset(), gen)


class TimeLimit(Generator):
    def __init__(self, limit_nanos, cutoff, gen):
        self.limit_nanos = limit_nanos
        self.cutoff = cutoff
        self.gen = gen

    def op(self, test, ctx):
        pair = op(self.gen, test, ctx)
        if pair is None:
            return None
        o, g2 = pair
        if o == PENDING:
            return (o, TimeLimit(self.limit_nanos, self.cutoff, g2))
        cutoff = (
            self.cutoff
            if self.cutoff is not None
            else o["time"] + self.limit_nanos
        )
        if o["time"] < cutoff:
            return (o, TimeLimit(self.limit_nanos, cutoff, g2))
        return None

    def update(self, test, ctx, event):
        return TimeLimit(
            self.limit_nanos, self.cutoff, update(self.gen, test, ctx, event)
        )


def time_limit(dt_seconds, gen) -> TimeLimit:
    """Emit ops only during the first dt seconds after the first op
    (pure.clj:682-696)."""
    return TimeLimit(int(dt_seconds * 1e9), None, gen)


# -- timing: stagger / delay-til (pure.clj:698-784) --------------------------


class Stagger(Generator):
    def __init__(self, dt_nanos, gen, rng: Optional[_random.Random] = None):
        self.dt_nanos = dt_nanos
        self.gen = gen
        self.rng = rng or _random

    def op(self, test, ctx):
        pair = op(self.gen, test, ctx)
        if pair is None:
            return None
        o, g2 = pair
        if o != PENDING:
            o = dict(o)
            o["time"] = o["time"] + int(self.rng.random() * self.dt_nanos)
        return (o, Stagger(self.dt_nanos, g2, self.rng))

    def update(self, test, ctx, event):
        return Stagger(
            self.dt_nanos, update(self.gen, test, ctx, event), self.rng
        )


def stagger(dt_seconds, gen, rng=None) -> Stagger:
    """Delay ops by uniform random [0, 2*dt) — dt is the *mean* delay
    across ALL operations, not per thread (pure.clj:710-721)."""
    return Stagger(int(2 * dt_seconds * 1e9), gen, rng)


class DelayTil(Generator):
    def __init__(self, dt_nanos, anchor, gen):
        self.dt_nanos = dt_nanos
        self.anchor = anchor
        self.gen = gen

    def op(self, test, ctx):
        pair = op(self.gen, test, ctx)
        if pair is None:
            return None
        o, g2 = pair
        if o == PENDING:
            return (o, DelayTil(self.dt_nanos, self.anchor, g2))
        t = o["time"]
        anchor = self.anchor if self.anchor is not None else t
        dt = self.dt_nanos
        t = t + (dt - ((t - anchor) % dt)) % dt
        o = dict(o)
        o["time"] = t
        return (o, DelayTil(dt, anchor, g2))

    def update(self, test, ctx, event):
        return DelayTil(
            self.dt_nanos, self.anchor, update(self.gen, test, ctx, event)
        )


def delay_til(dt_seconds, gen) -> DelayTil:
    """Align invocation times to multiples of dt seconds
    (pure.clj:760-784)."""
    return DelayTil(int(dt_seconds * 1e9), None, gen)


class Sleep(Generator):
    """Emits nothing for dt (then exhausts) — the piece v2 left
    unfinished (pure.clj:790-802). Anchors to the context time of its
    first poll; interpreters must commit the successor generator on
    PENDING results for the anchor to stick (the scheduler and the
    simulation harness both do)."""

    def __init__(self, dt_nanos, until=None):
        self.dt_nanos = dt_nanos
        self.until = until

    def op(self, test, ctx):
        until = (
            self.until if self.until is not None
            else ctx["time"] + self.dt_nanos
        )
        if ctx["time"] >= until:
            return None
        return (PENDING, Sleep(self.dt_nanos, until))

    def update(self, test, ctx, event):
        return self


def sleep(dt_seconds) -> Sleep:
    return Sleep(int(dt_seconds * 1e9))


class Repeat(Generator):
    """Cycles a generator factory forever: when the current instance
    exhausts, a fresh one is built — (cycle [...]) in reference suites
    (e.g. the partition nemesis rhythm, etcd.clj:172-176)."""

    def __init__(self, factory: Callable[[], Any], current=None):
        self.factory = factory
        self.current = current

    def op(self, test, ctx):
        current = self.current if self.current is not None \
            else self.factory()
        for _ in range(2):  # one refresh attempt per poll
            pair = op(current, test, ctx)
            if pair is not None:
                o, g2 = pair
                return o, Repeat(self.factory, g2)
            current = self.factory()
        return (PENDING, Repeat(self.factory, current))

    def update(self, test, ctx, event):
        if self.current is None:
            return self
        return Repeat(
            self.factory, update(self.current, test, ctx, event)
        )


def repeat(factory) -> Repeat:
    return Repeat(factory)


# -- barriers: synchronize / phases / then (pure.clj:805-843) ----------------


class Synchronize(Generator):
    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        free = free_threads(ctx)
        everyone = all_threads(ctx)
        if len(free) == len(everyone) and set(free) == set(everyone):
            return op(self.gen, test, ctx)
        return (PENDING, self)

    def update(self, test, ctx, event):
        return Synchronize(update(self.gen, test, ctx, event))


def synchronize(gen) -> Synchronize:
    return Synchronize(gen)


def phases(*gens) -> list:
    """Run each generator to completion in order, with a full barrier
    between phases (pure.clj:828-833)."""
    return [synchronize(g) for g in gens]


def then(a, b):
    """b, then (after a barrier) a — argument order flipped for
    pipeline-style composition (pure.clj:835-843)."""
    return [b, synchronize(a)]
