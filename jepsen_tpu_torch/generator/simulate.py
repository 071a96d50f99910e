"""Deterministic generator interpreters — the simulation harness.

Ports the reference's pure_test.clj harness (quick-ops at :26-50,
simulate at :57-105), which SURVEY.md §4.2 calls the single most
important testing idea to copy: the whole scheduling loop — invocations,
in-flight completions, crash-driven process retirement — runs as a pure
fold with zero threads and zero clocks, so generator/scheduler behavior
is testable at microsecond scale. The real runtime reproduces exactly
these semantics with actual clients.

Scheduling details faithfully preserved:
- An invocation is emitted when its time is <= the earliest in-flight
  completion's time (ties favor the invocation).
- Among equal-time in-flight completions, the most recently added
  completes first (the reference conj's onto a seq, which prepends
  before the stable sort — tests depend on this LIFO tie-break).
- An :info completion retires the thread's process: the thread adopts
  process + (count of numeric processes), as the real runtime does
  (jepsen/src/jepsen/core.clj:338-355).

The port's copy of jepsen_tpu.generator.simulate, stdlib only.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from jepsen_tpu_torch.generator import pure as gen

PERFECT_LATENCY = 10  # nanos ops take in the perfect interpreters


def default_context() -> dict:
    """Two worker threads and a nemesis (pure_test.clj:10-17)."""
    return gen.context(
        time=0,
        free_threads=(0, 1, gen.NEMESIS),
        workers={0: 0, 1: 1, gen.NEMESIS: gen.NEMESIS},
    )


def invocations(history: List[dict]) -> List[dict]:
    return [o for o in history if o.get("type") == "invoke"]


def quick_ops(g, test=None, ctx: Optional[dict] = None) -> List[dict]:
    """Zero-latency perfect executor: each op completes :ok instantly
    (pure_test.clj:26-50)."""
    test = test or {}
    ctx = ctx or default_context()
    ops: List[dict] = []
    g = gen.validate(g)
    while True:
        pair = gen.op(g, test, ctx)
        if pair is None:
            return ops
        invocation, g = pair
        assert invocation != gen.PENDING, "quick_ops can't block"
        ctx = dict(ctx)
        ctx["time"] = max(ctx["time"], invocation["time"])
        g = gen.update(g, test, ctx, invocation)
        completion = dict(invocation)
        completion["type"] = "ok"
        ctx = dict(ctx)
        ctx["time"] = max(ctx["time"], completion["time"])
        g = gen.update(g, test, ctx, completion)
        ops.append(invocation)
        ops.append(completion)


def quick(g, test=None, ctx=None) -> List[dict]:
    return invocations(quick_ops(g, test, ctx))


def simulate(
    g, complete_fn: Callable[[dict], dict], test=None, ctx=None
) -> List[dict]:
    """Priority-queue executor interleaving invocations with in-flight
    completions produced by complete_fn(invocation)
    (pure_test.clj:57-105)."""
    test = test or {}
    ctx = ctx or default_context()
    ops: List[dict] = []
    in_flight: List[dict] = []  # stable-sorted by time, newest-first ties
    g = gen.validate(g)
    while True:
        pair = gen.op(g, test, ctx)
        if pair is None:
            return ops + in_flight
        invoke, g2 = pair

        if invoke != gen.PENDING and (
            not in_flight or invoke["time"] <= in_flight[0]["time"]
        ):
            # Emit the invocation: mark its thread busy.
            thread = gen.process_to_thread(ctx, invoke["process"])
            ctx = dict(ctx)
            ctx["time"] = max(ctx["time"], invoke["time"])
            ctx["free_threads"] = tuple(
                t for t in ctx["free_threads"] if t != thread
            )
            g = gen.update(g2, test, ctx, invoke)
            complete = complete_fn(invoke)
            # Prepend-then-stable-sort: equal-time completions finish
            # most-recent-first, as in the reference.
            in_flight = sorted(
                [complete] + in_flight, key=lambda o: o["time"]
            )
            ops.append(invoke)
        else:
            # Must complete something first. NOTE: g2 is discarded — the
            # invocation wasn't consumed (reference semantics,
            # pure_test.clj:57-105). Sleep-style generators therefore
            # only anchor correctly under the real-time scheduler, which
            # commits PENDING successors.
            assert in_flight, "generator pending and nothing in flight"
            o = in_flight[0]
            thread = gen.process_to_thread(ctx, o["process"])
            ctx = dict(ctx)
            ctx["time"] = max(ctx["time"], o["time"])
            ctx["free_threads"] = gen._sorted_threads(
                set(ctx["free_threads"]) | {thread}
            )
            g = gen.update(g, test, ctx, o)
            if thread != gen.NEMESIS and o.get("type") == "info":
                # Crash: retire the process (core.clj:338-355).
                workers = dict(ctx["workers"])
                workers[thread] = gen.next_process(ctx, thread)
                ctx["workers"] = workers
            ops.append(o)
            in_flight = in_flight[1:]


def perfect(g, test=None, ctx=None) -> List[dict]:
    """Every op succeeds in PERFECT_LATENCY nanos; returns invocations
    (pure_test.clj:114-124)."""
    return invocations(
        simulate(
            g,
            lambda o: {**o, "type": "ok", "time": o["time"] + PERFECT_LATENCY},
            test,
            ctx,
        )
    )


def perfect_info(g, test=None, ctx=None) -> List[dict]:
    """Every op crashes :info in PERFECT_LATENCY nanos
    (pure_test.clj:126-134)."""
    return invocations(
        simulate(
            g,
            lambda o: {
                **o,
                "type": "info",
                "time": o["time"] + PERFECT_LATENCY,
            },
            test,
            ctx,
        )
    )
