"""Register history simulators: copies of jepsen_tpu.sim's
gen_register_history and corrupt_history, which chip_smoke.py and the
port's tests use. A simulated linearizable register yields
valid-by-construction histories; `corrupt_history` perturbs one
observation to (usually) break validity. Same seed, same history as the
reference generator.

gen_cas_counter_history has no counterpart there: a contended CAS
counter whose histories are wide (one open op per client) yet keep a
small frontier, the shape that rides the K-frontier ladder.
"""

from __future__ import annotations

import random

from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import fail_op, info_op, invoke_op, ok_op


def gen_register_history(
    rng: random.Random,
    n_ops: int = 20,
    n_procs: int = 3,
    n_values: int = 3,
    p_crash: float = 0.05,
    p_early: float = 0.5,
) -> History:
    """Simulate a real linearizable CAS register under concurrency.

    Each op linearizes either at invocation (probability p_early) or at
    completion — both legal linearization points — so the result is
    valid by construction. Crashed ops (:info) retire their process, as
    the runtime does (ref: jepsen/src/jepsen/core.clj:338-355).
    """
    state = None
    ops = []
    pending = {}  # process -> (f, value, applied?, result)
    procs = list(range(n_procs))
    next_proc = n_procs
    emitted = 0

    def apply(f, v):
        nonlocal state
        if f == "read":
            return True, state
        if f == "write":
            state = v
            return True, v
        if f == "cas":
            if state == v[0]:
                state = v[1]
                return True, v
            return False, v
        raise ValueError(f)

    while emitted < n_ops or pending:
        p = rng.choice(procs)
        if p in pending:
            f, v, applied, res = pending.pop(p)
            if rng.random() < p_crash:
                ops.append(info_op(p, f, v))
                procs.remove(p)  # retire crashed process
                procs.append(next_proc)
                next_proc += 1
                continue
            if not applied:
                okp, res = apply(f, v)
            else:
                okp = res is not False
            if f == "read":
                ops.append(ok_op(p, "read", res))
            elif f == "write":
                ops.append(ok_op(p, "write", v))
            elif okp:
                ops.append(ok_op(p, "cas", v))
            else:
                ops.append(fail_op(p, "cas", v))
        elif emitted < n_ops:
            f = rng.choice(["read", "write", "cas"])
            v = (
                None
                if f == "read"
                else (
                    rng.randrange(n_values)
                    if f == "write"
                    else [rng.randrange(n_values), rng.randrange(n_values)]
                )
            )
            applied, res = False, None
            if rng.random() < p_early:  # linearize at invocation
                okp, res = apply(f, v)
                applied = True
                if f == "cas" and not okp:
                    res = False
            ops.append(invoke_op(p, f, v))
            pending[p] = (f, v, applied, res)
            emitted += 1
    return History(ops)


def corrupt_history(
    h: History, rng: random.Random, n_values: int = 3
) -> History:
    """Flip one ok-read's observed value — usually breaks linearizability
    (differential tests compare verdicts rather than assuming so)."""
    ok_reads = [i for i, o in enumerate(h.ops) if o.is_ok and o.f == "read"]
    if not ok_reads:
        return h
    i = rng.choice(ok_reads)
    old = h.ops[i].value
    choices = [v for v in list(range(n_values)) + [None] if v != old]
    new_ops = list(h.ops)
    new_ops[i] = new_ops[i].with_(value=rng.choice(choices))
    return History(new_ops, indexed=True)


def gen_cas_counter_history(
    rng: random.Random,
    n_rounds: int = 8,
    n_procs: int = 24,
    n_values: int | None = None,
) -> History:
    """Simulate a contended compare-and-set counter (values mod
    n_values, default n_procs + 1). After an initial write of 0, each
    round every client invokes cas(v+i -> v+i+1) for its own i, the
    round's cas ops complete in a random order, all successful (they
    chain: each takes effect right after the previous one), and a read
    then observes the round's final value. The window is n_procs open
    ops, but at each state only one of them can linearize, so the
    frontier stays near n_procs configs. Valid by construction;
    corrupt_history(h, rng, n_values) flips one read and breaks it."""
    nv = n_values if n_values is not None else n_procs + 1
    if nv <= n_procs:
        raise ValueError("n_values must exceed n_procs (the chain of a "
                         "round must not revisit a value)")
    ops = [invoke_op(0, "write", 0), ok_op(0, "write", 0)]
    state = 0
    for _ in range(n_rounds):
        cas = [[(state + i) % nv, (state + i + 1) % nv]
               for i in range(n_procs)]
        for p in range(n_procs):
            ops.append(invoke_op(p, "cas", cas[p]))
        order = list(range(n_procs))
        rng.shuffle(order)
        for p in order:
            ops.append(ok_op(p, "cas", cas[p]))
        state = (state + n_procs) % nv
        ops.append(invoke_op(0, "read", None))
        ops.append(ok_op(0, "read", state))
    return History(ops)
