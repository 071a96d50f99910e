"""History simulators: copies of jepsen_tpu.sim's gen_register_history,
corrupt_history, gen_bank_history, gen_long_fork_history,
gen_g2_history and gen_txn_graph_history, and of the unordered-queue
generator of the JAX package's tests (tests/test_queue_device.py
gen_queue_history), which chip_smoke.py and the port's tests use. A
simulated linearizable object yields valid-by-construction histories;
`corrupt_history` perturbs one observation to (usually) break
validity. Same seed, same history as the
reference generators.

gen_cas_counter_history has no counterpart there: a contended CAS
counter whose histories are wide (one open op per client) yet keep a
small frontier, the shape that rides the K-frontier ladder.
overdraw_queue_history breaks a queue history for certain: it dequeues
one value more often than it was ever enqueued.
"""

from __future__ import annotations

import random
from typing import Optional

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


def gen_bank_history(
    rng: random.Random,
    n_ops: int = 1000,
    n_accounts: int = 8,
    total: int = 100,
    max_transfer: int = 5,
    p_read: float = 0.5,
    torn: bool = False,
) -> History:
    """Simulate a bank history (reads sum to total by construction).
    torn=True makes ~10% of reads observe a half-applied transfer —
    the wrong-total anomaly the checker must catch."""
    accounts = list(range(n_accounts))
    per = total // n_accounts
    balances = {a: per for a in accounts}
    balances[0] += total - per * n_accounts
    ops = []
    for i in range(n_ops):
        p = rng.randrange(5)
        if rng.random() < p_read:
            snap = dict(balances)
            if torn and rng.random() < 0.1:
                a, b = rng.sample(accounts, 2)
                snap[a] -= 1  # half-applied transfer
            ops.append(invoke_op(p, "read"))
            ops.append(ok_op(p, "read", snap))
        else:
            a, b = rng.sample(accounts, 2)
            amt = 1 + rng.randrange(max_transfer)
            v = {"from": a, "to": b, "amount": amt}
            ops.append(invoke_op(p, "transfer", v))
            if balances[a] >= amt:
                balances[a] -= amt
                balances[b] += amt
                ops.append(ok_op(p, "transfer", v))
            else:
                ops.append(fail_op(p, "transfer", v))
    return History(ops)


def gen_long_fork_history(
    rng: random.Random,
    n_groups: int = 16,
    ops_per_group: int = 64,
    n: int = 2,
    forked: bool = False,
) -> History:
    """Simulate a long-fork txn history: per group of n keys, writes of
    each key once interleaved with group reads observing a monotone
    prefix of the writes (valid). forked=True plants a GUARANTEED fork
    in ~25% of groups: at the first mixed write state (some but not all
    keys written), two adjacent reads observe the state and its
    inversion — each sees a write the other missed."""

    def emit_read(ops, keys, obs):
        p = rng.randrange(4)
        ops.append(invoke_op(p, "read", [
            ["r", k, None] for k in keys
        ]))
        ops.append(ok_op(p, "read", [
            ["r", keys[i], 1 if obs[i] else None]
            for i in range(len(keys))
        ]))

    ops = []
    for g in range(n_groups):
        keys = [g * n + i for i in range(n)]
        write_order = list(range(n))
        rng.shuffle(write_order)
        written = [0] * n
        w_emitted = 0
        break_group = forked and rng.random() < 0.25
        did_fork = False
        for j in range(ops_per_group):
            p = rng.randrange(4)
            if w_emitted < n and rng.random() < 0.3:
                ki = write_order[w_emitted]
                v = [["w", keys[ki], 1]]
                ops.append(invoke_op(p, "write", v))
                ops.append(ok_op(p, "write", v))
                written[ki] = 1
                w_emitted += 1
            else:
                if (
                    break_group and not did_fork
                    and 0 < sum(written) < n
                ):
                    # Guaranteed fork: the true mixed state and its
                    # inversion are mutually incomparable.
                    emit_read(ops, keys, written)
                    emit_read(ops, keys, [1 - x for x in written])
                    did_fork = True
                else:
                    emit_read(ops, keys, written)
    return History(ops)


def gen_g2_history(rng: random.Random, n_keys: int = 100,
                   weak: bool = False) -> History:
    """Simulate a G2 insert history: two predicate-guarded inserts per
    key, at most one ok (weak=True lets ~5% of keys commit both)."""
    ops = []
    next_id = 1
    for k in range(n_keys):
        a_id, b_id = next_id, next_id + 1
        next_id += 2
        both = weak and rng.random() < 0.05
        winner = rng.randrange(2)
        for side, ident in ((0, a_id), (1, b_id)):
            v = (k, (ident, None) if side == 0 else (None, ident))
            p = rng.randrange(4)
            ops.append(invoke_op(p, "insert", v))
            if both or side == winner:
                ops.append(ok_op(p, "insert", v))
            else:
                ops.append(fail_op(p, "insert", v))
    return History(ops)


def gen_txn_graph_history(
    rng: random.Random,
    n_txns: int = 100,
    keys_per_group: int = 3,
    txns_per_group: int = 12,
    max_len: int = 4,
    anomaly: Optional[str] = None,
    cycle_len: int = 2,
    n_procs: int = 5,
) -> History:
    """Seeded list-append txn histories for the dependency-graph
    checker (checker/txn_graph.py), with plantable cycles.

    The clean base executes random append-mode txns (txn.gen_txn,
    globally unique appended values) SERIALLY against per-group
    in-memory state — groups use disjoint fresh keys, so every
    dependency component is small (<= txns_per_group txns) and, being a
    serial execution, acyclic: the checker must call it valid.

    anomaly plants one cycle of exactly ``cycle_len`` txns on fresh
    keys (an isolated component), appended after the clean base:

      "g1c"      circular wr reads           census G1c=cycle_len
      "g-single" one rw (empty read against an unobserved single
                 append) closing a wr chain  census G-single=1, G2=1
      "g2-item"  rw at BOTH ends of the chain (2 anti-deps, so
                 G-single stays 0)           census G2-item=2
    """
    from jepsen_tpu_torch import txn as txnlib

    if anomaly not in (None, "g1c", "g-single", "g2-item"):
        raise ValueError(f"unknown anomaly {anomaly!r}")
    if cycle_len < 2:
        raise ValueError("planted cycles need cycle_len >= 2")

    ops = []
    counter = [0]
    n_groups = max(1, (n_txns + txns_per_group - 1) // txns_per_group)

    def emit(mops_in, mops_out):
        p = rng.randrange(n_procs)
        ops.append(invoke_op(p, "txn", [list(m) for m in mops_in]))
        ops.append(ok_op(p, "txn", [list(m) for m in mops_out]))

    for g in range(n_groups):
        keys = [g * keys_per_group + j for j in range(keys_per_group)]
        state: dict = {}
        n_here = min(txns_per_group, n_txns - g * txns_per_group)
        for _ in range(max(0, n_here)):
            intents = txnlib.gen_txn(
                keys, max_len=max_len, rng=rng, mode="append",
                counter=counter,
            )
            state, done = txnlib.apply_txn(state, intents)
            emit(
                [(f, k, None if f == txnlib.R else v)
                 for f, k, v in intents],
                [(f, k, list(v) if f == txnlib.R else v)
                 for f, k, v in (
                     (f, k, v or ()) if f == txnlib.R else (f, k, v)
                     for f, k, v in done)],
            )

    if anomaly is not None:
        L = cycle_len
        base_key = n_groups * keys_per_group
        vals = []
        for _ in range(2 * L):
            counter[0] += 1
            vals.append(counter[0])
        if anomaly == "g1c":
            # T_i appends v_i to a_i and reads a_{i-1} = [v_{i-1}]:
            # a wr cycle T_1 -> T_2 -> ... -> T_L -> T_1
            for i in range(L):
                a_i = base_key + i
                a_prev = base_key + (i - 1) % L
                mops = [("append", a_i, vals[i]),
                        ("r", a_prev, [vals[(i - 1) % L]])]
                emit([("append", a_i, vals[i]), ("r", a_prev, None)],
                     mops)
        else:
            # wr chain T_2 -> T_3 -> ... -> T_L -> T_1 over fresh keys,
            # closed by rw anti-dependencies: T_1 --rw--> T_2 (T_1 reads
            # [] against T_2's unobserved single append), and for
            # g2-item also T_L --rw--> T_1 (instead of T_L's wr read
            # coming from a chain, T_1 itself appends a key T_L misses).
            chain = [[] for _ in range(L)]  # mops per planted txn
            a = base_key  # the rw key: appended by T_2, read [] by T_1
            chain[0].append(("r", a, []))
            chain[1].append(("append", a, vals[0]))
            for i in range(1, L - 1):
                # wr T_{i+1} -> T_{i+2}: T_{i+1} appends b_i, next reads
                b_i = base_key + i
                chain[i].append(("append", b_i, vals[i]))
                chain[(i + 1) % L].append(("r", b_i, [vals[i]]))
            close_key = base_key + L - 1
            if anomaly == "g-single":
                # wr T_L -> T_1
                chain[L - 1].append(("append", close_key, vals[L - 1]))
                chain[0].append(("r", close_key, [vals[L - 1]]))
            else:  # g2-item: rw T_L -> T_1
                chain[0].append(("append", close_key, vals[L - 1]))
                chain[L - 1].append(("r", close_key, []))
            for mops in chain:
                emit(
                    [(f, k, None if f == "r" else v) for f, k, v in mops],
                    mops,
                )
    return History(ops)


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


def gen_queue_history(
    rng: random.Random,
    n_ops: int = 40,
    n_procs: int = 3,
    n_values: int = 4,
    p_crash: float = 0.05,
) -> History:
    """Concurrent enqueue/dequeue history generated by simulating an
    actual unordered queue, so it is linearizable by construction
    (crashed ops take effect: the simulator applies each op when it
    invokes it). Values cycle through range(n_values)."""
    ops = []
    queue: list = []
    free = list(range(n_procs))
    open_by_proc = {}
    next_val = 0
    emitted = 0
    while emitted < n_ops or open_by_proc:
        can_open = emitted < n_ops and free
        if can_open and (not open_by_proc or rng.random() < 0.6):
            p = free.pop(rng.randrange(len(free)))
            if queue and rng.random() < 0.45:
                v = rng.choice(queue)
                op = invoke_op(p, "dequeue", v)
                effect = ("deq", v)
            else:
                v = next_val % n_values
                next_val += 1
                op = invoke_op(p, "enqueue", v)
                effect = ("enq", v)
            ops.append(op)
            open_by_proc[p] = (op, effect)
            emitted += 1
            # linearize immediately (sequential effect order)
            kind, v = effect
            if kind == "enq":
                queue.append(v)
            else:
                queue.remove(v)
        else:
            p = rng.choice(list(open_by_proc))
            op, effect = open_by_proc.pop(p)
            if rng.random() < p_crash:
                ops.append(info_op(p, op.f, op.value))
                # the crashed op took effect; the thread crash-cycles
                # onto a fresh process id so the pool never drains
                free.append(p + n_procs)
            else:
                ops.append(ok_op(p, op.f, op.value))
                free.append(p)
    return History(ops)


def overdraw_queue_history(h: History, value) -> History:
    """h followed by sequential ok dequeues of `value`, one more than
    h's enqueue invocations of it: not linearizable, and the failing
    value's substream is `value`'s."""
    n = sum(1 for o in h.ops
            if o.is_invoke and o.f == "enqueue" and o.value == value)
    p = max((o.process for o in h.ops if isinstance(o.process, int)),
            default=-1) + 1
    ops = list(h.ops)
    for _ in range(n + 1):
        ops += [invoke_op(p, "dequeue", None), ok_op(p, "dequeue", value)]
    return History(ops)
