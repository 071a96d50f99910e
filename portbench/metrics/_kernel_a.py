"""The work kernel A (the bitset WGL scan) needs for a history,
counted from the history itself, whatever implements the scan.

At each return step the frontier of a dense bitset search is every
(state, subset of the open ops) pair: `rows * 2**open` bits, packed 32
to a word. The step needs at least one pass over those words for each
op invoked since the last return (the closure from the new ops; the
frontier is already closed under the others) and one for the return's
filter. So a step of `open` open ops and `fresh` new ones costs
`(fresh + 1) * ceil(rows * 2**open / 32)` word operations, where
`rows` is the register's states (the values it can hold, and nil).
Bytes: every event read once (4 bytes: slot, f and two values), and
the frontier at the widest window written once and read once.

Counted from each step's own open window, never from a segment's
bucket, the padding or the kernel's own round count: the same history
reads the same work under any plan."""

from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple

from portbench.reference.cas_register import INVOKE, encode, split_keys


def step_ops(rows: int, n_open: int, n_fresh: int) -> int:
    return (n_fresh + 1) * math.ceil(rows * (1 << n_open) / 32)


def count_steps(steps: Iterable[Tuple[int, int]], rows: int,
                n_events: int) -> Tuple[int, int, int]:
    """(return steps, word operations, bytes) of (open, fresh) pairs,
    one a return step."""
    n = ops = widest = 0
    for n_open, n_fresh in steps:
        n += 1
        ops += step_ops(rows, n_open, n_fresh)
        widest = max(widest, n_open)
    nbytes = 4 * n_events + 2 * math.ceil(rows * (1 << widest) / 8)
    return n, ops, nbytes


def rows_of(ops: Sequence[dict]) -> int:
    """States a register history can hold: its values, and nil."""
    vals = {None}
    for o in ops:
        v = o["value"]
        if o["f"] == "cas" and isinstance(v, (list, tuple)):
            vals.update(v)
        else:
            vals.add(v)
    return len(vals)


def history_steps(ops: Sequence[dict], upto: int = None):
    """(open, fresh) at each return step, up to the return of op index
    `upto` (the failing op of an invalid history) inclusive; and the
    events read."""
    events, _ = encode(ops)
    out = []
    n_open = n_fresh = n_events = 0
    for kind, _s, _f, _v, idx, _crashed in events:
        n_events += 1
        if kind == INVOKE:
            n_open += 1
            n_fresh += 1
            continue
        out.append((n_open, n_fresh))
        n_open -= 1
        n_fresh = 0
        if upto is not None and idx == upto:
            break
    return out, n_events


def count_history(ops: Sequence[dict], upto: int = None):
    """(return steps, word operations, bytes) of one register
    history."""
    steps, n_events = history_steps(ops, upto)
    return count_steps(steps, rows_of(ops), n_events)


def count_item(item: dict, verdict: dict):
    """The work of one pool item, as the reference judged it: a keyed
    history's keys each on their own, an invalid history or key up to
    its failing op."""
    if not item["keyed"]:
        return count_history(item["ops"], verdict.get("failed"))
    failed = dict((k, f) for k, f in verdict["failed"])
    tot = [0, 0, 0]
    for k, sub in split_keys(item["ops"]).items():
        for j, x in enumerate(count_history(sub, failed.get(k))):
            tot[j] += x
    return tuple(tot)


def window_work(run):
    """(return steps, word operations, bytes) of every check the window
    answered, each item counted once and summed over its checks."""
    cache = {}
    tot = [0, 0, 0]
    for r in run.records:
        if r.verdict is None:
            continue
        if r.item not in cache:
            cache[r.item] = count_item(run.items[r.item],
                                       run.reference[r.item])
        for j, x in enumerate(cache[r.item]):
            tot[j] += x
    return tuple(tot)
