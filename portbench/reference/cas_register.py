"""The benchmark's plain reference for linearizability of a CAS register
(knossos' cas-register model): it judges every configuration whose
`"model"` is `cas-register`; `verdict(item)` judges one pool item.

Plain Python over op dicts (type, f, value, process), importing nothing
of the program. The encoding follows knossos' history/complete as the
program states it: an invocation's completion is the next op of its
process; an :ok completion's value is the op's value; a :fail op never
happened and is dropped; an :info (or missing) completion leaves the op
open to the end of the history, except a crashed read, which
constrains nothing and is dropped. Open ops take the smallest free
slot, so the peak window is the most ops open at once.

The search is the Wing-Gong frontier search of the port's
checker/wgl_oracle.py (`check_events`, with its crashed-bit dominance
pruning): a configuration is (state, mask of linearized open slots); at
each return the frontier is closed under linearizing open ops, filtered
to the configurations that linearized the returning op, and that op's
bit is cleared. Two changes make it fast enough to judge every history
a run checks: the closure starts from the ops invoked since the last
return, and dominated configurations are dropped as they are found
rather than by a sweep of the whole frontier. The history is linearizable iff the
frontier never empties; where it empties, the failing op is the
returning completion's index.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

INVOKE, RETURN = 0, 1

#: a config's state before any write: the register holds nil
NIL = None


def _step(state, f: str, value) -> Tuple[bool, object]:
    """The knossos cas-register: (ok, state')."""
    if f == "read":
        return state == value, state
    if f == "write":
        return True, value
    if f == "cas":
        return state == value[0], value[1]
    raise ValueError(f"unknown f {f!r}")


def encode(ops: Sequence[dict]) -> Tuple[List[tuple], int]:
    """(events, peak window). An event is (kind, slot, f, value,
    op_index, crashed): an INVOKE at its invocation's index, a RETURN
    at its :ok completion's index."""
    last_open: Dict[object, int] = {}
    completion: Dict[int, int] = {}
    for i, o in enumerate(ops):
        p = o["process"]
        if not isinstance(p, int) or isinstance(p, bool):
            continue
        if o["type"] == "invoke":
            last_open[p] = i
        elif p in last_open:
            completion[last_open.pop(p)] = i
    events: List[tuple] = []
    free: List[int] = []
    next_fresh = 0
    open_slot: Dict[int, int] = {}
    window = 0
    for i, o in enumerate(ops):
        p = o["process"]
        if not isinstance(p, int) or isinstance(p, bool):
            continue
        if o["type"] == "invoke":
            j = completion.get(i)
            kind = ops[j]["type"] if j is not None else "info"
            if kind == "fail":
                continue
            crashed = kind not in ("ok",)
            if crashed and o["f"] == "read":
                continue
            value = ops[j]["value"] if kind == "ok" else o["value"]
            if free:
                s = heapq.heappop(free)
            else:
                s = next_fresh
                next_fresh += 1
            window = max(window, s + 1)
            if not crashed:
                open_slot[j] = s
            events.append((INVOKE, s, o["f"], value, i, crashed))
        elif o["type"] == "ok" and i in open_slot:
            s = open_slot.pop(i)
            heapq.heappush(free, s)
            events.append((RETURN, s, None, None, i, False))
    return events, window


def peak_window(ops: Sequence[dict]) -> int:
    """The most ops open at once: the benchmark's own window count."""
    return encode(ops)[1]


def _add(groups: dict, state, live: int, cb: int) -> bool:
    """Insert config (state, live | cb) unless one in its group
    dominates it: the same state and live bits and a subset of its
    crashed bits (crashed ops never return, so the dominator can replay
    any future of the dominated). Drops the configs it dominates."""
    g = groups.get((state, live))
    if g is None:
        groups[(state, live)] = [cb]
        return True
    for k in g:
        if k & cb == k:
            return False
    g[:] = [k for k in g if k & cb != cb]
    g.append(cb)
    return True


def _closure(groups: dict, open_ops: dict, fresh: List[int],
             crashed_mask: int) -> None:
    """Close the frontier, in place, under linearizing open ops. It is
    already closed under the ops that were open at the last return (a
    return filter keeps that), so the first layer expands by the ops
    invoked since (`fresh`) alone; every config it adds expands by all
    open ops."""

    def expand(state, live, cb, slots, out):
        mask = live | cb
        for s in slots:
            if (mask >> s) & 1:
                continue
            f, value = open_ops[s]
            ok, state2 = _step(state, f, value)
            if not ok:
                continue
            bit = 1 << s
            if bit & crashed_mask:
                key = (state2, live, cb | bit)
            else:
                key = (state2, live | bit, cb)
            if _add(groups, *key):
                out.append(key)

    layer: List[tuple] = []
    for (state, live), cbs in list(groups.items()):
        for cb in list(cbs):
            expand(state, live, cb, fresh, layer)
    slots = list(open_ops)
    while layer:
        nxt: List[tuple] = []
        for state, live, cb in layer:
            g = groups.get((state, live))
            if g is None or cb not in g:
                continue  # dominated since it was added
            expand(state, live, cb, slots, nxt)
        layer = nxt


def check(ops: Sequence[dict], drop_crashed: bool = False) -> dict:
    """{"valid?": bool, "failed_op_index": int or None, "window": int,
    "max_frontier": int}. drop_crashed=True treats every crashed op as
    one that never happened: a weaker guarantee than the
    configuration's, kept as the comparison's control."""
    events, window = encode(ops)
    #: the frontier: (state, live bits) -> its undominated crashed bits
    groups: dict = {(NIL, 0): [0]}
    open_ops: dict = {}
    fresh: List[int] = []
    crashed_mask = 0
    max_frontier = 1
    for kind, s, f, value, idx, crashed in events:
        if kind == INVOKE:
            if crashed and drop_crashed:
                continue
            open_ops[s] = (f, value)
            fresh.append(s)
            if crashed:
                crashed_mask |= 1 << s
            continue
        _closure(groups, open_ops, fresh, crashed_mask)
        fresh = []
        max_frontier = max(max_frontier,
                           sum(len(g) for g in groups.values()))
        bit = 1 << s
        groups = {(st, live & ~bit): cbs
                  for (st, live), cbs in groups.items() if live & bit}
        if not groups:
            return {"valid?": False, "failed_op_index": idx,
                    "window": window, "max_frontier": max_frontier}
        del open_ops[s]
    return {"valid?": True, "failed_op_index": None, "window": window,
            "max_frontier": max_frontier}


def check_brute(ops: Sequence[dict], max_ops: int = 8) -> bool:
    """Every linearization order of a tiny history, crashed ops placed
    anywhere after their invocation or left out: ground truth for the
    tests, unrelated to the frontier search."""
    from itertools import permutations

    events, _ = encode(ops)
    recs: List[list] = []
    by_slot: Dict[int, list] = {}
    for pos, (kind, s, f, value, _idx, _crashed) in enumerate(events):
        if kind == INVOKE:
            rec = [f, value, pos, None]
            by_slot[s] = rec
            recs.append(rec)
        else:
            by_slot.pop(s)[3] = pos
    if len(recs) > max_ops:
        raise ValueError(f"brute force capped at {max_ops} ops")
    done = [i for i, r in enumerate(recs) if r[3] is not None]
    crashed = [i for i, r in enumerate(recs) if r[3] is None]
    for bits in range(1 << len(crashed)):
        chosen = done + [c for j, c in enumerate(crashed) if (bits >> j) & 1]
        for order in permutations(chosen):
            pos = {x: k for k, x in enumerate(order)}
            if any(recs[x][3] is not None and recs[x][3] < recs[y][2]
                   and pos[x] > pos[y] for x in pos for y in pos):
                continue
            state, ok = NIL, True
            for x in order:
                ok, state = _step(state, recs[x][0], recs[x][1])
                if not ok:
                    break
            if ok:
                return True
    return False


def split_keys(ops: Sequence[dict]) -> Dict[object, List[dict]]:
    """Per-key subhistories of a keyed history whose values are
    [key, value] pairs, in history order (jepsen.independent)."""
    out: Dict[object, List[dict]] = {}
    for o in ops:
        v = o["value"]
        if not (isinstance(v, (list, tuple)) and len(v) == 2):
            continue
        out.setdefault(v[0], []).append(dict(o, value=v[1]))
    return out


def check_keyed(ops: Sequence[dict], drop_crashed: bool = False
                ) -> Dict[object, dict]:
    """The reference verdict of every key of a keyed history; a key's
    failed_op_index is its position in the key's subhistory."""
    return {k: check(sub, drop_crashed=drop_crashed)
            for k, sub in split_keys(ops).items()}


def verdict_of(results: Dict[object, dict]) -> bool:
    return all(r["valid?"] for r in results.values())



def judge_ops(item: dict, ops: Sequence[dict], drop_crashed: bool = False
              ) -> dict:
    """The verdict of `ops` in the place of the pool item's history, in
    the form the entries give the program's: {"valid": bool, "failed":
    ...}. For one register history `failed` is the failing op's index
    (None when valid); for a keyed history it is the sorted list of
    [key, failing index or None] over every key, so a key left
    unchecked or judged wrongly shows."""
    if item["keyed"]:
        per_key = check_keyed(ops, drop_crashed=drop_crashed)
        return {"valid": verdict_of(per_key),
                "failed": sorted([k, r["failed_op_index"]]
                                 for k, r in per_key.items())}
    r = check(ops, drop_crashed=drop_crashed)
    return {"valid": r["valid?"], "failed": r["failed_op_index"]}


def verdict(item: dict) -> dict:
    """The reference's verdict of one pool item (what core.judge asks of
    the reference of a configuration's model)."""
    return judge_ops(item, item["ops"])
