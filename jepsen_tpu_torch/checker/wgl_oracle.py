"""CPU oracles for linearizability — a copy of jepsen_tpu.checker.
wgl_oracle: its Python rungs, the dispatch to the native C++ rung
(wgl_native.py) and the multi-process fan-out over keys.

Two independent implementations, used to validate the device kernels
(SURVEY.md §4.4 tier 5: same histories -> identical verdicts):

1. ``check_events`` — set-based frontier search over the same event
   stream the device kernels consume. Unbounded frontier (Python sets), so
   it never overflows; this is the scalable reference (the knossos-wgl
   role, ref: jepsen/src/jepsen/checker.clj:141-144).
2. ``check_brute`` — exhaustive enumeration over linearization orders
   straight from op records, for tiny histories only. Algorithmically
   unrelated to the frontier search; ground truth for property tests.

Frontier semantics (Wing–Gong / Lowe just-in-time linearization):
a configuration is (state, mask-of-linearized-open-ops). Closure expands
configurations by linearizing any open, not-yet-linearized op; a RETURN
of op i filters to configurations with i linearized (then clears i's bit
so its slot can be recycled). The history is linearizable iff the
frontier is non-empty after the final event.
"""

from __future__ import annotations

from itertools import permutations
from typing import Any, Iterable, List, Optional, Set, Tuple

from jepsen_tpu_torch.checker.events import (
    EV_INVOKE,
    EV_NOP,
    EventStream,
    crashed_invokes,
)
from jepsen_tpu_torch.checker.models import Model, model as get_model


def _prune(
    frontier: Set[Tuple[int, int]], crashed_mask: int
) -> Set[Tuple[int, int]]:
    """Crashed-bit dominance pruning (exactness-preserving).

    Config (s, m) *dominates* (s, m') when their live bits agree and m's
    crashed bits are a strict subset of m''s: the dominator can replay
    any future of the dominated config (more crashed ops still
    available; filters only ever test live bits, because crashed ops
    never return). Dropping dominated configs loses no witnesses, and
    collapses the 2^crashed-ops frontier blowup that long histories with
    steady :info ops otherwise suffer.
    """
    if not crashed_mask or len(frontier) < 2:
        return frontier
    groups: dict = {}
    for st, mk in frontier:
        groups.setdefault((st, mk & ~crashed_mask), []).append(
            mk & crashed_mask
        )
    out: Set[Tuple[int, int]] = set()
    for (st, live), cbs in groups.items():
        cbs.sort(key=lambda x: bin(x).count("1"))
        kept: List[int] = []
        for cb in cbs:
            if not any(k & cb == k for k in kept):
                kept.append(cb)
        for cb in kept:
            out.add((st, live | cb))
    return out


def _closure(
    frontier: Set[Tuple[int, int]],
    open_ops: dict,
    step_py,
    crashed_mask: int = 0,
    prune: bool = True,
) -> Set[Tuple[int, int]]:
    """All configurations reachable by linearizing open ops, in any
    order, expanded in BFS layers with dominance pruning per layer (so
    intermediate sets stay near the pruned fixpoint instead of the full
    2^crashed closure)."""
    seen = set(frontier)
    layer = list(frontier)
    while layer:
        nxt = []
        for state, mask in layer:
            for s, (f, a, b) in open_ops.items():
                if (mask >> s) & 1:
                    continue
                ok, state2 = step_py(state, f, a, b)
                if ok:
                    cfg = (state2, mask | (1 << s))
                    if cfg not in seen:
                        seen.add(cfg)
                        nxt.append(cfg)
        if prune and nxt and crashed_mask:
            pruned = _prune(seen, crashed_mask)
            nxt = [c for c in nxt if c in pruned]
            seen = pruned
        layer = nxt
    return seen


def check_events(
    events: EventStream,
    model: Any = "cas-register",
    return_stats: bool = False,
    prune: bool = True,
):
    """Frontier-search linearizability verdict over an event stream.

    Returns bool, or (bool, stats) when return_stats is set; stats
    carries max frontier size, the failing event position, and the
    failing op's history index (when the stream has op_index).
    """
    m: Model = get_model(model)
    step = m.step_py
    frontier: Set[Tuple[Any, int]] = {(m.initial(events.init_state), 0)}
    open_ops: dict = {}
    max_frontier = 1
    crashed_mask = 0
    if prune:
        crashed_inv = crashed_invokes(events)

    for i in range(len(events)):
        kind = int(events.kind[i])
        if kind == EV_NOP:
            continue
        s = int(events.slot[i])
        if kind == EV_INVOKE:
            open_ops[s] = (int(events.f[i]), int(events.a[i]), int(events.b[i]))
            if prune and crashed_inv[i]:
                crashed_mask |= 1 << s
        else:  # EV_RETURN of the op in slot s
            pre_filter = _closure(
                frontier, open_ops, step, crashed_mask, prune=prune
            )
            max_frontier = max(max_frontier, len(pre_filter))
            frontier = {
                (state, mask & ~(1 << s))
                for state, mask in pre_filter
                if (mask >> s) & 1
            }
            if not frontier:
                # Death: read the window BEFORE recycling the slot —
                # the function returns here, so no copy is ever paid
                # on the valid path.
                if return_stats:
                    op_idx = (
                        int(events.op_index[i])
                        if events.op_index is not None
                        else None
                    )
                    return False, {
                        "max_frontier": max_frontier,
                        "failed_at": i,
                        "failed_op_index": op_idx,
                        # Death report material (the linear.svg role):
                        # the pre-filter frontier and the open window,
                        # truncated like the reference's 10-config cap.
                        "death_slot": s,
                        "death_configs": sorted(pre_filter)[:10],
                        "death_open_ops": dict(open_ops),
                    }
                return False
            del open_ops[s]
    if return_stats:
        return True, {
            "max_frontier": max_frontier,
            "failed_at": None,
            "failed_op_index": None,
        }
    return True


# -- brute-force ground truth (tiny histories only) --------------------------


def check_brute(
    events: EventStream,
    model: Any = "cas-register",
    max_ops: int = 8,
) -> bool:
    """Exhaustively test every linearization order consistent with the
    event stream's real-time partial order. Crashed ops (no RETURN) may
    be placed anywhere after their invocation or omitted entirely.

    O(n!) — guarded by max_ops.
    """
    m: Model = get_model(model)
    step = m.step_py

    # Reconstruct ops from the event stream: (f, a, b, t_inv, t_ret|None).
    ops: List[list] = []
    open_by_slot: dict = {}
    for i in range(len(events)):
        kind = int(events.kind[i])
        if kind == EV_NOP:
            continue
        s = int(events.slot[i])
        if kind == EV_INVOKE:
            op = [int(events.f[i]), int(events.a[i]), int(events.b[i]), i, None]
            open_by_slot[s] = op
            ops.append(op)
        else:
            open_by_slot.pop(s)[4] = i

    if len(ops) > max_ops:
        raise ValueError(f"brute force capped at {max_ops} ops, got {len(ops)}")

    completed = [i for i, op in enumerate(ops) if op[4] is not None]
    crashed = [i for i, op in enumerate(ops) if op[4] is None]

    def order_ok(order: Iterable[int]) -> bool:
        # Real-time: if x returned before y invoked, x must precede y.
        pos = {op_id: k for k, op_id in enumerate(order)}
        for x in pos:
            for y in pos:
                rx = ops[x][4]
                if rx is not None and rx < ops[y][3] and pos[x] > pos[y]:
                    return False
        return True

    def run_ok(order: Iterable[int]) -> bool:
        state = m.initial(events.init_state)
        for op_id in order:
            f, a, b = ops[op_id][:3]
            ok, state = step(state, f, a, b)
            if not ok:
                return False
        return True

    # Choose any subset of crashed ops to take effect.
    for subset_bits in range(1 << len(crashed)):
        chosen = completed + [
            c for j, c in enumerate(crashed) if (subset_bits >> j) & 1
        ]
        for order in permutations(chosen):
            if order_ok(order) and run_ok(order):
                return True
    return False


# -- fast dispatch + bounded-pmap parallelism --------------------------------


def check_events_fast(
    events: EventStream,
    model: Any = "cas-register",
    return_stats: bool = False,
):
    """Strongest host-side oracle for this stream: the native C++ rung
    (wgl_native) when the stream fits its envelope (int32-state models,
    window <= 64), else the Python frontier search. Same algorithm
    either way, so the verdicts are interchangeable. With return_stats
    the deciding rung is under ``stats["oracle"]`` ("native" |
    "python")."""
    from jepsen_tpu_torch.checker import wgl_native

    r = wgl_native.check_events_native(events, model,
                                       return_stats=return_stats)
    rung = "native"
    if r is None:
        r = check_events(events, model, return_stats=return_stats)
        rung = "python"
    if return_stats:
        r[1]["oracle"] = rung
    return r


def _check_one(args):
    stream, model = args
    valid, stats = check_events_fast(stream, model, return_stats=True)
    return valid, stats["oracle"]


def check_streams(
    streams,
    model: Any = "cas-register",
    processes: Optional[int] = None,
):
    """Check many per-key event streams across the host's cores — the
    bounded-pmap analog of the reference's per-key checker fan-out
    (jepsen/src/jepsen/independent.clj:266-288). Returns (verdicts,
    meta); meta records the processes used, which rung decided each
    stream ("rungs") and the rung overall ("oracle", or "mixed").

    The pool forks, so its workers start without importing anything
    again; they run only the host oracles (numpy, ctypes, Python), never
    torch's CUDA state, so forking a process that has initialised CUDA
    is safe for them (this package never loads jax). Each stream goes to
    its worker without its memos, which may hold device tensors."""
    import dataclasses
    import os

    streams = list(streams)
    host = os.cpu_count() or 1
    procs = min(host if processes is None else processes, len(streams))
    work = [(dataclasses.replace(s), model) for s in streams]
    if procs <= 1:
        verdicts = [_check_one(w) for w in work]
        procs = 1
    else:
        import multiprocessing as mp

        with mp.get_context("fork").Pool(procs) as pool:
            verdicts = pool.map(_check_one, work)
    rungs = [r for _, r in verdicts]
    return [v for v, _ in verdicts], {
        "processes": procs,
        "host_cores": host,
        "rungs": rungs,
        "oracle": rungs[0] if len(set(rungs)) == 1 else "mixed",
    }
