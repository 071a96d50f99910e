"""Linearizability checker: the host side around the CUDA kernels.

The counterpart of jepsen_tpu.checker.linearizable (synchronous path).
The pipeline:

  History ─history_to_events─▶ EventStream ─events_to_steps─▶ ReturnSteps
    ─▶ bitset tier: segmented exact bitset scan (W12..W19), fast tier
         with an exact re-run from segment 0 on a death   [bitset_scan]
    ─▶ outside the bitset envelope: K-frontier ladder K=128/256/1024,
         single-word kernel where _pallas_ok               [kfrontier_scan]
         else the multi-word torch scan (wgl_torch.py) where _jax_ok
    ─▶ every rung overflowed / window > 128: CPU oracle (native C++
         where the stream fits it, else Python)
    ─▶ verdict + failed_op_index + failure report

Unordered-queue histories first try the per-value split
(check_queue_by_value): one batched pass over the per-value substreams
through sharded.check_keys, which puts them on kernel B's key axis.

The gates (W buckets, K_LADDER, _pallas_ok, _jax_ok, the skip-ahead for
crash-heavy histories) are the reference's, so the same history takes
the same tier in both packages; deriving them for H100 memory is later
work. Method names: gpu-wgl-bitset, gpu-wgl-kfrontier, gpu-wgl,
cpu-oracle-native and cpu-oracle-python; per-value:<method>x<count>,...
for the queue split.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np

from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.events import (
    EventStream,
    WindowOverflow,
    bucket,
    events_to_steps,
    history_to_events,
)
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.checker.wgl_kfrontier import check_steps_kfrontier
from jepsen_tpu_torch.checker.wgl_oracle import check_events, check_events_fast
from jepsen_tpu_torch.checker.wgl_torch import check_steps_torch
from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.history.history import History

#: K escalation ladder: frontier capacities tried in order.
K_LADDER = (128, 256, 1024)

#: the reference's budget for the single-word kernel's [K, W, K]
#: intermediates, kept as its gate
_PALLAS_VMEM_ELEMS = 1_500_000

#: the reference's budget for the multi-word scan's [N, N] matrices,
#: N = K*(1+W), kept as its gate
_JAX_MATRIX_ELEMS = 160_000_000


def _pallas_ok(K: int, W: int, NW: int) -> bool:
    return NW == 1 and K * K * W <= _PALLAS_VMEM_ELEMS


def _jax_ok(K: int, W: int, NW: int) -> bool:
    n = K * (1 + W)
    return n * n * NW <= _JAX_MATRIX_ELEMS


#: W buckets of the K-frontier ladder (multi-word masks, 32 slots/word).
W_BUCKETS = (4, 8, 16, 32, 64, 128)


def _bucket_window(window: int) -> Optional[int]:
    for w in W_BUCKETS:
        if window <= w:
            return w
    return None


def _decode_value(events: EventStream):
    """code -> original value decoder for failure reports (intern keys
    are ("int", 2)-style tuples)."""
    rev = {c: k for k, c in events.value_codes.items()}

    def dec(c):
        if c < 0:
            return None
        k = rev.get(c)
        if isinstance(k, tuple) and len(k) == 2:
            return k[1]
        return k

    return dec


def oracle_failure_report(events: EventStream, stats: dict, model):
    """The decode_frontier-shaped failure report from the Python
    oracle's death material, so invalid verdicts carry the same report
    on every engine path. None when the stats carry no death configs."""
    if "death_configs" not in stats:
        return None
    m = get_model(model)
    f_names: dict = {}
    for name, code in m.f_names.items():
        f_names.setdefault(code, str(name))
    dec = _decode_value(events)
    open_ops = stats["death_open_ops"]

    def op_desc(slot: int) -> dict:
        f, a, b = open_ops[slot]
        name = f_names.get(f, "?")
        d = {"slot": slot, "f": name, "value": dec(a)}
        if name in ("cas", "compare-and-set"):
            d["value"] = [dec(a), dec(b)]
        return d

    configs = []
    for state, mask in stats["death_configs"]:
        configs.append({
            "state": m.state_repr(state, dec),
            "linearized": [
                op_desc(s) for s in sorted(open_ops)
                if (mask >> s) & 1
            ],
            "pending": [
                op_desc(s) for s in sorted(open_ops)
                if not (mask >> s) & 1
            ],
        })
    return {
        "failed_op": op_desc(stats["death_slot"]),
        "configs": configs,
    }


def _oracle_verdict(valid, stats, failure, **extra) -> dict:
    """The one place a cpu-oracle verdict dict is assembled."""
    out = {
        "valid?": valid,
        "method": f"cpu-oracle-{stats['oracle']}",
        **extra,
    }
    if not valid:
        out["failed_op_index"] = stats["failed_op_index"]
        if failure is not None:
            out["failure"] = failure
    return out


def _harvest_failure(events: EventStream, out: dict, model) -> None:
    """Attach the failure report to an invalid verdict that arrived
    index-only (the K-frontier rungs): re-run the Python oracle and
    decode its death material in place. No-op for valid verdicts or
    ones already carrying a report."""
    if out.get("valid?") is not False or "failure" in out:
        return
    _, py_stats = check_events(events, model=model, return_stats=True)
    failure = oracle_failure_report(events, py_stats, model)
    if failure is not None:
        out["failure"] = failure


def _oracle_decide(events: EventStream, model):
    """Oracle verdict + (on invalid) the failure report, re-running the
    Python rung when the native one decided (it carries no frontier)."""
    valid, stats = check_events_fast(events, model=model, return_stats=True)
    failure = None
    if not valid:
        if "death_configs" not in stats:
            _, py_stats = check_events(events, model=model,
                                       return_stats=True)
            py_stats["oracle"] = stats["oracle"]
            stats = py_stats
        failure = oracle_failure_report(events, stats, model)
    return valid, stats, failure


def check_events_bucketed(
    events: EventStream,
    model: str = "cas-register",
    k_ladder=K_LADDER,
    device=None,
) -> dict:
    """Definite linearizability verdict for an event stream:
    {"valid?": bool, "method": "gpu-wgl-bitset"|"gpu-wgl-kfrontier"|
    "gpu-wgl"|"cpu-oracle-native"|"cpu-oracle-python", "frontier_k": K
    or None,
    "escalations": int}, plus failed_op_index (and, from the bitset
    tier and the oracle, failure) on an invalid verdict.

    device: None runs on the CUDA card (raising without one); "cpu"
    runs every kernel's plain PyTorch version."""
    dev = resolve_device(device)
    W = _bucket_window(max(events.window, 1))
    m = get_model(model)

    # Exact bitset tier first: inside its envelope the verdict is
    # always definite. taint is impossible by construction; if it ever
    # fires, fall through to the ladder.
    plan = bs.plan(m, events.window, len(events.value_codes))
    if plan is not None:
        bW, S = plan
        bsteps = events_to_steps(events, W=bW)
        alive, taint, died = bs.collect_steps_bitset_segmented(
            bsteps,
            bs.launch_steps_bitset_segmented(
                bsteps, model=model, S=S, device=dev
            ),
        )
        if not taint:
            out = {
                "valid?": alive,
                "method": "gpu-wgl-bitset",
                "frontier_k": None,
                "escalations": 0,
            }
            if not alive:
                out["failed_op_index"] = died
                fr = getattr(bsteps, "_death_frontier", None)
                if fr is not None:
                    out["failure"] = bs.decode_frontier(
                        fr, bsteps, died, model,
                        decode_value=_decode_value(events),
                    )
            return out
    if (
        W is not None
        and not m.jax_capable
        and m.packed_variant
        and m.packed_ok is not None
        and m.packed_ok(events)
    ):
        # Rich-state model whose bounded encoding fits a machine word:
        # substitute the packed variant so the history rides the
        # K-frontier scans.
        m = get_model(m.packed_variant)
        model = m.name
    if W is None or not m.jax_capable:
        reason = (
            f"window {events.window} exceeds {W_BUCKETS[-1]} slots"
            if W is None
            else f"model {m.name} is host-only (rich state)"
        )
        valid, stats, failure = _oracle_decide(events, model)
        return _oracle_verdict(
            valid, stats, failure,
            frontier_k=None, escalations=0, reason=reason,
        )

    steps = events_to_steps(events, W=W)
    ki = m.kernel_init_code(events.init_state)
    if ki != steps.init_state:
        # packed models re-encode the initial state; copy rather than
        # mutate the memoized steps object
        steps = dataclasses.replace(steps, init_state=ki)
    # Crash-heavy histories blow past the first rung almost surely, so
    # skip rungs that are doomed (counted before padding).
    n_crashed = (
        int(np.unpackbits(steps.crashed[-1].view(np.uint8)).sum())
        if len(steps)
        else 0
    )
    steps = steps.padded(bucket(max(len(steps), 1), 64))
    if n_crashed >= 6:
        bigger = tuple(
            K for K in k_ladder
            if K >= 256
            and (_pallas_ok(K, W, steps.NW) or _jax_ok(K, W, steps.NW))
        )
        if bigger:
            k_ladder = bigger
    escalations = 0
    for K in k_ladder:
        if _pallas_ok(K, W, steps.NW):
            alive, overflow, died = check_steps_kfrontier(
                steps, model=model, K=K, device=dev
            )
            method = "gpu-wgl-kfrontier"
        elif _jax_ok(K, W, steps.NW):
            alive, overflow, died = check_steps_torch(
                steps, model=model, K=K, device=dev
            )
            method = "gpu-wgl"
        else:
            break  # rung infeasible at this (K, W): the oracle decides
        if alive or not overflow:
            out = {
                "valid?": alive,
                "method": method,
                "frontier_k": K,
                "escalations": escalations,
            }
            if not alive:
                out["failed_op_index"] = died
            return out
        escalations += 1
    valid, stats, failure = _oracle_decide(events, model)
    return _oracle_verdict(
        valid, stats, failure,
        frontier_k=None, escalations=escalations,
        reason=f"frontier overflowed at K={k_ladder[-1]}",
    )


def split_queue_history_by_value(history):
    """Per-value subhistories of an unordered-queue history, or None
    when the history does not decompose (non-enq/deq ops, or an
    ok-dequeue/enqueue of nil). A copy of the reference's.

    Soundness: the unordered queue's state factorizes by value —
    enqueue is always enabled, dequeue(v) is gated only by v's own
    count, and transitions of distinct values commute — so this is
    Herlihy-Wing locality with each value as its own object: H is
    linearizable iff every per-value subhistory is. Crashed dequeues of
    unknown value can never linearize (the model's NIL rule), so they
    are vacuous and dropped, as the joint model treats them. Each
    subhistory has ONE value (interning to code 0) and a small window,
    so any queue history whose per-value enqueue count fits a nibble
    rides the packed kernels.

    Substreams are rebuilt in ONE pass over the original order: every
    invoke and completion lands at its own real-time position. A drain
    expands into per-value dequeues that invoke at the drain's invoke
    and complete at its completion; each synthetic pair gets a unique
    integer process, counting down from below the smallest real one
    (History pairs by process, and history_to_events keeps only integer
    processes)."""
    import itertools
    from collections import defaultdict

    from jepsen_tpu_torch.checker.models import F_DEQ, F_ENQ, QUEUE_F_NAMES

    subs = defaultdict(list)
    synth = itertools.count(len(history))
    synth_proc = itertools.count(
        min(
            (op.process for op in history
             if isinstance(op.process, int)),
            default=0,
        ) - 1,
        -1,
    )
    #: drain completion index -> [(value, synthetic ok), ...] queued
    #: for emission when the walk reaches the completion's position
    drain_oks: dict = {}
    for op in history:
        if op.is_invoke:
            comp = history.completion(op)
            if op.f == "drain":
                # A batch of dequeues in one interval; the expansion is
                # exact for the unordered queue (checker.clj:570-629). A
                # crashed drain's values are unknown: vacuous, dropped.
                if comp is not None and comp.type == "ok":
                    for v in comp.value or ():
                        if v is None:
                            return None
                        proc = next(synth_proc)
                        subs[v].append(op.with_(
                            f="dequeue", value=None,
                            index=next(synth), process=proc,
                        ))
                        drain_oks.setdefault(comp.index, []).append((
                            v,
                            comp.with_(
                                f="dequeue", value=v,
                                index=next(synth), process=proc,
                            ),
                        ))
                continue
            fcode = QUEUE_F_NAMES.get(op.f)
            if fcode is None:
                return None  # not a pure enqueue/dequeue history
            if fcode == F_ENQ:
                v = op.value
            else:
                v = (
                    comp.value
                    if comp is not None and comp.type == "ok"
                    else None
                )
            if v is None:
                if fcode == F_DEQ:
                    continue  # NIL dequeue: vacuous
                return None  # enqueue of nil: keep the joint path
            subs[v].append(op)
        else:
            if op.f == "drain":
                for v, ok_op in drain_oks.pop(op.index, ()):
                    subs[v].append(ok_op)
                continue
            fcode = QUEUE_F_NAMES.get(op.f)
            if fcode is None:
                return None
            inv = history.invocation(op)
            if inv is None:
                continue  # stray completion: nothing to pair with
            if fcode == F_ENQ:
                v = inv.value
                if v is None:
                    return None
            else:
                # only ok dequeues name a value; a fail/info dequeue's
                # invoke was dropped as vacuous, its completion with it
                v = op.value if op.type == "ok" else None
                if v is None:
                    continue
            subs[v].append(op)
    return {v: History(ops, indexed=True) for v, ops in subs.items()}


def check_queue_by_value(history, model: str, init_value=None,
                         device=None):
    """Batched per-value queue check (split_queue_history_by_value)
    through sharded.check_keys, or None when the history does not
    decompose or a subhistory overflows the window. Verdict merge:
    valid iff every value is; the first invalid value re-checks through
    check_events_bucketed for its failed_op_index and failure report.

    The reference validates the history first (its history sentry,
    which repairs unclean histories and reports what it repaired); the
    port has no sentry yet, so this validates nothing: an unclean
    history is checked as given."""
    from jepsen_tpu_torch.checker.sharded import check_keys

    dev = resolve_device(device)
    subs = split_queue_history_by_value(history)
    if not subs:
        return None
    try:
        streams = {
            v: history_to_events(sub, model=model, init_value=init_value)
            for v, sub in subs.items()
        }
    except WindowOverflow:
        return None
    results = check_keys(list(streams.values()), model=model, device=dev)
    methods: dict = {}
    for r in results:
        methods[r["method"]] = methods.get(r["method"], 0) + 1
    out = {
        "valid?": True,
        "method": "per-value:" + ",".join(
            f"{m}x{n}" for m, n in sorted(methods.items())
        ),
        "n_values": len(subs),
        "frontier_k": None,
        "escalations": sum(r.get("escalations", 0) for r in results),
    }
    for v, r in zip(streams, results):
        if r["valid?"] is False:
            detail = check_events_bucketed(streams[v], model=model,
                                           device=dev)
            out["valid?"] = False
            out["failed_value"] = v
            out["failed_op_index"] = detail.get("failed_op_index")
            if "failure" in detail:
                out["failure"] = detail["failure"]
            else:
                # an index-only engine decided: harvest the report on
                # the one failing substream
                _harvest_failure(streams[v], out, model)
            break
    return out


class LinearizableChecker:
    """Checker-protocol adapter for the WGL engine (synchronous path).

    check() accepts a History or any iterable of op dicts; keyed
    histories should be split per key before reaching here."""

    def __init__(
        self,
        model: str = "cas-register",
        init_value: Any = None,
        device=None,
    ):
        self.model = model
        self.init_value = init_value
        self.device = device

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        dev = resolve_device(self.device)
        t0 = time.perf_counter()
        if self.model == "unordered-queue":
            # Queue histories decompose by value (locality, see
            # split_queue_history_by_value): one batched kernel pass over
            # the per-value substreams instead of a joint scan whose
            # packed envelope real value domains exceed at once.
            out = check_queue_by_value(
                history, self.model, init_value=self.init_value,
                device=dev,
            )
            if out is not None:
                out["n_ops"] = len(history)
                out["wall_s"] = time.perf_counter() - t0
                return out
        try:
            events = history_to_events(
                history, model=self.model, init_value=self.init_value
            )
        except WindowOverflow:
            # Too concurrent for the masks: the unbounded oracle decides.
            events = history_to_events(
                history,
                model=self.model,
                init_value=self.init_value,
                max_window=1 << 20,
            )
            out = _oracle_verdict(*_oracle_decide(events, self.model))
        else:
            out = check_events_bucketed(events, model=self.model, device=dev)
        out["n_ops"] = events.n_ops
        out["window"] = events.window
        # Every invalid verdict carries a failure report: engines that
        # return only the failing index get theirs from the oracle.
        _harvest_failure(events, out, self.model)
        out["wall_s"] = time.perf_counter() - t0
        return out


def linearizable(model: str = "cas-register", **kw) -> LinearizableChecker:
    return LinearizableChecker(model=model, **kw)
