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

On request (race=True, or race=None: on the card when eligible —
RACE_MAX_OPS, window <= 64, a model the native oracle knows) the
native C++ oracle races the device: the first definite verdict wins,
and a device win is cross-checked against the oracle's verdict
(RACE_STATS). By default nothing races, so a verdict from the card is
the kernel's. The history
sentry (history/sentry.py) validates and repairs the history first.
LinearizableChecker(plane=...) and check_async submit through a
dispatch.DispatchPlane, which coalesces many checks into shared
launches.

The gates (W buckets, K_LADDER, _pallas_ok, _jax_ok, the skip-ahead for
crash-heavy histories) are the reference's, so the same history takes
the same tier in both packages; deriving them for H100 memory is later
work. Method names: gpu-wgl-bitset, gpu-wgl-kfrontier, gpu-wgl,
cpu-oracle-native and cpu-oracle-python; per-value:<method>x<count>,...
for the queue split.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Optional

import numpy as np

from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker import wgl_native
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
from jepsen_tpu_torch.device import device_type, resolve_device
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.perf import knobs as _perf_knobs

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


@obs_trace.traced("verdict")
def _bitset_verdict(events: EventStream, steps, alive: bool, died: int,
                    model) -> dict:
    """The bitset tier's verdict dict; an invalid one carries the
    failed op index and, where the steps hold the death frontier, the
    decoded failure report."""
    out = {
        "valid?": alive,
        "method": "gpu-wgl-bitset",
        "frontier_k": None,
        "escalations": 0,
    }
    if not alive:
        out["failed_op_index"] = died
        fr = getattr(steps, "_death_frontier", None)
        if fr is not None:
            out["failure"] = bs.decode_frontier(
                fr, steps, died, model, decode_value=_decode_value(events),
            )
    return out


@obs_trace.traced("verdict")
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


#: largest stream the decision race hands to the native-oracle thread:
#: above this the device always wins and the loser thread would burn a
#: host core long after the verdict (a blocking ctypes call cannot be
#: cancelled)
RACE_MAX_OPS = 20_000


class _NativeRacer:
    """Background native-oracle run for the competition race
    (knossos's `competition` role, checker.clj:128-144): the device scan
    and the C++ oracle start together, the first definite verdict wins,
    and when both land by decision time the verdicts cross-check. The
    ctypes call releases the GIL, so the oracle overlaps the device."""

    def __init__(self, events: EventStream, model):
        self.result: Optional[tuple] = None
        self.error: Optional[BaseException] = None
        ev, mdl = events, model

        def run():
            try:
                self.result = wgl_native.check_events_native(
                    ev, model=mdl, return_stats=True
                )
            except Exception as e:  # noqa: BLE001 - reported at decision
                self.error = e

        self._thread = threading.Thread(
            target=run, daemon=True, name="wgl-native-race"
        )
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)


def _race_eligible(events: EventStream, m) -> bool:
    return (
        events.n_ops <= RACE_MAX_OPS
        and events.window <= 64
        and m.name in wgl_native._MODEL_IDS
        and wgl_native.available()
    )


#: cumulative race outcomes (reset_race_stats() for tests), bumped
#: under a lock: races finish on the dispatch plane's collecting
#: threads as well as the caller's. gpu_wins counts device verdicts
#: that were ready first (the reference's tpu_wins).
RACE_STATS = {
    "gpu_wins": 0,
    "native_wins": 0,
    "crosschecked": 0,
    "mismatches": 0,
}

_race_stats_lock = threading.Lock()


def _bump_race(key: str, n: int = 1) -> None:
    with _race_stats_lock:
        RACE_STATS[key] += n


def reset_race_stats() -> None:
    with _race_stats_lock:
        for k in RACE_STATS:
            RACE_STATS[k] = 0


def _native_win_verdict(events, racer, model, escalations=0):
    """The verdict dict of a native race win, or None if the racer
    crashed or declined (its envelope check returned None)."""
    if racer.error is not None or racer.result is None:
        return None
    valid, stats = racer.result
    _bump_race("native_wins")
    out = {
        "valid?": valid,
        "method": "cpu-oracle-native",
        "race_winner": "native",
        "frontier_k": None,
        "escalations": escalations,
    }
    if not valid:
        out["failed_op_index"] = stats.get("failed_op_index")
        # the native oracle carries no death configs: the Python rung
        # re-runs for the failure report
        _, _, failure = _oracle_decide(events, model)
        if failure is not None:
            out["failure"] = failure
    return out


def _race_decide(events, bsteps, handle, racer, model):
    """Poll until either engine has a verdict: the assembled verdict
    when the NATIVE side wins, None when the device's launch is done
    first (the caller collects it). Readiness is the launch's recorded
    CUDA event, queried without blocking (wgl_bitset.handle_ready). A
    native win leaves the device work to finish in the background; a
    device win leaves the oracle thread to run out (bounded by
    RACE_MAX_OPS)."""
    while True:
        if bs.handle_ready(handle):
            return None
        if racer.done():
            return _native_win_verdict(events, racer, model)
        time.sleep(0.001)


def _race_crosscheck(racer, gpu_alive: bool) -> None:
    """The device won: if the oracle lands within a short grace,
    cross-check the verdicts. A mismatch means an engine bug; it is
    logged loudly and counted, never raised."""
    _bump_race("gpu_wins")
    racer.join(0.05)
    if not racer.done() or racer.error or racer.result is None:
        return
    _bump_race("crosschecked")
    native_valid = racer.result[0]
    if bool(native_valid) != bool(gpu_alive):
        _bump_race("mismatches")
        logging.getLogger("jepsen_tpu_torch.checker").critical(
            "RACE MISMATCH: gpu-wgl-bitset=%s cpu-oracle-native=%s — "
            "engine bug; file with the stream's seed/material",
            gpu_alive, native_valid,
        )


def check_events_bucketed(
    events: EventStream,
    model: str = "cas-register",
    k_ladder=K_LADDER,
    device=None,
    race: Optional[bool] = False,
    checkpoint=None,
) -> dict:
    """Definite linearizability verdict for an event stream:
    {"valid?": bool, "method": "gpu-wgl-bitset"|"gpu-wgl-kfrontier"|
    "gpu-wgl"|"cpu-oracle-native"|"cpu-oracle-python", "frontier_k": K
    or None,
    "escalations": int}, plus failed_op_index (and, from the bitset
    tier and the oracle, failure) on an invalid verdict.

    device: None runs on the CUDA card (raising without one); "cpu"
    runs every kernel's plain PyTorch version.

    race: run the native C++ oracle concurrently with the device scan
    and take the first verdict (a native win carries race_winner).
    False (the default) returns the device's verdict; None races on
    the card when _race_eligible (the reference's reading of its
    default), never on the CPU (the tests' seam).

    checkpoint: a checkpoint.CheckpointSink routes the bitset tier
    through the durable group scan (one launch and one host sync per
    `every` segments, crash-safe resume, zero launches for a finished
    checkpoint: wgl_bitset.check_steps_bitset_segmented_checkpointed);
    the verdict carries the sink's summary under "checkpoint". A racer
    only cross-checks a durable verdict after it is recorded, never
    races past it. Streams outside the bitset envelope ignore the
    sink."""
    dev = resolve_device(device)
    W = _bucket_window(max(events.window, 1))
    m = get_model(model)

    # Exact bitset tier first: inside its envelope the verdict is
    # always definite. taint is impossible by construction; if it ever
    # fires, fall through to the ladder.
    racer = None  # one native racer serves the bitset AND ladder tiers
    plan = bs.plan(m, events.window, len(events.value_codes))
    if plan is not None:
        bW, S = plan
        bsteps = events_to_steps(events, W=bW)
        if checkpoint is not None:
            if race is None:
                race = dev.type == "cuda" and _race_eligible(events, m)
            if race:
                # a crosscheck, not a competition: the racer overlaps
                # the durable scan, and its verdict is compared only
                # after the device verdict is recorded
                racer = _NativeRacer(events, model)
            alive, taint, died = bs.check_steps_bitset_segmented(
                bsteps, model=model, S=S, device=dev, checkpoint=checkpoint,
            )
            if not taint:
                if racer is not None:
                    _race_crosscheck(racer, alive)
                    racer = None
                out = _bitset_verdict(events, bsteps, alive, died, model)
                out["checkpoint"] = checkpoint.summary()
                return out
        handle = bs.launch_steps_bitset_segmented(
            bsteps, model=model, S=S, device=dev
        )
        if race is None:
            race = dev.type == "cuda" and _race_eligible(events, m)
        if race:
            # started AFTER the dispatch: host prep is done, the core
            # is otherwise idle while the device scans (a tainted
            # durable run falls through with its racer already live)
            if racer is None:
                racer = _NativeRacer(events, model)
            verdict = _race_decide(events, bsteps, handle, racer, model)
            if verdict is not None:
                return verdict
        alive, taint, died = bs.collect_steps_bitset_segmented(
            bsteps, handle
        )
        if racer is not None:
            _race_crosscheck(racer, alive)
            # the crosscheck consumed this racer's verdict: drop it so
            # a taint fall-through cannot count the same finish twice
            racer = None
        if not taint:
            return _bitset_verdict(events, bsteps, alive, died, model)
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
    # The K-ladder is where escalation-heavy histories spend their
    # time, so the race matters most here: the native oracle runs
    # through every rung, and its verdict is taken at the next rung
    # boundary if it lands first.
    if race is None:
        race = dev.type == "cuda" and _race_eligible(events, m)
    if race and racer is None:
        racer = _NativeRacer(events, model)
    elif not race:
        racer = None
    escalations = 0
    for K in k_ladder:
        if racer is not None and racer.done():
            out = _native_win_verdict(events, racer, model, escalations)
            if out is not None:
                return out
            racer = None  # oracle crashed or declined: the ladder decides
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
            if racer is not None:
                _race_crosscheck(racer, alive)
            return out
        escalations += 1
    if racer is not None:
        # every rung overflowed and the racer is computing exactly the
        # oracle verdict needed: wait for it rather than start another
        racer.join(3600.0)
        out = _native_win_verdict(events, racer, model, escalations)
        if out is not None:
            return out
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
                         device=None, plane=None, validate=True,
                         strict=False, race: Optional[bool] = False,
                         mesh=None):
    """Batched per-value queue check (split_queue_history_by_value)
    through sharded.check_keys, or None when the history does not
    decompose or a subhistory overflows the window. Verdict merge:
    valid iff every value is; the first invalid value re-checks through
    check_events_bucketed for its failed_op_index and failure report.

    plane: a dispatch.DispatchPlane — the per-value substreams submit
    as individual requests and coalesce with whatever else the plane
    holds instead of forming their own batch; verdict-identical to the
    check_keys path. The plane runs on its own device.

    mesh: the layout of the batched (non-plane) path, with
    sharded.resolve_mesh semantics: None shards over every healthy slot
    of the device's type when there is more than one, False pins one
    device, a Mesh is explicit. A plane carries its own mesh, so mesh
    is ignored when plane is given.

    validate: run the history sentry first (history/sentry.py): clean
    histories pass through untouched, repaired ones carry a
    history_report in the verdict. LinearizableChecker.check already
    validated and passes False. strict: raise HistorySentryError
    instead of repairing. race: the failing value's re-check's race
    (check_events_bucketed's race=)."""
    from jepsen_tpu_torch.checker.sharded import check_keys

    dev = plane.device if plane is not None else resolve_device(device)
    hreport = None
    if validate:
        from jepsen_tpu_torch.history.sentry import validate_history

        history, hreport = validate_history(history, strict=strict)
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
    if plane is not None:
        futs = [plane.submit(s, model=model) for s in streams.values()]
        # targeted: dispatch only our substreams' buckets, so other
        # submitters' partly filled buckets keep coalescing
        plane.flush_for(futs)
        results = [f.result() for f in futs]
    else:
        results = check_keys(list(streams.values()), model=model,
                             device=dev, mesh=mesh)
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
    if hreport is not None and not hreport.get("clean"):
        out["history_report"] = hreport
    for v, r in zip(streams, results):
        if r["valid?"] is False:
            detail = check_events_bucketed(streams[v], model=model,
                                           device=dev, race=race)
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
    """Checker-protocol adapter for the WGL engine.

    check() accepts a History or any iterable of op dicts; keyed
    histories should be split per key before reaching here.

    plane: a dispatch.DispatchPlane; check() submits through it and
    check_async() becomes available, so checks from many keys or
    checkers coalesce into shared launches (verdicts are identical
    either way). sentry: validate and repair the history first
    (history/sentry.py), attaching a history_report to the verdict of a
    repaired one; strict_history raises HistorySentryError instead.
    race: the sequential path's native-oracle race (check_events_bucketed's
    race=: off by default, None by eligibility on the card only). A
    plane's own ``race`` governs checks through the plane. mesh: the
    layout of the batched non-plane path (the queue's per-value
    substreams), sharded.resolve_mesh semantics; a plane carries its
    own mesh and ignores it."""

    def __init__(
        self,
        model: str = "cas-register",
        init_value: Any = None,
        device=None,
        plane=None,
        sentry: bool = True,
        strict_history: bool = False,
        race: Optional[bool] = False,
        mesh=None,
    ):
        # perf-plane consult: load the persisted profile of the backend
        # this checker runs on (once per process and backend) so the
        # plan-time knobs (the bitset W ladder, the rows quantum) see
        # it. No-op on the common no-profile path.
        _perf_knobs.ensure_profile(
            plane.device.type if plane is not None
            else device_type(device))
        self.model = model
        self.init_value = init_value
        self.device = device
        self.plane = plane
        self.sentry = sentry
        self.strict_history = strict_history
        self.race = race
        self.mesh = mesh

    def _sentry(self, history):
        """(validated history, report-or-None) per the sentry flags."""
        if not self.sentry:
            return history, None
        from jepsen_tpu_torch.history.sentry import validate_history

        return validate_history(history, strict=self.strict_history)

    @staticmethod
    @obs_trace.traced("verdict")
    def _attach_report(out: dict, hreport) -> None:
        if hreport is not None and not hreport.get("clean"):
            out["history_report"] = hreport

    def check_async(self, test, history, opts=None):
        """Submit this history to the configured dispatch plane and
        return a zero-argument resolver; calling it blocks on the
        coalesced launch and yields the dict check() would. Requires a
        plane. Submitting many histories before resolving any lets
        them share device launches."""
        if self.plane is None:
            raise ValueError("check_async requires a dispatch plane")
        if not isinstance(history, History):
            history = History(history)
        t0 = time.perf_counter()
        history, hreport = self._sentry(history)
        fut = self.plane.submit_history(
            history, model=self.model, init_value=self.init_value
        )

        def resolve() -> dict:
            out = self._plane_result(fut)
            if fut.events is not None:
                out.setdefault("n_ops", fut.events.n_ops)
                out.setdefault("window", fut.events.window)
                _harvest_failure(fut.events, out, self.model)
            self._attach_report(out, hreport)
            out["wall_s"] = time.perf_counter() - t0
            self._render_failure(test, out, opts)
            return out

        return resolve

    def _plane_result(self, fut) -> dict:
        """Resolve a plane future. On a plane that degrades (the CPU's,
        or one built with degrade=True) a PlaneFault that reaches the
        future (the plane closed mid-flight) yields the host oracle's
        verdict, marked degraded; on any other plane it is raised."""
        from jepsen_tpu_torch.checker.chaos import PlaneFault

        try:
            return fut.result()
        except PlaneFault as pf:
            if fut.events is None or not self.plane.degrade:
                raise
            out = _oracle_verdict(*_oracle_decide(fut.events, self.model))
            out["degraded"] = pf.describe()
            return out

    def check(self, test, history, opts=None, checkpoint=None) -> dict:
        """checkpoint: a checkpoint.CheckpointSink makes the bitset tier
        durable: every verified persistence group saves atomically, and
        re-running the same check (same history, model and plan)
        resumes at the last durable frontier, or replays a finished
        verdict with zero launches. Ignored by tiers that do not
        segment (the K-frontier ladder, the oracle, the per-value
        queue check)."""
        with obs_trace.span("linearizable.check", kind="host") as sp:
            out = self._check(test, history, opts, checkpoint)
            sp.set(window=out.get("window"), method=out.get("method"),
                   valid=out.get("valid?"))
        return out

    def _check(self, test, history, opts, checkpoint) -> dict:
        if not isinstance(history, History):
            history = History(history)
        dev = (self.plane.device if self.plane is not None
               else resolve_device(self.device))
        t0 = time.perf_counter()
        history, hreport = self._sentry(history)
        if self.model == "unordered-queue":
            # Queue histories decompose by value (locality, see
            # split_queue_history_by_value): one batched kernel pass over
            # the per-value substreams instead of a joint scan whose
            # packed envelope real value domains exceed at once.
            out = check_queue_by_value(
                history, self.model, init_value=self.init_value,
                device=dev, plane=self.plane, validate=False,
                race=self.race, mesh=self.mesh,
            )
            if out is not None:
                out["n_ops"] = len(history)
                self._attach_report(out, hreport)
                out["wall_s"] = time.perf_counter() - t0
                self._render_failure(test, out, opts)
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
            if self.plane is not None:
                out = self._plane_result(
                    self.plane.submit(events, model=self.model,
                                      checkpoint=checkpoint)
                )
            else:
                out = check_events_bucketed(
                    events, model=self.model, device=dev, race=self.race,
                    checkpoint=checkpoint,
                )
        out["n_ops"] = events.n_ops
        out["window"] = events.window
        # Every invalid verdict carries a failure report: engines that
        # return only the failing index get theirs from the oracle.
        _harvest_failure(events, out, self.model)
        self._attach_report(out, hreport)
        out["wall_s"] = time.perf_counter() - t0
        self._render_failure(test, out, opts)
        return out

    def check_streaming(self, path: Optional[str] = None):
        """A streaming.StreamingCheck bound to this checker's model,
        init_value, device and plane: append(ops) checks only the new
        tail of the history, from the frontier the earlier appends left
        (on the device between appends through a plane), and result()
        gives the definite verdict. path persists the stream frontier,
        so a restarted process resumes instead of re-checking the
        prefix."""
        from jepsen_tpu_torch.checker.streaming import StreamingCheck

        return StreamingCheck(
            model=self.model,
            init_value=self.init_value,
            device=(self.plane.device if self.plane is not None
                    else self.device),
            path=path,
            plane=self.plane,
        )

    @staticmethod
    @obs_trace.traced("verdict")
    def _render_failure(test, out, opts) -> None:
        """Render the death report (knossos' linear.svg,
        checker.clj:146-154) into the run dir when one is in play:
        opts["subdirectory"] (a key's directory under
        IndependentChecker), else test["run_dir"]. Only an invalid
        verdict with a failure report renders; an OSError of the write
        is swallowed, as the check itself has already finished."""
        run_dir = (opts or {}).get("subdirectory") or (
            test.get("run_dir") if isinstance(test, dict) else None
        )
        if out["valid?"] is False and "failure" in out and run_dir:
            from jepsen_tpu_torch.checker.failure_viz import (
                write_failure_svg,
            )

            try:
                out["failure_svg"] = write_failure_svg(
                    out["failure"], run_dir,
                    failed_op_index=out.get("failed_op_index"),
                )
            except OSError:
                pass


def linearizable(model: str = "cas-register", **kw) -> LinearizableChecker:
    return LinearizableChecker(model=model, **kw)
