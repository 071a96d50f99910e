"""Async coalescing check-dispatch plane: many small checks, few launches.

The counterpart of jepsen_tpu.checker.dispatch on one CUDA device. Every
synchronous check pays its own launch and host sync; the plane accepts
check requests into a queue, COALESCES requests that share a bucketed
kernel shape into one stacked launch, DISPATCHES without blocking, and
SYNCS once per launch train at collect time. N same-shape checks then
pay one launch and one host sync instead of N of each.

Request lifecycle::

    submit(events) ──prep──▶ classify + key ──bucket──▶ coalesce
        │                                                  │ full /
        │ (async_prep: a worker thread preps and           │ aged /
        │  flushes, overlapping host prep of request       │ flush()
        │  N+1 with device execution of request N)         ▼
        │                                            stacked launch
        ▼                                                  │
    CheckFuture.result() ──────── collect train ◀──────────┘
                                  (ONE wait for every launch up to the
                                   one the future rides on)

On the card the plane owns one CUDA stream: every upload, launch, exact
re-run and device->host copy it makes runs on it. Each launch copies its
outputs into pinned host buffers with non-blocking copies and records an
event (device.copy_to_host_async); a collect waits on the event of the
last launch it needs (device.wait_train: polled under launch_deadline_s
when one is set) and counts ONE host sync, and the stream's FIFO order makes the whole prefix of the
train ready with it. On the CPU the same calls are plain copies.

Classification mirrors ``check_events_bucketed`` exactly, so verdicts
through the plane are identical to the sequential path:

- ``bitset``: inside the exact-kernel envelope (wgl_bitset.plan) with a
  single-segment plan — coalesced by ``(model, S, W, n_bucket)`` into
  one ``launch_keys_bitset`` stacked launch (kernel A, one block per
  request). Fast-tier deaths escalate to the exact tier at collect
  (collect_keys_bitset), and a confirmed death re-checks through the
  sequential path for its failure report.
- ``segmented``: bitset envelope but a multi-W segment plan (the north
  star's shape) — dispatched solo but still async: it rides the same
  collect train and shares its sync.
- ``vmap``: outside the bitset envelope but kernel-capable (packed
  queue substreams, wide windows) — coalesced by ``(model, W, n_bucket,
  ladder)`` into one key-batched torch-ops scan (wgl_torch.wgl_scan_keys,
  the reference's _wgl_vmap), with per-key overflow escalation through
  the K-ladder at collect (sharded.vmap_verdicts, which reaches kernel
  B).
- ``fallback``: host-only (window past every bucket, rich-state models)
  — resolved by ``check_events_bucketed`` on the collecting thread.
- ``stream``: a StreamingCheck's unchecked tail (submit_stream_tail),
  bucketed at submit by ``(model, S, W, length bucket, tier)`` into one
  ``launch_tails_bitset`` stacked launch (kernel A); row i starts from
  stream i's own frontier, and each rider gets its next frontier back
  as the device row ``fr_out[i]``, which never crosses to the host
  between appends (the train's one wait covers the verdicts only).
- ``graph``: a TxnGraphChecker's adjacency stacks (submit_graph),
  bucketed by ``(N, need1, need2)``; riders' stacks are concatenated on
  the device into one ``txn_graph.launch_graph_batch`` launch (at most
  GRAPH_LAUNCH_ELEMS per stack), and each rider gets its slice of the
  per-graph counts. A spent budget fails the riders with the
  PlaneFault: the checker decides whether its host census answers.

Durable checks (``submit(..., checkpoint=sink)``): a single-segment
plan binds its sink at prep (a finished checkpoint resolves right there
with zero launches) and rides the ``bitset`` bucket, its verdict
recorded in the sink at resolve (``durable_coalesced``); a
multi-segment plan runs the checkpointed group scan on the collecting
thread (kind ``durable``, ``durable_solo``).

The native-racer competition (linearizable._NativeRacer) stays
per-request: with ``race=True`` an eligible request's racer starts right
after its batch dispatches, a racer that finishes before the collect
wins the verdict, and a device win cross-checks against a racer that
lands within the grace window.

Resilience (checker/chaos.py): every launch and collect runs guarded
(retry with backoff for transient faults, a per-call deadline). On one
device a spent budget leaves no device rung. On the card the riders
then fail with the structured PlaneFault: a verdict from the card is
the kernel's or none. The host-oracle rung (the riders resolve from
the host oracle with ``degraded`` on the verdict, counted in
RESILIENCE_STATS) is the CPU plane's, and the card's only when the
caller asks for it (``degrade=True``). An error that is not a device
fault (chaos.classify_fault's "error": a Python error, a kernel that
did not build) is never retried or degraded: the riders fail with it.

Verdict parity: ``method`` records the engine AND the batch shape
("gpu-wgl-bitset-batch" vs the solo "gpu-wgl-bitset"), so differential
tests compare every verdict field except method/wall_s.

Not ported yet: mesh sharding (among it the mesh arm of the stacked
stream tails) and the multi-device rungs of the degradation ladder,
tenant attribution, trace spans and knob profiles (the knob defaults
are the module constants below).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, List, Optional

import numpy as np
import torch

from jepsen_tpu_torch.checker import chaos
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.chaos import PlaneFault
from jepsen_tpu_torch.checker.events import (
    EventStream,
    bucket,
    events_to_steps,
)
from jepsen_tpu_torch.checker.linearizable import (
    K_LADDER,
    _bitset_verdict,
    _bucket_window,
    _jax_ok,
    _native_win_verdict,
    _NativeRacer,
    _oracle_decide,
    _oracle_verdict,
    _pallas_ok,
    _race_crosscheck,
    _race_eligible,
    check_events_bucketed,
)
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.device import (
    _bump_launch,
    copy_to_host_async,
    device_label,
    launch_stats_snapshot,
    launch_stream,
    on_stream,
    record_use,
    resolve_device,
    wait_train,
)

#: occupancy at which a bucket flushes without waiting (the reference's
#: "dispatch.max_batch" knob default)
MAX_BATCH = 256

#: how long a bucket may wait for partners before an age-based flush,
#: seconds (the reference's "dispatch.coalesce_hold_s" default)
COALESCE_HOLD_S = 0.002

#: unresolved launch trains in flight before registering another
#: collects the oldest (the reference's "dispatch.max_inflight_trains"
#: default)
MAX_INFLIGHT_TRAINS = 2

#: length-bucket quantum for coalescing stream tails into one stacked
#: launch (the reference's "streaming.tail_len_bucket" default)
STREAM_TAIL_BUCKET = 64

_log = logging.getLogger("jepsen_tpu_torch.checker")

#: plane-level dispatch accounting (launch-level counts live in
#: device.LAUNCH_STATS): "requests" = submissions accepted, "batches" =
#: coalesced stacked launches formed, "batched_requests" = requests
#: those batches carried, "solo_launches" = uncoalescible dispatches
#: (segmented plans), "fallbacks" = host-only resolutions, "max_batch"
#: = largest batch occupancy seen, "coalesce_wait_us" = total
#: microseconds batched requests spent parked in a bucket,
#: "native_wins" = racer verdicts that beat the device, "worker_errors"
#: = exceptions the async prep worker's keep-alive swallowed,
#: "pending_at_close" = futures still unresolved when close() returned
#: (resolved with a PlaneFault, never dropped). Double-buffered
#: trains: every registration samples how many unresolved trains are in
#: flight (train_inflight_accum / train_registers =
#: double_buffer_occupancy); registrations past max_inflight_trains
#: collect the oldest train first (backpressure_collects). Durable
#: checks: "durable_coalesced" = single-segment plans that rode a bucket
#: (zero-launch replays at prep included), "durable_solo" =
#: multi-segment plans run by the checkpointed group scan. Stream
#: tails: "stream_requests" = tails submitted, "stream_batches" =
#: stacked tail launches formed from them. Txn graphs:
#: "graph_requests" = adjacency stacks submitted, "graph_batches" =
#: coalesced graph launches formed from them (requests / batches > 1:
#: concurrent graph checks shared a launch).
DISPATCH_STATS = {
    "requests": 0,
    "batches": 0,
    "batched_requests": 0,
    "solo_launches": 0,
    "fallbacks": 0,
    "max_batch": 0,
    "coalesce_wait_us": 0.0,
    "native_wins": 0,
    "worker_errors": 0,
    "pending_at_close": 0,
    "train_registers": 0,
    "train_inflight_accum": 0,
    "backpressure_collects": 0,
    "durable_coalesced": 0,
    "durable_solo": 0,
    "stream_requests": 0,
    "stream_batches": 0,
    "graph_requests": 0,
    "graph_batches": 0,
}

_stats_lock = threading.Lock()

#: per-device dispatch accounting: device label -> {"launches":
#: dispatches that placed work there, "requests": requests whose scan
#: ran there}
DEVICE_STATS: "OrderedDict[str, dict]" = OrderedDict()


def _bump(key: str, n=1) -> None:
    with _stats_lock:
        DISPATCH_STATS[key] += n


def _bump_device(label: str, requests: int = 0, launches: int = 0) -> None:
    with _stats_lock:
        d = DEVICE_STATS.setdefault(label, {"launches": 0, "requests": 0})
        d["launches"] += launches
        d["requests"] += requests


def reset_dispatch_stats() -> None:
    with _stats_lock:
        for k in DISPATCH_STATS:
            DISPATCH_STATS[k] = 0.0 if k == "coalesce_wait_us" else 0
        DEVICE_STATS.clear()


def dispatch_stats() -> dict:
    """Snapshot + derived ratios. floor_amortization: launched requests
    per launch paid (N = N requests shared each sync).
    mean_batch_occupancy, mean_coalesce_wait_us and
    double_buffer_occupancy as the names say; per_device: each device's
    counts, its own floor_amortization and its share of all launches;
    resilience: chaos.resilience_snapshot() plus worker_errors;
    checkpoint: checkpoint.checkpoint_stats(). Each stats surface is
    copied under its own lock (they never nest)."""
    from jepsen_tpu_torch.checker.checkpoint import checkpoint_stats

    with _stats_lock:
        out = dict(DISPATCH_STATS)
        per_dev = {k: dict(v) for k, v in DEVICE_STATS.items()}
    launches = out["batches"] + out["solo_launches"]
    carried = out["batched_requests"] + out["solo_launches"]
    out["mean_batch_occupancy"] = (
        out["batched_requests"] / out["batches"] if out["batches"] else 0.0
    )
    out["floor_amortization"] = carried / launches if launches else 0.0
    out["mean_coalesce_wait_us"] = (
        out["coalesce_wait_us"] / out["batched_requests"]
        if out["batched_requests"]
        else 0.0
    )
    total_dev_launches = sum(d["launches"] for d in per_dev.values())
    for d in per_dev.values():
        d["floor_amortization"] = (
            d["requests"] / d["launches"] if d["launches"] else 0.0
        )
        d["occupancy"] = (
            d["launches"] / total_dev_launches if total_dev_launches else 0.0
        )
    out["per_device"] = per_dev
    out["n_devices"] = len(per_dev)
    out["double_buffer_occupancy"] = (
        out["train_inflight_accum"] / out["train_registers"]
        if out["train_registers"]
        else 0.0
    )
    out["launch"] = launch_stats_snapshot()
    res = chaos.resilience_snapshot()
    res["worker_errors"] = out["worker_errors"]
    out["resilience"] = res
    out["checkpoint"] = checkpoint_stats()
    return out


class CheckFuture:
    """Handle for one submitted check. ``result()`` drives the owning
    plane as needed (flushing its bucket, collecting the launch train)
    and returns the verdict dict — or, for raw steps-level submissions
    (run_keys), the (alive, taint, died) tuple check_keys_bitset
    callers expect."""

    def __init__(self, plane: "DispatchPlane", events, model: str):
        self.plane = plane
        self.events = events
        self.model = model  # original model name (racer + fallbacks)
        self.kind: Optional[str] = None
        self.kernel_model = model  # post packed-substitution
        self.checkpoint = None  # durable sink (submit(checkpoint=))
        self.steps = None
        self.frontier = None  # a stream tail's starting frontier
        self.graph = None  # a graph rider's (wrww, allm, rw) stacks
        self.S = 8
        self.key = None
        self.launch: Optional["_Launch"] = None
        self.racer = None
        self.wrap = True  # False: resolve to the raw bitset tuple
        self._bucketed_at: Optional[float] = None
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.is_set():
            self.plane._drive(self)
        if not self._done.wait(timeout):
            raise TimeoutError("check did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, value) -> None:
        if not self._done.is_set():
            self._result = value
            self._done.set()

    def _fail(self, err: BaseException) -> None:
        if not self._done.is_set():
            self._error = err
            self._done.set()


class _Launch:
    """One dispatched device computation, the futures riding it, and
    the host side of its outputs (a device.HostCopy)."""

    __slots__ = ("kind", "futs", "handle", "meta", "host", "resolved")

    def __init__(self, kind: str, futs: List[CheckFuture],
                 meta: Optional[dict] = None):
        self.kind = kind
        self.futs = futs
        self.meta = meta or {}
        self.handle = None
        self.host = None
        self.resolved = False

    def device_out(self) -> list:
        """The device tensors one collect must bring to the host."""
        if self.kind in ("bitset", "stream"):
            # a stream launch fetches its verdicts only: the stacked
            # fr_out stays on the device
            return [self.handle[0]]
        if self.kind == "segmented":
            return list(self.handle[0])
        return list(self.handle)  # vmap: (alive, overflow, died)


class _Bucket:
    __slots__ = ("futs", "born")

    def __init__(self):
        self.futs: List[CheckFuture] = []
        self.born = time.perf_counter()


class DispatchPlane:
    """The async coalescing dispatch plane (module docstring).

    Parameters:
      model: default model for ``submit``.
      device: None means the CUDA card (raising without one); "cpu"
        runs every kernel's plain version (the tests' seam).
      race: start the native-oracle competition racer for eligible
        requests (off by default: the plane is a throughput surface).
      degrade: when a launch or collect spends its guard's budget,
        resolve its riders from the host oracle, ``degraded`` on the
        verdict, instead of failing them with the PlaneFault. None =
        on for the CPU, off for the card.
      coalesce_wait_us: how long a bucket may wait for partners before
        an age-based flush (async_prep mode; synchronous callers flush
        explicitly or at result()). None = COALESCE_HOLD_S.
      async_prep: run prep + flush on a worker thread, overlapping host
        prep of request N+1 with device execution of request N.
      retry: chaos.RetryPolicy for the launch/collect guards; None =
        chaos.DEFAULT_RETRY.
      launch_deadline_s: per-guarded-call wall budget. A hung collect
        (the train's event never fires) or a wedged launch times out
        with DeadlineExceeded instead of wedging the plane: the call
        retries, then fails (or degrades, per ``degrade``). None = no
        deadline.
      worker_join_s: how long close() waits for the async prep worker
        before declaring it leaked and resolving pending futures with a
        PlaneFault.
      max_inflight_trains: unresolved trains in flight before a new
        registration collects the oldest (None = MAX_INFLIGHT_TRAINS).
      owner: a location tag for this plane's process, stamped onto any
        CheckpointSink without an owner that rides submit(), so durable
        state records where it was written (checkpoint.py `handoffs`).
    """

    def __init__(
        self,
        model: str = "cas-register",
        device=None,
        race: bool = False,
        degrade: Optional[bool] = None,
        coalesce_wait_us: Optional[float] = None,
        async_prep: bool = False,
        retry: Optional[chaos.RetryPolicy] = None,
        launch_deadline_s: Optional[float] = None,
        worker_join_s: float = 10.0,
        max_inflight_trains: Optional[int] = None,
        owner: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.race = race
        self.degrade = (self.device.type == "cpu" if degrade is None
                        else bool(degrade))
        if coalesce_wait_us is None:
            coalesce_wait_us = 1e6 * COALESCE_HOLD_S
        self.coalesce_wait_s = coalesce_wait_us / 1e6
        self.max_inflight_trains = max(int(
            MAX_INFLIGHT_TRAINS if max_inflight_trains is None
            else max_inflight_trains
        ), 1)
        self.retry = retry or chaos.DEFAULT_RETRY
        self.launch_deadline_s = launch_deadline_s
        self.worker_join_s = worker_join_s
        self.owner = owner
        self._label = device_label(self.device)
        #: the plane's one launch stream (None on the CPU): uploads,
        #: launches, exact re-runs and copies all queue on it, so one
        #: event marks a whole train prefix done
        self._stream = launch_stream(self.device)
        self._lock = threading.Lock()  # inbox + buckets + launched
        self._pump_lock = threading.Lock()  # serializes prep/flush
        self._collect_lock = threading.Lock()  # serializes resolution
        self._inbox: deque = deque()
        self._buckets: "OrderedDict[Any, _Bucket]" = OrderedDict()
        self._launched: List[_Launch] = []
        self._fallbacks: List[CheckFuture] = []
        self._worker: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._closing = threading.Event()
        if async_prep:
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name="dispatch-plane-prep",
            )
            self._worker.start()

    # -- submission ----------------------------------------------------

    def submit(self, events: EventStream, model: Optional[str] = None,
               checkpoint=None) -> CheckFuture:
        """Queue one event-stream check; returns its CheckFuture.

        checkpoint: a checkpoint.CheckpointSink makes the check durable
        (module docstring: a single-segment plan rides a bucket and
        replays a finished verdict at prep with zero launches, a
        multi-segment plan runs the checkpointed group scan). Streams
        outside the bitset envelope ignore the sink."""
        fut = CheckFuture(self, events, model or self.model)
        fut.checkpoint = checkpoint
        if (checkpoint is not None and self.owner is not None
                and checkpoint.owner is None):
            # stamp un-owned durable state; an explicit owner wins
            checkpoint.owner = self.owner
        _bump("requests")
        if self._worker is not None:
            with self._lock:
                self._inbox.append(fut)
            self._wake.set()
        else:
            self._prep_and_enqueue(fut)
        return fut

    def submit_history(self, history, model: Optional[str] = None,
                       init_value=None) -> CheckFuture:
        """Encode + queue a record history (LinearizableChecker's
        entry). Window overflow routes to the oracle fallback, as in
        the sequential checker."""
        from jepsen_tpu_torch.checker.events import (
            WindowOverflow,
            history_to_events,
        )

        name = model or self.model
        try:
            events = history_to_events(
                history, model=name, init_value=init_value
            )
        except WindowOverflow:
            events = history_to_events(
                history, model=name, init_value=init_value,
                max_window=1 << 20,
            )
        return self.submit(events, model=name)

    def submit_stream_tail(self, steps, frontier,
                           model: Optional[str] = None, S: int = 8,
                           exact: bool = False) -> CheckFuture:
        """Queue one stream's unchecked TAIL (the ``stream`` bucket):
        ``steps`` is a single-W ReturnSteps slice and ``frontier`` the
        stream's boundary frontier (None for a fresh stream, a host
        array, or the device row a previous stacked launch left).
        Tails sharing (model, S, W, length bucket, tier) stack into ONE
        launch_tails_bitset launch. The future resolves to the raw
        ``(alive, taint, died, fr_row)``, fr_row being the stream's next
        frontier as a device row. Escalation and death reports stay with
        the StreamingCheck. Tails skip the prep worker: they bucket
        here, and a full bucket flushes on this thread."""
        name = model or self.model
        name = name if isinstance(name, str) else name.name
        fut = CheckFuture(self, None, name)
        fut.kind = "stream"
        fut.wrap = False
        fut.steps = steps
        fut.frontier = frontier
        n = bucket(max(len(steps), 1), STREAM_TAIL_BUCKET)
        fut.key = ("stream", name, S, steps.W, n, bool(exact))
        _bump("requests")
        _bump("stream_requests")
        self._park(fut)
        if self._worker is not None:
            self._wake.set()
        return fut

    def submit_graph(self, wrww, allm, rw, need=(True, True)
                     ) -> CheckFuture:
        """Queue one txn dependency-graph adjacency batch (the ``graph``
        bucket): wrww/allm float32 and rw bool, each [B, N, N], tensors
        on the plane's device. Batches bucket by (N, edge-class needs),
        so concurrent graph checks with same-sized components coalesce
        into one stacked closure launch. The future resolves to the raw
        per-graph int32 count arrays (g1c, g_single, g2), each [B]: the
        TxnGraphChecker builds the verdict."""
        if wrww.ndim != 3 or wrww.shape != allm.shape or \
                wrww.shape != rw.shape:
            raise ValueError(
                f"graph stacks must share one [B, N, N] shape, got "
                f"{tuple(wrww.shape)}/{tuple(allm.shape)}/"
                f"{tuple(rw.shape)}"
            )
        if (wrww.dtype, allm.dtype, rw.dtype) != (
                torch.float32, torch.float32, torch.bool):
            raise ValueError(
                f"graph stacks must be float32/float32/bool, got "
                f"{wrww.dtype}/{allm.dtype}/{rw.dtype}"
            )
        if device_label(wrww.device) != self._label:
            raise ValueError(
                f"graph stacks on {wrww.device}, the plane runs on "
                f"{self._label}"
            )
        fut = CheckFuture(self, None, "txn-graph")
        fut.kind = "graph"
        fut.wrap = False
        fut.graph = (wrww, allm, rw)
        fut.key = ("graph", int(wrww.shape[-1]), bool(need[0]),
                   bool(need[1]))
        _bump("requests")
        _bump("graph_requests")
        self._park(fut)
        if self._worker is not None:
            self._wake.set()
        return fut

    def flush(self) -> None:
        """Prep everything queued and dispatch every pending bucket
        (returns once dispatched — collection happens at
        result()/drain())."""
        self._pump(flush_all=True)

    def flush_for(self, futs) -> None:
        """Targeted flush: dispatch only the buckets holding these
        futures. Other submitters' partly filled buckets keep
        coalescing (check_queue_by_value's per-value substreams use
        this on a shared plane)."""
        self._pump(flush_futs=tuple(futs))

    def drain(self) -> None:
        """Flush, then collect the whole launch train (one wait) and
        resolve every outstanding future, fallbacks included."""
        self._pump(flush_all=True)
        with self._lock:
            pending = [L for L in self._launched if not L.resolved]
        if pending:
            self._collect_upto(pending[-1])
        self._resolve_fallbacks()

    def close(self) -> None:
        """Shut the plane down with every future accounted for: join
        the prep worker (bounded), drain the train, and resolve ANY
        still-pending future with a structured PlaneFault — close()
        always returns. A worker that outlives its join budget is a
        leak: it may hold _pump_lock, so the drain is skipped and
        pending futures fail over immediately."""
        self._closing.set()
        self._wake.set()
        leaked = None
        if self._worker is not None:
            w = self._worker
            w.join(timeout=self.worker_join_s)
            if w.is_alive():
                leaked = w
            self._worker = None
        if leaked is not None:
            _log.error(
                "dispatch plane prep worker %r failed to join within "
                "%.1fs (leaked thread); resolving pending futures with "
                "PlaneFault", leaked.name, self.worker_join_s,
            )
            self._fail_pending(PlaneFault(
                site="close", kind="worker-leak", attempts=0,
            ))
            return
        try:
            self.drain()
        finally:
            self._fail_pending(PlaneFault(
                site="close", kind="abandoned", attempts=0,
            ))

    def _fail_pending(self, pf: PlaneFault) -> int:
        """Resolve every future the plane still holds with ``pf``;
        returns the count (DISPATCH_STATS['pending_at_close'])."""
        with self._lock:
            futs = list(self._inbox)
            self._inbox.clear()
            for b in self._buckets.values():
                futs.extend(b.futs)
            self._buckets.clear()
            futs.extend(self._fallbacks)
            self._fallbacks = []
            for L in self._launched:
                futs.extend(L.futs)
            self._launched = []
        n = 0
        for f in futs:
            if not f.done():
                f._fail(pf)
                n += 1
        if n:
            _bump("pending_at_close", n)
            chaos.note_plane_fault(n)
            _log.warning(
                "dispatch plane closed with %d pending future(s); "
                "resolved with %s", n, pf,
            )
        return n

    def __enter__(self) -> "DispatchPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- prep + classification ----------------------------------------

    def _worker_loop(self) -> None:
        while not self._closing.is_set():
            self._wake.wait(timeout=self.coalesce_wait_s)
            self._wake.clear()
            try:
                self._pump()
            except Exception:  # keep the loop alive, but never silently
                _bump("worker_errors")
                _log.exception(
                    "dispatch plane prep worker error "
                    "(DISPATCH_STATS['worker_errors'] counts these)"
                )

    def _pump(self, flush_all: bool = False, flush_futs=()) -> None:
        """Prep the inbox, bucket/dispatch each request, and flush aged
        buckets — plus the buckets holding ``flush_futs``, or every
        bucket with ``flush_all``. Callable from the worker thread and
        from any caller needing progress; _pump_lock makes it
        single-file, and its device work queues on the plane's
        stream."""
        with self._pump_lock, on_stream(self._stream):
            while True:
                with self._lock:
                    if not self._inbox:
                        break
                    fut = self._inbox.popleft()
                self._prep_and_enqueue(fut)
            # bucket keys are assigned during prep, so the targets are
            # read only after the inbox drains
            targets = {f.key for f in flush_futs if f.key is not None}
            now = time.perf_counter()
            with self._lock:
                keys = [
                    k for k, b in self._buckets.items()
                    if flush_all or k in targets
                    or now - b.born >= self.coalesce_wait_s
                ]
            for k in keys:
                self._flush_bucket(k)

    def _prep_and_enqueue(self, fut: CheckFuture) -> None:
        try:
            self._prep_one(fut)
        except Exception as e:  # noqa: BLE001 - delivered at result()
            fut._fail(e)
            return
        if fut.kind == "done":
            return  # resolved at prep (a checkpoint replay)
        if fut.kind == "segmented":
            with on_stream(self._stream):
                self._dispatch_segmented(fut)
        elif fut.kind in ("fallback", "durable"):
            _bump("fallbacks" if fut.kind == "fallback" else "durable_solo")
            with self._lock:
                self._fallbacks.append(fut)
        else:
            self._park(fut)

    def _park(self, fut: CheckFuture) -> None:
        """Put a keyed future in its bucket; a bucket that reaches
        MAX_BATCH flushes on this thread."""
        full = None
        with self._lock:
            b = self._buckets.get(fut.key)
            if b is None:
                b = self._buckets[fut.key] = _Bucket()
            b.futs.append(fut)
            fut._bucketed_at = time.perf_counter()
            if len(b.futs) >= MAX_BATCH:
                full = fut.key
        if full is not None:
            with on_stream(self._stream):
                self._flush_bucket(full)

    def _prep_one(self, fut: CheckFuture) -> None:
        """Classify one request, mirroring check_events_bucketed's tier
        order exactly (bitset plan on the ORIGINAL model, then packed
        substitution, then the K-ladder envelope)."""
        ev = fut.events
        m = get_model(fut.model)
        plan = bs.plan(m, ev.window, len(ev.value_codes))
        if plan is not None:
            bW, S = plan
            steps = events_to_steps(ev, W=bW)
            fut.steps = steps
            fut.S = S
            if fut.checkpoint is not None:
                # durable checks plan with the SINK's segment floor, so
                # the content hash matches the sequential checkpointed
                # scan's (replay and resume interchange across both)
                segs = bs._plan_for(steps, fut.checkpoint.seg_min_len)
                if len(segs) > 1:
                    # the group scan is its own launch loop, run on
                    # the collecting thread
                    fut.kind = "durable"
                    return
                _bump("durable_coalesced")
                if self._checkpoint_replay(fut, steps, m.name, S, segs):
                    return
            elif len(bs._plan_for(steps, None)) > 1:
                fut.kind = "segmented"
                return
            fut.kind = "bitset"
            n = bucket(max(len(steps), 1), 64)
            fut.key = ("bitset", m.name, S, bW, n)
            return
        W = _bucket_window(max(ev.window, 1))
        if (
            W is not None
            and not m.jax_capable
            and m.packed_variant
            and m.packed_ok is not None
            and m.packed_ok(ev)
        ):
            m = get_model(m.packed_variant)
        if W is None or not m.jax_capable:
            fut.kind = "fallback"
            return
        fut.kind = "vmap"
        fut.kernel_model = m.name
        steps = events_to_steps(ev, W=W)
        # The solo K-ladder's crash-skip heuristic: crash-heavy
        # histories start at the >=256 rungs (when runnable), so the
        # plane's starting rung — and the verdict's frontier_k —
        # matches the sequential path. The ladder is part of the
        # bucket key: a batch shares one rung schedule.
        NW = steps.NW
        n_crashed = (
            int(np.unpackbits(steps.crashed[-1].view(np.uint8)).sum())
            if len(steps)
            else 0
        )

        def _runnable(K):
            return _pallas_ok(K, W, NW) or _jax_ok(K, W, NW)

        ladder = K_LADDER
        if n_crashed >= 6:
            bigger = tuple(K for K in ladder if K >= 256 and _runnable(K))
            if bigger:
                ladder = bigger
        if not _runnable(ladder[0]):
            fut.kind = "fallback"  # first rung infeasible: the oracle
            return
        fut.key = ("vmap", m.name, W, bucket(max(len(steps), 1), 64),
                   ladder)

    # -- dispatch ------------------------------------------------------

    def _start_racer(self, fut: CheckFuture) -> None:
        """Competition racer, started AFTER the dispatch (host prep is
        done; the core idles through the device scan)."""
        if not (self.race and fut.wrap and fut.events is not None):
            return
        if _race_eligible(fut.events, get_model(fut.model)):
            fut.racer = _NativeRacer(fut.events, fut.model)

    def _register_launch(self, launch: _Launch) -> None:
        """Register one in-flight train. The device->host copies of its
        outputs start NOW (device.copy_to_host_async, with the event
        the collect waits on), so they overlap the next train's host
        prep and device work. At most ``max_inflight_trains`` stay
        unresolved: registering past the cap collects the oldest train
        on THIS thread — the backpressure that keeps a submit burst
        from queueing unbounded device memory."""
        launch.host = copy_to_host_async(launch.device_out(), self._stream)
        with self._lock:
            self._launched.append(launch)
            pending = [L for L in self._launched if not L.resolved]
        _bump("train_registers")
        _bump("train_inflight_accum", len(pending))
        for f in launch.futs:
            f.launch = launch
        for f in launch.futs:
            self._start_racer(f)
        excess = len(pending) - self.max_inflight_trains
        if excess > 0:
            _bump("backpressure_collects", excess)
            self._collect_upto(pending[excess - 1])

    # -- resilience: guards + the degradation ladder -------------------

    def guard(self, site: str, thunk) -> Any:
        """Run one launch/collect callable through the chaos seam with
        this plane's retry policy and per-call deadline. Raises a
        structured PlaneFault when the budget is spent. The callable
        runs on the plane's stream in whichever thread runs it (a
        deadline moves it to a helper thread, and the current stream is
        per thread)."""
        stream = self._stream

        def on_plane_stream():
            with on_stream(stream):
                return thunk()

        return chaos.resilient_call(
            on_plane_stream, site=site, devices=[self._label],
            policy=self.retry, deadline_s=self.launch_deadline_s,
            on_fault=self._on_fault,
        )

    @staticmethod
    def _on_fault(kind: str, device: Optional[str],
                  exc: BaseException) -> None:
        """Per-attempt failure accounting: attributed failures count
        against their device (chaos.note_device_failure)."""
        if device is not None and chaos.note_device_failure(device):
            _log.warning(
                "device %s quarantined after repeated attributed "
                "failures (%s: %s)", device, type(exc).__name__, exc,
            )

    def _dispatch_resilient(self, launch_with):
        """Run ``launch_with()`` guarded: (handle, None) on success, or
        (None, PlaneFault) when the guard's budget is spent. On one
        device that spends every device rung of the reference's ladder
        (its rung 4, counted as a degradation when the plane degrades):
        the caller hands the riders to _oracle_resolve."""
        try:
            return self.guard("launch", launch_with), None
        except PlaneFault as pf:
            if self.degrade:
                chaos.note_degradation()
            return None, pf

    def _oracle_resolve(self, futs, pf: PlaneFault) -> None:
        """The ladder's last rung. Without ``degrade`` (the card's
        default) each rider fails with the structured PlaneFault. With
        it, each rider resolves from the host oracle (_oracle_decide,
        no device work), whose verdict equals the kernel path's by
        construction, with ``degraded`` set. Raw steps-level futures
        (run_keys) carry no events to re-decide, so they fail with the
        PlaneFault either way."""
        for f in futs:
            if f.done():
                continue
            if f.events is None or not self.degrade:
                chaos.note_plane_fault()
                f._fail(pf)
                continue
            chaos.note_oracle_fallback()
            try:
                out = _oracle_verdict(*_oracle_decide(f.events, f.model))
            except Exception as e:  # noqa: BLE001 - structured envelope
                chaos.note_plane_fault()
                f._fail(PlaneFault(
                    site="oracle", kind="fatal", attempts=1, cause=e,
                ))
                continue
            out["degraded"] = pf.describe()
            self._finish(f, out)

    def _flush_bucket(self, key) -> None:
        with self._lock:
            b = self._buckets.pop(key, None)
        if b is None:
            return
        now = time.perf_counter()
        wait_us = sum(
            (now - f._bucketed_at) * 1e6
            for f in b.futs
            if f._bucketed_at is not None
        )
        _bump("batches")
        _bump("batched_requests", len(b.futs))
        _bump("coalesce_wait_us", wait_us)
        with _stats_lock:
            DISPATCH_STATS["max_batch"] = max(
                DISPATCH_STATS["max_batch"], len(b.futs)
            )
        try:
            if key[0] == "bitset":
                self._dispatch_bitset_batch(b.futs, key)
            elif key[0] == "stream":
                self._dispatch_stream_batch(b.futs, key)
            elif key[0] == "graph":
                self._dispatch_graph_batch(b.futs, key)
            else:
                self._dispatch_vmap_batch(b.futs, key)
        except Exception as e:  # noqa: BLE001 - delivered at result()
            for f in b.futs:
                f._fail(e)

    def _dispatch_bitset_batch(self, futs, key) -> None:
        _, name, S, _W, _n = key
        handle, pf = self._dispatch_resilient(
            lambda: bs.launch_keys_bitset(
                [f.steps for f in futs], model=name, S=S,
                device=self.device,
            )
        )
        if handle is None:
            self._oracle_resolve(futs, pf)
            return
        launch = _Launch("bitset", futs)
        launch.handle = handle
        _bump_device(self._label, requests=len(futs), launches=1)
        self._register_launch(launch)

    def _dispatch_stream_batch(self, futs, key) -> None:
        """Stack same-shape stream tails and their frontiers into one
        bitset launch. A spent budget fails the riders with the
        PlaneFault: a stream's frontier chain is the StreamingCheck's
        state, so there is no oracle arm here; the handle re-runs the
        tail on its solo chain."""
        _, name, S, _W, _n, exact = key
        try:
            handle = self.guard("launch", lambda: bs.launch_tails_bitset(
                [f.steps for f in futs], [f.frontier for f in futs],
                model=name, S=S, exact=exact, device=self.device,
            ))
        except PlaneFault as pf:
            for f in futs:
                chaos.note_plane_fault()
                f._fail(pf)
            return
        _bump("stream_batches")
        launch = _Launch("stream", futs)
        launch.handle = handle
        _bump_device(self._label, requests=len(futs), launches=1)
        self._register_launch(launch)

    #: coalesced graph launch memory cap, in elements per adjacency
    #: stack (3 stacks + 2 closures ride each launch)
    GRAPH_LAUNCH_ELEMS = 1 << 24

    def _dispatch_graph_batch(self, futs, key) -> None:
        """Concatenate same-shaped adjacency stacks into coalesced
        closure launches. Groups are bounded by GRAPH_LAUNCH_ELEMS so a
        pile-up of big stacks cannot blow device memory — an over-cap
        single future still launches (alone)."""
        _, n, need1, need2 = key
        per_graph = n * n
        group: list = []
        elems = 0
        for f in futs:
            b = int(f.graph[0].shape[0])
            if group and elems + b * per_graph > self.GRAPH_LAUNCH_ELEMS:
                self._launch_graph_group(group, need1, need2)
                group, elems = [], 0
            group.append(f)
            elems += b * per_graph
        if group:
            self._launch_graph_group(group, need1, need2)

    def _launch_graph_group(self, futs, need1: bool, need2: bool) -> None:
        """One graph launch for ``futs``: their stacks concatenated on
        the device (on the plane's stream, under its guard), the counts
        copied back with the train. A spent budget fails the riders
        with the PlaneFault: the checker, which holds the edges, decides
        whether its host census answers."""
        from jepsen_tpu_torch.checker import txn_graph as tg

        sizes = [int(f.graph[0].shape[0]) for f in futs]

        def launch_with():
            for f in futs:
                record_use(f.graph)
            if len(futs) == 1:
                stacks = futs[0].graph
            else:
                stacks = [torch.cat([f.graph[i] for f in futs])
                          for i in range(3)]
            return tg.launch_graph_batch(*stacks, need1=need1,
                                         need2=need2)

        tg.note_graph_launch(sum(sizes), int(futs[0].graph[0].shape[-1]),
                             need1, need2)
        handle, pf = self._dispatch_resilient(launch_with)
        if handle is None:
            for f in futs:
                chaos.note_plane_fault()
                f._fail(pf)
            return
        _bump("graph_batches")
        launch = _Launch("graph", futs, {"sizes": sizes})
        launch.handle = handle
        _bump_device(self._label, requests=len(futs), launches=1)
        self._register_launch(launch)
        for f in futs:
            f.graph = None  # the stacks are dead weight once launched

    def _dispatch_vmap_batch(self, futs, key) -> None:
        from jepsen_tpu_torch.checker.sharded import stack_streams
        from jepsen_tpu_torch.checker.wgl_torch import wgl_scan_keys

        _, name, W, _n, ladder = key
        K = ladder[0]

        def launch_with():
            cols = stack_streams([f.events for f in futs], W=W, model=name)
            return wgl_scan_keys(cols, name, K, self.device)

        handle, pf = self._dispatch_resilient(launch_with)
        if handle is None:
            self._oracle_resolve(futs, pf)
            return
        launch = _Launch("vmap", futs, {
            "model": name, "K": K, "W": W, "k_ladder": ladder,
            "method": "gpu-wgl-batch",
        })
        launch.handle = handle
        _bump_device(self._label, requests=len(futs), launches=1)
        self._register_launch(launch)

    def _dispatch_segmented(self, fut: CheckFuture) -> None:
        _bump("solo_launches")
        try:
            handle, pf = self._dispatch_resilient(
                lambda: bs.launch_steps_bitset_segmented(
                    fut.steps, model=fut.model, S=fut.S,
                    device=self.device,
                )
            )
        except Exception as e:  # noqa: BLE001 - delivered at result()
            fut._fail(e)
            return
        if handle is None:
            self._oracle_resolve([fut], pf)
            return
        launch = _Launch("segmented", [fut])
        launch.handle = handle
        _bump_device(self._label, requests=1, launches=1)
        self._register_launch(launch)

    # -- collection ----------------------------------------------------

    def _drive(self, fut: CheckFuture) -> None:
        """Make enough progress to resolve one future: prep the inbox,
        flush the bucket THIS future rides (other buckets keep
        coalescing), then collect its launch's prefix of the train."""
        self._pump(flush_futs=(fut,))
        if fut.done():
            return
        if fut.kind in ("fallback", "durable"):
            self._resolve_fallbacks()
            return
        while not fut.done():
            launch = fut.launch
            if launch is not None:
                self._collect_upto(launch)
                return
            # A concurrent flush (bucket-full trigger on a submitting
            # thread) popped the bucket but has not registered the
            # launch yet: it either registers or fails the futures.
            time.sleep(0.0005)

    def _train_get(self, hosts) -> list:
        """The guarded collect: wait once for the last launch of the
        prefix (its event; the stream is FIFO, so every earlier launch
        is done too) and hand back each launch's host arrays."""
        wait_train(hosts[-1], self.launch_deadline_s)
        return [h.arrays for h in hosts]

    def _collect_upto(self, target: _Launch) -> None:
        """ONE wait over every unresolved launch up to (and including)
        the target, then resolve their futures. Resolved launches leave
        the train at once and drop their handles, host buffers and
        riders' steps, so a long-lived plane does not pin memory."""
        with self._collect_lock, on_stream(self._stream):
            if target.resolved:
                return
            with self._lock:
                idx = self._launched.index(target)
                prefix = [
                    L for L in self._launched[: idx + 1] if not L.resolved
                ]
            # Per-request competition: a racer that already finished
            # beats the device — its future resolves native and the
            # device verdict is discarded.
            for L in prefix:
                for f in L.futs:
                    if f.racer is not None and f.racer.done():
                        out = _native_win_verdict(f.events, f.racer,
                                                  f.model)
                        if out is not None:
                            _bump("native_wins")
                            f.racer = None
                            f._resolve(out)
            try:
                # the train's one counted host sync; the wait runs
                # guarded (a hung event times out against
                # launch_deadline_s and retries; an exhausted budget
                # degrades every rider below)
                _bump_launch("host_syncs")
                hosts = [L.host for L in prefix]
                host = self.guard("collect", lambda: self._train_get(hosts))
            except BaseException as e:  # noqa: BLE001 - re-raised if raw
                try:
                    for L in prefix:
                        if isinstance(e, PlaneFault):
                            self._oracle_resolve(L.futs, e)
                        else:
                            for f in L.futs:
                                f._fail(e)
                        self._retire(L)
                finally:
                    with self._lock:
                        self._launched = [
                            L for L in self._launched if not L.resolved
                        ]
                if isinstance(e, PlaneFault):
                    return
                raise
            try:
                for L, h in zip(prefix, host):
                    try:
                        self._resolve_launch(L, h)
                    except PlaneFault as pf:
                        # a collect-time exact re-run spent its guard:
                        # this launch's riders take the last rung; the
                        # rest of the train resolves normally
                        self._oracle_resolve(L.futs, pf)
                    except BaseException as e:  # noqa: BLE001
                        # never strand siblings in result(): fail the
                        # rest, re-raise
                        for f in L.futs:
                            f._fail(e)
                        raise
                    finally:
                        self._retire(L)
            finally:
                with self._lock:
                    self._launched = [
                        L for L in self._launched if not L.resolved
                    ]

    @staticmethod
    def _retire(L: _Launch) -> None:
        L.resolved = True
        for f in L.futs:
            f.launch = None
            f.steps = None
            f.graph = None
        L.futs = []
        L.handle = None
        L.host = None

    def _resolve_launch(self, launch: _Launch, host) -> None:
        if launch.kind == "bitset":
            self._resolve_bitset(launch, host)
        elif launch.kind == "stream":
            self._resolve_stream(launch, host)
        elif launch.kind == "segmented":
            self._resolve_segmented(launch, host)
        elif launch.kind == "graph":
            self._resolve_graph(launch, host)
        else:
            self._resolve_vmap(launch, host)

    def _resolve_stream(self, launch: _Launch, host) -> None:
        """Hand each stream rider its raw fast-tier verdict and its
        NEXT frontier, the device row fr_out[i] of the stacked launch.
        The train's wait has already passed the event recorded after
        the launch, so the row is written. No escalation here: a
        provisional death is the StreamingCheck's to re-run."""
        fr_out, n_real = launch.handle[1][0], launch.handle[1][-1]
        verdicts = bs._out_to_verdicts(np.asarray(host[0]))[:n_real]
        for i, (f, v) in enumerate(zip(launch.futs, verdicts)):
            if not f.done():
                alive, taint, died = v
                f._resolve((alive, taint, died, fr_out[i]))

    def _resolve_graph(self, launch: _Launch, host) -> None:
        """Slice the stacked per-graph count arrays back out to each
        rider: future i gets (g1c, g_single, g2), each [B_i]."""
        off = 0
        for f, b in zip(launch.futs, launch.meta["sizes"]):
            if not f.done():
                f._resolve(tuple(np.asarray(a[off:off + b]) for a in host))
            off += b

    def _finish(self, fut: CheckFuture, out: dict) -> None:
        """Deliver a device-side verdict, running the racer crosscheck
        first, and record a durable check's verdict in its sink."""
        if fut.racer is not None:
            _race_crosscheck(fut.racer, out["valid?"])
            fut.racer = None
        if fut.checkpoint is not None and "checkpoint" not in out:
            self._checkpoint_finish(fut, out)
        fut._resolve(out)

    def _checkpoint_replay(self, fut, steps, name, S, segs) -> bool:
        """Bind a durable single-segment check to its sink at prep and
        replay a finished verdict with ZERO launches (kind "done"). The
        content hash is the one the sequential checkpointed scan
        computes, so replay and resume interchange between the plane
        and the checker. True when the future resolved here."""
        from jepsen_tpu_torch.checker import checkpoint as _cp

        sink = fut.checkpoint
        state = sink.begin(_cp.steps_content_hash(steps, name, S, segs),
                           segs, name, S)
        v = state.get("verdict")
        if v is None:
            return False
        fr = sink.death_frontier_array()
        if fr is not None:
            steps._death_frontier = fr
        out = _bitset_verdict(fut.events, steps, bool(v["alive"]),
                              int(v["died"]), fut.model)
        out["checkpoint"] = sink.summary()
        fut.kind = "done"
        fut._resolve(out)
        return True

    def _checkpoint_finish(self, fut: CheckFuture, out: dict) -> None:
        """Record a durable coalesced check's verdict in its sink (its
        begin() ran at prep), so a re-run replays it. A sink that never
        began (a stream outside the bitset envelope) has nothing to
        record. A failed save leaves the verdict as it is."""
        sink = fut.checkpoint
        if getattr(sink, "_state", None) is None:
            return
        try:
            fr = None
            if out.get("valid?") is False and fut.steps is not None:
                fr = getattr(fut.steps, "_death_frontier", None)
            sink.finish(
                alive=bool(out.get("valid?")),
                taint=False,
                died=int(out.get("failed_op_index", -1)),
                death_frontier=fr,
            )
            out["checkpoint"] = sink.summary()
        except Exception:  # noqa: BLE001 - the verdict is delivered anyway
            _log.exception("checkpoint finish failed; verdict delivered")

    def _sequential_recheck(self, fut: CheckFuture) -> dict:
        """Full sequential re-check for a request whose batched verdict
        needs the solo path's artifacts (death reports) or tiers
        (K-ladder escalation). Rare by construction. A durable future
        hands its sink through, so the definite verdict (and its death
        frontier) lands in the checkpoint."""
        return check_events_bucketed(
            fut.events, model=fut.kernel_model, race=False,
            device=self.device, checkpoint=fut.checkpoint,
        )

    def _resolve_bitset(self, launch: _Launch, host) -> None:
        verdicts = bs.collect_keys_bitset(launch.handle, out_host=host[0])
        for f, v in zip(launch.futs, verdicts):
            if f.done():
                continue  # the native racer already won
            if not f.wrap:
                f._resolve(v)
                continue
            alive, taint, died = v
            if taint or not alive:
                # Death/taint: the solo path supplies the definite
                # verdict and the failure report (decode_frontier needs
                # the per-stream death frontier the stacked launch does
                # not keep). Deaths are rare; reports are worth it.
                self._finish(f, self._sequential_recheck(f))
                continue
            self._finish(f, {
                "valid?": True,
                "method": "gpu-wgl-bitset-batch",
                "frontier_k": None,
                "escalations": 0,
            })

    def _resolve_segmented(self, launch: _Launch, host) -> None:
        fut = launch.futs[0]
        if fut.done():
            return
        alive, taint, died = bs.collect_steps_bitset_segmented(
            fut.steps, launch.handle, outs_host=host
        )
        if taint:  # impossible by construction; the ladder decides
            self._finish(fut, self._sequential_recheck(fut))
            return
        self._finish(fut, _bitset_verdict(fut.events, fut.steps, alive, died,
                                          fut.model))

    def _resolve_vmap(self, launch: _Launch, host) -> None:
        from jepsen_tpu_torch.checker.sharded import vmap_verdicts

        alive, overflow, died = (np.asarray(a) for a in host)
        live = [f for f in launch.futs if not f.done()]
        idx = [i for i, f in enumerate(launch.futs) if not f.done()]
        results = vmap_verdicts(
            [f.events for f in live],
            alive[idx], overflow[idx], died[idx],
            model=launch.meta["model"],
            k_ladder=launch.meta["k_ladder"],
            K=launch.meta["K"],
            method=launch.meta["method"],
            device=self.device,
        )
        for f, r in zip(live, results):
            self._finish(f, r)

    def _resolve_fallbacks(self) -> None:
        with self._lock:
            futs, self._fallbacks = self._fallbacks, []
        for f in futs:
            if f.done():
                continue
            try:
                # a durable solo inherits the plane's race (None defers
                # to eligibility: its racer cross-checks after the
                # durable verdict); a plain fallback is the oracle rung
                with on_stream(self._stream):
                    out = check_events_bucketed(
                        f.events, model=f.model,
                        race=(None if (self.race and f.checkpoint
                                       is not None) else False),
                        device=self.device, checkpoint=f.checkpoint,
                    )
            except Exception as e:  # noqa: BLE001 - delivered at result()
                f._fail(e)
            else:
                self._finish(f, out)

    # -- steps-level entry (check_keys_bitset's engine) ----------------

    def run_keys(
        self,
        steps_list,
        model: str = "cas-register",
        S: int = 8,
        exact: bool = False,
    ) -> List[tuple]:
        """The check_keys_bitset engine, routed through the plane's
        launch/collect machinery: the caller's pre-stacked batch
        dispatches as ONE launch (launch accounting unchanged), rides
        the shared launch train, and collects with the train's single
        sync. Returns raw (alive, taint, died) tuples."""
        name = model if isinstance(model, str) else model.name
        futs = []
        for st in steps_list:
            f = CheckFuture(self, None, name)
            f.kind = "bitset"
            f.steps = st
            f.wrap = False
            futs.append(f)
        _bump("requests", len(futs))
        _bump("batches")
        _bump("batched_requests", len(futs))
        with _stats_lock:
            DISPATCH_STATS["max_batch"] = max(
                DISPATCH_STATS["max_batch"], len(futs)
            )
        with on_stream(self._stream):
            handle, pf = self._dispatch_resilient(
                lambda: bs.launch_keys_bitset(
                    steps_list, model=name, S=S, exact=exact,
                    device=self.device,
                )
            )
            if handle is None:
                # Raw steps carry no events to re-decide on the host:
                # the structured PlaneFault is the resolution.
                self._oracle_resolve(futs, pf)
                return [f.result() for f in futs]
            launch = _Launch("bitset", futs)
            launch.handle = handle
            _bump_device(self._label, requests=len(futs), launches=1)
            self._register_launch(launch)
            self._collect_upto(launch)
        return [f.result() for f in futs]


#: process-wide default planes, one per device: check_keys_bitset and
#: other synchronous entry points route through them so their launches
#: join one train (and one stats surface) with any concurrent async
#: submitters on that device
_DEFAULT_PLANES: "dict[str, DispatchPlane]" = {}
_default_lock = threading.Lock()


def default_plane(device=None) -> DispatchPlane:
    """The process-wide plane of ``device`` (None: the CUDA card),
    built on first use with the default options."""
    dev = resolve_device(device)
    label = device_label(dev)
    with _default_lock:
        plane = _DEFAULT_PLANES.get(label)
        if plane is None:
            plane = _DEFAULT_PLANES[label] = DispatchPlane(device=dev)
        return plane


def drain_default_plane() -> None:
    """Collect every process-wide plane's outstanding launch train
    (no-op when none exists): a native-racer win resolves its rider
    without forcing the train's collect, so an end-of-run accounting
    snapshot could otherwise miss the train's host sync."""
    with _default_lock:
        planes = list(_DEFAULT_PLANES.values())
    for plane in planes:
        plane.drain()


def reset_default_plane() -> None:
    """Close and discard the process-wide planes (the next
    default_plane() builds a fresh one)."""
    with _default_lock:
        planes = list(_DEFAULT_PLANES.values())
        _DEFAULT_PLANES.clear()
    for plane in planes:
        plane.close()
