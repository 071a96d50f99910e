"""Incremental (streaming) linearizability checking.

The counterpart of jepsen_tpu.checker.streaming. A StreamingCheck turns
the batch checker into something that can sit behind live traffic:
``append(ops)`` extends the history, re-encodes, and launches ONLY the
unchecked tail of the step stream, chaining from the frontier bitset
the previous launches left behind (kernel A, csrc/bitset_scan.cu, from
a seeded frontier). A follower of a growing history file, or a service
route holding one handle per stream, drives it.

Two dispatch modes share one soundness story:

- **Solo (direct) mode** (``plane=None``): each append packs its tail,
  runs the segment chain itself, and pays ONE host sync for the
  verdict + boundary frontier.
- **Coalesced mode** (``plane=`` a dispatch.DispatchPlane): each
  append submits its tail to the plane's "stream" bucket, where
  concurrent streams sharing a kernel shape (model, S, W bucket,
  length bucket, tier) stack into ONE bitset launch — and the
  stream's boundary frontier stays DEVICE-RESIDENT between appends
  (row i of the stacked fr_out feeds row i of the next stacked
  launch). k concurrent streams pay ~ceil(k / MAX_BATCH) launches per
  append round instead of k, and the collect train's single wait
  covers all of them. A PlaneFault falls back to the solo chain for
  that append — degradation costs coalescing, never verdicts. The
  row was written on the plane's CUDA stream and the train's wait has
  passed it; the solo chain reads it on the caller's stream and marks
  it used there (_run_chain's device.record_use), so the allocator
  keeps it until that read is done.

Soundness rests on the same two invariants the checkpoint layer uses
(checkpoint.py module docstring), plus prefix-closure:

- A fast-tier ALIVE verdict is definite and the boundary frontier
  equals the uninterrupted chain's, so an alive prefix's frontier is a
  sound starting point for the tail.
- A fast-tier DEATH is provisional: the handle escalates to the exact
  tier STICKY and re-runs from step 0 (under-closure before a boundary
  is never repaired downstream).
- Linearizability is prefix-closed: once a prefix is invalid on the
  exact tier, no suffix can revive it — invalid verdicts are terminal.

Appending is NOT guaranteed to leave the encoded prefix byte-stable
(a late completion can reclassify an earlier invoke, a new value code
can widen the state space, a wider window can re-bucket W). Every
append therefore re-encodes and compares a sha256 of the already-
checked step rows against the one the frontier was computed under; any
mismatch invalidates back to step 0 — never a stale frontier under a
rewritten prefix. The same hash machinery makes the handle durable:
with ``path`` set, each persistence boundary (``persist_every``
verified appends — batched so the fsync amortizes) persists atomically
(store.atomic_write_text), and a new handle over the same path resumes
from the saved frontier iff the saved prefix hash still matches.

**Windowed frontier GC** (``gc_window=N``): an unbounded stream's
per-append cost is O(history) — the full re-encode and the prefix
hash both walk every op ever appended. GC seals the checked prefix at
a CLEAN boundary (no open invokes crossing it, crashed/:info included)
once it exceeds ``gc_window`` ops: sealed rows fold into a running
sha256 (the finalized prefix digest), sealed ops move to a cold
host-side archive, and subsequent appends re-encode only the retained
tail — seeded with the frozen value-code table and the window
high-water so the suffix encode reproduces the full encode's rows
byte-for-byte (events.history_to_events's seeding contract; the
min-heap slot recycler makes slot assignment stable for free). The
per-append rewrite check becomes a CHAINED hash — sha256 over the
retained rows (op indices rebased to the global frame) plus the
finalized prefix digest — so invalidation semantics are IDENTICAL: a
rewrite inside the retained tail, a new value code, or a wider window
still restarts from TRUE step 0 (the archive restores the full
history first), exactly as an un-GC'd stream would. Device + hot host
state is O(window + appends-since-last-clean-boundary); a stream with
a crashed (:info) op stops sealing at that op — the op stays
concurrent with everything after it, so no later boundary is clean.

Histories outside the bitset envelope (window overflow, non-kernel
models) run DEFERRED: appends just accumulate and result() delegates to
check_events_bucketed (the K-frontier ladder, kernel B) — identical
verdicts, no incrementality. device="cpu" runs the plain versions
incrementally, as the reference's interpret mode does.

Knobs are the constructor's arguments (the port has no knob
registry); trace spans are not ported.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.checkpoint import (
    _dec_arr,
    _enc_arr,
    _payload_sha,
)
from jepsen_tpu_torch.checker.events import (
    WindowOverflow,
    events_to_steps,
    history_to_events,
)
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.device import (
    _bump_launch,
    _host_get,
    device_label,
    resolve_device,
    upload,
)

#: bump when the persisted stream-state layout changes (v2: chained
#: prefix digest + GC base fields + global-frame checked counts)
VERSION = 2

#: streaming accounting, same lock discipline as LAUNCH_STATS:
#: appends = append() calls, tail_launches = SOLO device chains over
#: fresh tails, coalesced_tails = appends routed through the dispatch
#: plane's stream bucket (launch counts live in DISPATCH_STATS /
#: LAUNCH_STATS — k coalesced tails share one), tail_steps = step rows
#: covered either way, invalidations = prefix rewrites that forced a
#: restart from step 0, resumes = handles re-attached to a persisted
#: frontier, escalations = fast->exact restarts, deferred = appends
#: routed outside the bitset envelope, plane_fallbacks = appends that
#: fell back from the plane to the solo chain on a PlaneFault,
#: gc_seals / gc_ops_archived = windowed-GC boundary seals and the ops
#: they moved to the cold archive.
STREAM_STATS = {
    "appends": 0,
    "tail_launches": 0,
    "coalesced_tails": 0,
    "tail_steps": 0,
    "invalidations": 0,
    "resumes": 0,
    "escalations": 0,
    "deferred": 0,
    "plane_fallbacks": 0,
    "gc_seals": 0,
    "gc_ops_archived": 0,
}

_stats_lock = threading.Lock()


def _bump(key: str, n=1) -> None:
    with _stats_lock:
        STREAM_STATS[key] += n


def reset_stream_stats() -> None:
    with _stats_lock:
        for k in STREAM_STATS:
            STREAM_STATS[k] = 0


def stream_stats() -> dict:
    with _stats_lock:
        return dict(STREAM_STATS)


def _rows_bytes(steps, a: int, b: int, idx_off: int = 0) -> bytes:
    """Canonical ROW-MAJOR bytes for step rows [a, b): each row's
    columns concatenated in a fixed order, op_index rebased to the
    global frame by ``idx_off``. Row-major matters: the finalized
    prefix digest absorbs rows seal-by-seal, and a cold resume must
    reproduce it in ONE block — any partition of the same rows yields
    the same byte stream."""
    n = b - a
    if n <= 0:
        return b""
    parts = []
    for arr in (
        steps.occ[a:b], steps.f[a:b], steps.a[a:b], steps.b[a:b],
        steps.slot[a:b], steps.live[a:b], steps.crashed[a:b],
    ):
        parts.append(
            np.ascontiguousarray(arr).reshape(n, -1).view(np.uint8)
        )
    parts.append(
        np.ascontiguousarray(
            steps.op_index[a:b].astype(np.int64) + idx_off
        ).reshape(n, -1).view(np.uint8)
    )
    if steps.fresh is not None:
        parts.append(
            np.ascontiguousarray(steps.fresh[a:b])
            .reshape(n, -1).view(np.uint8)
        )
    return np.concatenate(parts, axis=1).tobytes()


def _prefix_sha(
    steps,
    n: int,
    model: str,
    S: int,
    start: int = 0,
    idx_off: int = 0,
    base_steps: int = 0,
    base_sha: str = "",
) -> str:
    """sha256 over prepped step rows [start, start+n) + the envelope
    header, optionally CHAINED onto a finalized prefix digest
    (``base_steps`` rows summarized by ``base_sha`` — the windowed-GC
    frame). The frontier a chain leaves at global row base_steps+n is
    valid for a later check exactly when this hash matches: same rows
    (op indices compared in the global frame via ``idx_off``), same W
    bucket, same state-row count, same init state, same finalized
    prefix."""
    h = hashlib.sha256()
    h.update(
        f"v{VERSION}|{model}|S{S}|W{steps.W}|"
        f"init{steps.init_state}|n{base_steps + n}|".encode()
    )
    if base_steps:
        h.update(f"base{base_steps}:{base_sha}|".encode())
    h.update(_rows_bytes(steps, start, start + n, idx_off))
    return h.hexdigest()


class StreamingCheck:
    """Incremental linearizability check over a growing history.

    append(ops) -> status dict with a PROVISIONAL "valid?" (True while
    every checked step is alive, False once dead — terminal, None while
    deferred); result() -> the full verdict dict, same shape as
    check_events_bucketed's.

    model/init_value/device: as LinearizableChecker (device=None is the
    CUDA card and raises without one; "cpu" runs the plain versions).
    path: a file
    (or directory) to persist the stream frontier into after each
    persistence boundary — a later handle over the same path resumes
    instead of re-checking the prefix (SIGKILL-safe: atomic writes
    only). plane: a dispatch.DispatchPlane routes appends through the
    coalescing "stream" bucket (module docstring); hold_s sleeps
    between submit and resolve so concurrent streams meet in one
    bucket. persist_every:
    verified appends per durable boundary (batched fsync; a crash
    between boundaries resumes from the last persisted frontier).
    gc_window: seal + archive the checked prefix past this many ops at
    clean boundaries (module docstring) — None (or 0) disables GC. A
    plane must run on the handle's device.
    """

    def __init__(
        self,
        model: str = "cas-register",
        init_value: Any = None,
        device=None,
        path: Optional[str] = None,
        plane=None,
        hold_s: float = 0.0,
        persist_every: int = 1,
        gc_window: Optional[int] = None,
    ):
        import os

        self.device = resolve_device(device)
        if plane is not None and (
            device_label(plane.device) != device_label(self.device)
        ):
            raise ValueError(
                f"the plane runs on {device_label(plane.device)}, the "
                f"stream on {device_label(self.device)}"
            )
        if path is not None and os.path.isdir(path):
            path = os.path.join(path, "stream.json")
        if path is not None:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self.model = model
        self.init_value = init_value
        self.path = path
        self.plane = plane
        self.hold_s = max(float(hold_s), 0.0)
        self.persist_every = max(int(persist_every), 1)
        self.gc_window = (
            max(int(gc_window), 1) if gc_window else None
        )
        self._ops: List[Any] = []    # retained (hot) ops, local frame
        self._events = None
        self._steps = None
        self._checked = 0          # step rows verified, LOCAL frame
        self._sha: Optional[str] = None
        self._frontier: Optional[np.ndarray] = None  # [1, S, M] host
        self._fr_dev = None        # [S, M] row of a stacked fr_out
        self._exact = False        # sticky fast->exact escalation
        self._deferred = False     # outside the bitset envelope
        self._verdict: Optional[dict] = None  # terminal (invalid)
        self._S = 0
        self._W = 0
        self._since_save = 0       # verified appends since last _save
        # -- windowed-GC frame (all zero/empty while un-GC'd) ----------
        self._archive: List[Any] = []   # sealed ops (cold, host-side)
        self._ops_base = 0         # ops sealed out of the local frame
        self._base_steps = 0       # step rows the base digest covers
        self._base_h = hashlib.sha256()  # running finalized digest
        self._seed_codes: Optional[dict] = None
        self._seed_window = 0
        # -- clean-boundary tracker (incremental, O(new ops)/append) ---
        self._open: Dict[Any, int] = {}  # process -> open invokes
        self._pinned: set = set()  # processes retired by :info
        self._n_tracked = 0        # local ops the tracker has seen
        self._clean = 0            # local op count at last clean point
        self.resumed = False
        self._saved = self._load() if path else None

    # -- persistence ---------------------------------------------------

    def _load(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                st = json.load(f)
        except (OSError, ValueError):
            return None
        try:
            ok = (
                st.get("version") == VERSION
                and st.get("model") == self.model
                and st.get("payload_sha") == _payload_sha(st)
            )
        except (TypeError, ValueError):
            ok = False
        return st if ok else None

    def _host_frontier(self) -> Optional[np.ndarray]:
        """The boundary frontier as a host [1, S, M] array. In plane
        mode the frontier lives device-side between appends; this
        fetch happens only at persistence boundaries (amortized over
        persist_every appends) and at death reporting."""
        if self._frontier is not None:
            return self._frontier
        if self._fr_dev is None:
            return None
        # not counted: the train's counted wait already covered the
        # launch that wrote this row
        return _host_get(self._fr_dev, follow_up=True)[None]

    def _save(self) -> None:
        if self.path is None:
            return
        from jepsen_tpu_torch.store import atomic_write_text

        fr = self._host_frontier()
        st = {
            "version": VERSION,
            "model": self.model,
            "S": self._S,
            "W": self._W,
            # persisted counts are GLOBAL-frame: a cold resume has the
            # full history and no GC frame yet
            "checked": self._base_steps + self._checked,
            "prefix_sha": self._sha,
            "base_steps": self._base_steps,
            "base_sha": (
                self._base_h.hexdigest() if self._base_steps else ""
            ),
            "ops_base": self._ops_base,
            "exact": self._exact,
            "frontier": _enc_arr(fr) if fr is not None else None,
        }
        st["payload_sha"] = _payload_sha(st)
        atomic_write_text(self.path, json.dumps(st))
        self._since_save = 0

    def _try_resume(self, steps, S: int) -> None:
        """Adopt a persisted frontier iff its prefix hash matches the
        CURRENT encoding of those rows (stale or torn state rejects to
        a cold run — same discipline as CheckpointSink._load). A state
        saved by a GC'd handle verifies in two parts: the finalized
        prefix digest recomputes from rows [0, base_steps) in one
        block (row-major canonical bytes), then the chained hash over
        the retained range must match."""
        st, self._saved = self._saved, None
        if not st or st.get("frontier") is None:
            return
        n = int(st.get("checked", 0))          # global rows
        base_steps = int(st.get("base_steps", 0) or 0)
        base_sha = st.get("base_sha") or ""
        if (
            n <= 0
            or n > len(steps)
            or base_steps < 0
            or base_steps > n
            or int(st.get("S", -1)) != S
            or int(st.get("W", -1)) != steps.W
        ):
            return
        if base_steps:
            h = hashlib.sha256()
            h.update(_rows_bytes(steps, 0, base_steps, 0))
            if h.hexdigest() != base_sha:
                return
            want = _prefix_sha(
                steps, n - base_steps, self.model, S,
                start=base_steps, idx_off=0,
                base_steps=base_steps, base_sha=base_sha,
            )
        else:
            want = _prefix_sha(steps, n, self.model, S)
        if st.get("prefix_sha") != want:
            return
        self._checked = n
        # re-anchor in THIS handle's (un-GC'd, global) frame
        self._sha = _prefix_sha(steps, n, self.model, S)
        self._frontier = _dec_arr(st["frontier"])
        self._fr_dev = None
        self._exact = bool(st.get("exact", False))
        # adopt the validated envelope too, or _advance's rewrite
        # guard would see a stale S/W and void the resume immediately
        self._S, self._W = S, steps.W
        self.resumed = True
        _bump("resumes")

    # -- the incremental engine ----------------------------------------

    def append(self, ops) -> dict:
        """Extend the history and check the new tail. Returns the
        provisional status (see class docstring). Invalid is terminal:
        further appends return the recorded verdict unchanged
        (linearizability is prefix-closed)."""
        _bump("appends")
        if self._verdict is not None:
            return self.status()
        n0 = len(self._ops)
        self._ops.extend(ops)
        for op in self._ops[n0:]:
            self._track(op)
        self._advance()
        return self.status()

    def _track(self, op) -> None:
        """Advance the clean-boundary tracker over one raw op. A clean
        point has NO open invokes (a crashed/:info process pins the
        boundary forever — its op stays concurrent with everything
        after it, so no later cut is clean)."""
        try:
            t = op.get("type")
            p = op.get("process")
        except (AttributeError, TypeError):
            t = p = None
        if t == "invoke":
            self._open[p] = self._open.get(p, 0) + 1
        elif t in ("ok", "fail") and p in self._open:
            c = self._open[p] - 1
            if c <= 0:
                self._open.pop(p, None)
            else:
                self._open[p] = c
        elif t == "info" and p in self._open:
            self._pinned.add(p)
        self._n_tracked += 1
        if not self._open and not self._pinned:
            self._clean = self._n_tracked

    def _retrack(self) -> None:
        """Rebuild the boundary tracker from the current local ops
        (archive restores only — O(history), rare by construction)."""
        self._open = {}
        self._pinned = set()
        self._n_tracked = 0
        self._clean = 0
        for op in self._ops:
            self._track(op)

    def status(self) -> dict:
        """The current provisional status without touching the device."""
        if self._verdict is not None:
            out = dict(self._verdict)
        else:
            out = {
                "valid?": None if self._deferred else True,
                "deferred": self._deferred,
            }
        out["n_ops"] = self._ops_base + len(self._ops)
        out["checked_steps"] = self._base_steps + self._checked
        out["exact"] = self._exact
        return out

    def _encode(self):
        """(events, steps, S) for the CURRENT retained history, or
        None when the stream is outside the bitset envelope (deferred
        mode). After a GC seal the encode covers only the retained
        tail, seeded so its rows match the full encode's suffix
        byte-for-byte (module docstring). Never deferred merely for
        running on the CPU: device="cpu" runs the plain versions."""
        from jepsen_tpu_torch.history.history import History

        try:
            ev = history_to_events(
                History(self._ops), model=self.model,
                init_value=self.init_value,
                value_codes=self._seed_codes,
                min_window=self._seed_window,
            )
        except WindowOverflow:
            return None
        self._events = ev
        m = get_model(self.model)
        plan = bs.plan(m, ev.window, len(ev.value_codes))
        if plan is None:
            return None
        bW, S = plan
        return ev, events_to_steps(ev, W=bW), S

    def _chain_sha(self, steps, n: int, start: int = 0) -> str:
        """The per-append rewrite hash in the CURRENT frame: plain
        prefix hash while un-GC'd, chained onto the finalized prefix
        digest once sealed."""
        return _prefix_sha(
            steps, n, self.model, self._S, start=start,
            idx_off=self._ops_base,
            base_steps=self._base_steps,
            base_sha=(
                self._base_h.hexdigest() if self._base_steps else ""
            ),
        )

    def _restore_archive(self) -> None:
        """Rebuild the full history in front of the retained tail and
        drop the GC frame — the exact-restart path (invalidation,
        escalation, deferral) always reasons over TRUE step 0."""
        if not self._archive and not self._ops_base:
            return
        self._ops = list(self._archive) + self._ops
        self._archive = []
        self._ops_base = 0
        self._base_steps = 0
        self._base_h = hashlib.sha256()
        self._seed_codes = None
        self._seed_window = 0
        self._events = None
        self._steps = None
        self._retrack()

    def _maybe_gc(self, steps) -> None:
        """Seal + archive the checked prefix at the last clean
        boundary once it exceeds gc_window ops (amortized: one seal
        per gc_window, not per append)."""
        if not self.gc_window:
            return
        p = self._clean
        if p < self.gc_window or p > len(self._ops):
            return
        op_index = np.asarray(steps.op_index)
        seal = int(np.searchsorted(op_index, p))
        if seal <= 0 or seal > self._checked:
            return
        # fold the sealed rows into the running finalized digest in
        # the GLOBAL frame (row-major canonical bytes — a cold resume
        # recomputes this in one block over its full encode); the
        # index offset is the PRE-seal base: ``steps`` was encoded in
        # the frame that base defines
        old_base = self._ops_base
        self._base_h.update(_rows_bytes(steps, 0, seal, old_base))
        self._base_steps += seal
        # freeze the encoder seeds: codes are append-only, the window
        # high-water keeps the W bucket (and kernel shape) stable
        self._seed_codes = dict(self._events.value_codes)
        self._seed_window = max(
            self._seed_window, int(self._events.window)
        )
        self._archive.extend(self._ops[:p])
        self._ops = self._ops[p:]
        self._ops_base += p
        self._n_tracked -= p
        self._clean -= p
        self._checked -= seal
        # the retained rows re-anchor in the NEW frame: same bytes the
        # next append's seeded suffix re-encode will produce (its
        # local op indices shift by p, so idx_off stays the PRE-seal
        # base here and becomes the new base there — both map to the
        # global frame)
        self._sha = _prefix_sha(
            steps, self._checked, self.model, self._S,
            start=seal, idx_off=old_base,
            base_steps=self._base_steps,
            base_sha=self._base_h.hexdigest(),
        )
        self._steps = None  # stale frame; next append re-encodes
        _bump("gc_seals")
        _bump("gc_ops_archived", p)

    def _advance(self, _depth: int = 0) -> None:
        if not self._ops or _depth > 4:
            return
        enc = self._encode()
        if enc is None:
            # outside the envelope: result() decides over the FULL
            # history, so the GC frame must dissolve first
            self._restore_archive()
            if not self._deferred:
                self._deferred = True
            _bump("deferred")
            return
        ev, steps, S = enc
        self._deferred = False
        if self._saved is not None and self._checked == 0 \
                and not self._ops_base:
            self._try_resume(steps, S)
        if (self._checked > 0 or self._base_steps > 0) and (
            S != self._S
            or steps.W != self._W
            or self._sha != self._chain_sha(
                steps, min(self._checked, len(steps))
            )
        ):
            # (the base_steps>0 arm matters when a seal archived the
            # WHOLE checked prefix: zero retained rows still carry a
            # frontier, and a W/S drift must void it like any rewrite)
            # The prefix we certified no longer exists in this encoding
            # (late completion, new value code, wider window): the
            # frontier is for a different stream. Restart cold — from
            # TRUE step 0 (the archive restores first), and drop the
            # sticky exact tier with it, a rewritten history has not
            # yet earned an escalation.
            _bump("invalidations")
            had_base = bool(self._ops_base)
            self._checked = 0
            self._frontier = None
            self._fr_dev = None
            self._sha = None
            self._exact = False
            if had_base:
                self._restore_archive()
                self._advance(_depth + 1)
                return
        self._steps, self._S, self._W = steps, S, steps.W
        name = self.model if isinstance(self.model, str) else self.model.name
        while self._checked < len(steps):
            if self.plane is not None:
                handled = self._advance_tail_plane(steps, S, name)
                if handled == "restart":
                    self._advance(_depth + 1)
                    return
                if handled == "stop":
                    return
                if handled:
                    continue
                # PlaneFault / artifact re-run: fall through to the
                # solo chain for this tail
            tail = bs._slice_steps(steps, self._checked, len(steps), steps.W)
            segs = bs.plan_segments(tail)
            args = bs._segment_args(tail, segs, self.device)
            _bump_launch("launches")
            _bump("tail_launches")
            _bump("tail_steps", len(tail))
            # the chain starts from the stream's frontier (a device row
            # a stacked launch left, or the host copy of the last solo
            # chain's) in whatever mask space it has: _run_chain moves
            # it into the first segment's; None is the init frontier
            fr0 = self._fr_dev
            if fr0 is not None:
                fr0 = fr0.reshape(1, S, -1)
            elif self._frontier is not None:
                fr0 = upload(self._frontier, self.device)
            outs, frs = bs._run_chain(
                args, tail, segs, name, S, self._exact, self.device,
                fr0=fr0,
            )
            # ONE host sync per append: every tail segment's verdict
            # row plus the boundary frontier in a single fetch
            got = _host_get(tuple(outs) + (frs[-1],))
            o_host, fr_last = got[:-1], got[-1]
            died_seg, died = -1, -1
            taint = False
            for gi, o in enumerate(o_host):
                alive, t, d = bs._out_to_verdicts(o)[0]
                taint = taint or t
                if not alive:
                    died_seg, died = gi, d
                    break  # first death wins; downstream is garbage
            if taint:
                # Out of the kernel's certainty envelope: stop growing
                # frontiers and let result() decide via the full
                # bucketed ladder. (Unreachable for bitset plans by
                # construction — belt and braces.)
                self._restore_archive()
                self._deferred = True
                _bump("deferred")
                return
            if died_seg >= 0:
                if not self._exact:
                    # Provisional fast death: escalate STICKY and
                    # restart the whole stream on the exact tier —
                    # from TRUE step 0 (restore the archive first).
                    _bump_launch("escalations")
                    _bump("escalations")
                    self._exact = True
                    self._checked = 0
                    self._frontier = None
                    self._fr_dev = None
                    self._sha = None
                    if self._ops_base:
                        self._restore_archive()
                        self._advance(_depth + 1)
                        return
                    continue
                self._record_death(steps, frs, died_seg, died)
                return
            self._frontier = np.asarray(fr_last)
            self._fr_dev = None
            self._checked = len(steps)
            self._sha = self._chain_sha(steps, self._checked)
        self._finish_advance(steps)

    def _advance_tail_plane(self, steps, S: int, name: str):
        """One coalesced tail round: submit the whole unchecked tail
        (uniform W — shared kernel shape is what buckets) to the
        plane's stream bucket, hold for partners, resolve. Returns
        True when the tail verified (frontier now device-resident),
        "restart" when the handle must re-encode from step 0
        (escalation with an active GC frame), "stop" when the stream
        just went deferred (taint), and False to fall back to the
        solo chain (PlaneFault, or an exact-tier death that needs the
        solo path's failure artifacts)."""
        from jepsen_tpu_torch.checker.chaos import PlaneFault

        tail = bs._slice_steps(
            steps, self._checked, len(steps), steps.W
        )
        fr = self._fr_dev
        if fr is None and self._frontier is not None:
            fr = self._frontier
        fut = self.plane.submit_stream_tail(
            tail, fr, model=name, S=S, exact=self._exact,
        )
        if self.hold_s:
            time.sleep(self.hold_s)
        _bump("coalesced_tails")
        _bump("tail_steps", len(tail))
        try:
            alive, taint, died, fr_row = fut.result()
        except PlaneFault:
            _bump("plane_fallbacks")
            return False
        if taint:
            self._restore_archive()
            self._deferred = True
            _bump("deferred")
            return "stop"
        if not alive:
            if not self._exact:
                _bump_launch("escalations")
                _bump("escalations")
                self._exact = True
                self._checked = 0
                self._frontier = None
                self._fr_dev = None
                self._sha = None
                if self._ops_base:
                    self._restore_archive()
                    return "restart"
                return True  # loop re-runs from 0 on the exact tier
            # Exact-tier death: the solo chain supplies the failure
            # artifact (decode_frontier needs the dying segment's
            # pre-filter frontier the stacked launch doesn't keep).
            return False
        self._fr_dev = fr_row
        self._frontier = None
        self._checked = len(steps)
        self._sha = self._chain_sha(steps, self._checked)
        return True

    def _finish_advance(self, steps) -> None:
        """A fully-verified append: GC behind the durable boundary,
        then persist if a batch boundary arrived."""
        self._maybe_gc(steps)
        self._since_save += 1
        if self.path is not None \
                and self._since_save >= self.persist_every:
            self._save()

    def _record_death(self, steps, frs, died_seg: int, died: int) -> None:
        """Terminal invalid verdict with the standard failure report
        (decode_frontier over the dying segment's pre-filter
        frontier). ``died`` is a LOCAL op index; the report rebases it
        to the global frame (an exact-tier death can land after a GC
        seal re-formed)."""
        from jepsen_tpu_torch.checker.linearizable import _decode_value

        # not counted: the append's counted fetch already waited for the
        # chain that wrote this frontier
        fr = _host_get(frs[died_seg], follow_up=True)[0]
        steps._death_frontier = fr
        out = {
            "valid?": False,
            "method": "gpu-wgl-bitset-streaming",
            "frontier_k": None,
            "escalations": int(self._exact),
            "failed_op_index": died + self._ops_base,
            "failure": bs.decode_frontier(
                fr, steps, died, self.model,
                decode_value=_decode_value(self._events),
            ),
        }
        self._verdict = out
        self._save()

    # -- final verdict -------------------------------------------------

    def result(self) -> dict:
        """The definite verdict over everything appended so far. For
        deferred streams this is one full check_events_bucketed run;
        for incremental streams every step is already verified and no
        device work remains."""
        if self._verdict is not None:
            out = dict(self._verdict)
        elif self._deferred or self._events is None:
            out = self._deferred_result()
        else:
            out = {
                "valid?": True,
                "method": "gpu-wgl-bitset-streaming",
                "frontier_k": None,
                "escalations": int(self._exact),
            }
        out["n_ops"] = self._ops_base + len(self._ops)
        out.setdefault("streaming", self.summary())
        if self.path is not None and self._since_save \
                and self._verdict is None:
            self._save()
        return out

    def _deferred_result(self) -> dict:
        from jepsen_tpu_torch.checker.linearizable import (
            check_events_bucketed,
        )
        from jepsen_tpu_torch.history.history import History

        self._restore_archive()
        if not self._ops:
            return {"valid?": True, "method": "empty-history",
                    "frontier_k": None, "escalations": 0}
        ev = self._events
        if ev is None:
            ev = history_to_events(
                History(self._ops), model=self.model,
                init_value=self.init_value, max_window=1 << 20,
            )
        return check_events_bucketed(ev, model=self.model,
                                     device=self.device)

    def summary(self) -> Dict[str, Any]:
        """Per-stream block for results/service responses."""
        return {
            "checked_steps": self._base_steps + self._checked,
            "exact": self._exact,
            "deferred": self._deferred,
            "resumed": self.resumed,
            "path": self.path,
            "coalesced": self.plane is not None,
            "gc_sealed_ops": self._ops_base,
            "retained_ops": len(self._ops),
        }

    def device_residency(self) -> Dict[str, int]:
        """Bytes this stream keeps DEVICE-resident between appends —
        the windowed-GC bound the bench residency block asserts: one
        [S, M] frontier row, independent of history length (the row's
        own bytes, though its view keeps the stacked fr_out of its
        launch alive until every rider of that launch moves on)."""
        fr = self._fr_dev
        n = fr.numel() * fr.element_size() if fr is not None else 0
        return {
            "frontier_bytes": n,
            "retained_ops": len(self._ops),
            "archived_ops": self._ops_base,
        }
