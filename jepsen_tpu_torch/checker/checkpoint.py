"""Segment checkpointing: durable mid-check state for the segmented
bitset scan. A copy of jepsen_tpu.checker.checkpoint (numpy only, no
trace layer): the file layout, the content hash and the payload hash
are the reference's byte for byte, so one checkpoint file serves both
packages (the frontier arrays are int32 [1, S, M] in both).

A long segmented check (wgl_bitset.check_steps_bitset_segmented over a
100k-op crash-accumulating history) carries exactly one piece of
irreplaceable state between segments: the frontier bitset at the last
segment boundary. Everything else (packed device args, the plan, the
verdict rows) is a deterministic function of the prepped steps. So a
checkpoint is small and cheap: (content hash, plan, index of the last
verified segment, that boundary's frontier, tier flag, final verdict) —
persisted atomically after each collected segment with store.py's
tmp + fsync + rename discipline.

Soundness rests on two invariants of the segmented scan:

- FAST tier: the frontier a checkpoint captures at a segment boundary
  is byte-identical to the one the uninterrupted chain would carry
  there (_run_chain chains the same per-segment kernels; resuming at
  segment k with the stored frontier replays the identical
  computation). A fast-tier ALIVE verdict is sound, so boundaries of
  alive segments are safe resume points.
- EXACT escalation restarts from SEGMENT 0 (the segmented scan's
  semantics: under-closure before a boundary is never repaired downstream), so a
  fast-tier death INVALIDATES every fast checkpoint — invalidate()
  durably records the escalation, and the exact pass then checkpoints
  its own frontiers (exact frontiers are fully closed, so resuming an
  exact pass from its last boundary is sound).

Staleness: the checkpoint binds to a sha256 over the prepped step
arrays + model + state rows + plan. A checkpoint whose hash does not
match the steps being checked (edited history, different model or
plan) is REJECTED and the check runs cold — never a wrong verdict from
stale state. The state payload additionally carries its own integrity
hash, so a torn or hand-tampered file also rejects to a cold run.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

#: bump when the payload layout changes — old files reject to cold runs
VERSION = 1

#: default file name inside a run dir
CHECKPOINT_FILE = "checkpoint.json"

#: checkpoint accounting, same lock discipline as LAUNCH_STATS:
#: saves = durable writes, resumes = checks re-entered past segment 0,
#: resumed_segments = segments skipped across all resumes, replays =
#: finished checkpoints answered without any launch, rejected =
#: stale/tampered checkpoints refused (cold re-run), invalidations =
#: exact-tier escalations that wiped fast checkpoints, overhead_s =
#: wall spent hashing + serializing + fsyncing (the <5% budget).
CHECKPOINT_STATS = {
    "saves": 0,
    "resumes": 0,
    "resumed_segments": 0,
    "replays": 0,
    "rejected": 0,
    "invalidations": 0,
    "handoffs": 0,
    "overhead_s": 0.0,
}

_stats_lock = threading.Lock()


def _bump(key: str, n=1) -> None:
    with _stats_lock:
        CHECKPOINT_STATS[key] += n


def reset_checkpoint_stats() -> None:
    with _stats_lock:
        for k in CHECKPOINT_STATS:
            CHECKPOINT_STATS[k] = 0.0 if k == "overhead_s" else 0


def checkpoint_stats() -> dict:
    with _stats_lock:
        return dict(CHECKPOINT_STATS)


def steps_content_hash(steps, model: str, S: int, plan) -> str:
    """sha256 binding a checkpoint to exactly one check: the prepped
    step arrays (prep is deterministic — native and numpy paths are
    byte-identical), the model + state-row count, and the segment plan
    (a different min_len re-plans, and frontiers only align at THIS
    plan's boundaries)."""
    h = hashlib.sha256()
    h.update(
        f"v{VERSION}|{model}|S{S}|W{steps.W}|"
        f"init{steps.init_state}|{list(plan)!r}|".encode()
    )
    for arr in (
        steps.occ, steps.f, steps.a, steps.b, steps.slot,
        steps.live, steps.crashed, steps.op_index,
    ):
        h.update(np.ascontiguousarray(arr).tobytes())
    if steps.fresh is not None:
        h.update(np.ascontiguousarray(steps.fresh).tobytes())
    return h.hexdigest()


def _enc_arr(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {
        "shape": list(a.shape),
        "dtype": str(a.dtype),
        "data": base64.b64encode(a.tobytes()).decode(),
    }


def _dec_arr(d: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["data"]), dtype=d["dtype"]
    ).reshape(d["shape"]).copy()


def _payload_sha(state: dict) -> str:
    body = {k: v for k, v in state.items() if k != "payload_sha"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()


class CheckpointSink:
    """Atomically persists segmented-scan state into a run dir.

    Pass one to LinearizableChecker.check(..., checkpoint=sink) or
    DispatchPlane.submit(..., checkpoint=sink); the segmented scan
    calls begin/record/invalidate/finish. All durable writes go
    through store.atomic_write_text (tmp + fsync + rename + dir
    fsync) — a SIGKILL mid-save leaves the previous checkpoint.

    seg_min_len: override the planner's min segment length for this
    checkpointed check (the plan is part of the content hash, so the
    resuming process must use the same value).

    every: persist every Nth segment boundary (1 = every segment). A
    kill loses at most every-1 verified segments.

    after_save: test hook, called as after_save(sink, state) after
    each durable write — the in-process crash nemesis raises from it
    to simulate death-after-save at a chosen boundary.

    owner: opaque location tag ("member-3") stamped into the durable
    state. Identity stays pure content hash — the owner is metadata,
    never part of validation — but a resume whose stored owner
    differs records a HAND-OFF: the check moved between processes
    (fleet member died; a survivor inherited its frontier). Surfaced
    as summary()["resumed_from_owner"] and CHECKPOINT_STATS
    ["handoffs"] — the fleet's zero-loss evidence.
    """

    def __init__(
        self,
        path: str,
        seg_min_len: Optional[int] = None,
        every: int = 1,
        after_save: Optional[Callable] = None,
        owner: Optional[str] = None,
    ):
        if os.path.isdir(path):
            path = os.path.join(path, CHECKPOINT_FILE)
        parent = os.path.dirname(path)
        if parent:
            # Callers hand us deep, not-yet-existing paths (the service
            # daemon keys sinks by tenant/check-id); the sink owns its
            # directory so the first record() cannot fail on ENOENT.
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self.seg_min_len = seg_min_len
        self.every = max(int(every), 1)
        self.after_save = after_save
        self.owner = owner
        #: filled by begin()/the scan — summary() reports them
        self.resumed_from = 0
        self.replayed = False
        self.rejected = False
        self.resumed_from_owner: Optional[str] = None
        self.segments_total = 0
        self._state: Optional[dict] = None

    # -- lifecycle (called by the segmented scan) --------------------

    def begin(self, content_hash: str, plan, model: str, S: int) -> dict:
        """Load + validate any existing checkpoint; returns the state
        dict the scan resumes from (fresh when missing/stale). The
        load cost counts toward overhead_s."""
        t0 = time.perf_counter()
        try:
            st = self._load(content_hash)
            self.segments_total = len(plan)
            if st is None:
                st = {
                    "version": VERSION,
                    "content_hash": content_hash,
                    "model": model,
                    "S": S,
                    "plan": [list(s) for s in plan],
                    "segments_done": 0,
                    "exact": False,
                    "frontier": None,
                    "verdict": None,
                    "owner": self.owner,
                }
            else:
                prev_owner = st.get("owner")
                if st.get("verdict") is not None:
                    self.replayed = True
                    _bump("replays")
                elif st.get("segments_done", 0) > 0:
                    self.resumed_from = int(st["segments_done"])
                    _bump("resumes")
                    _bump("resumed_segments", self.resumed_from)
                    if (prev_owner is not None
                            and prev_owner != self.owner):
                        # The frontier was written by a DIFFERENT
                        # process: a fleet hand-off, not a restart.
                        self.resumed_from_owner = prev_owner
                        _bump("handoffs")
                # take ownership: the next save stamps the inheritor
                st["owner"] = self.owner
            self._state = st
            return st
        finally:
            _bump("overhead_s", time.perf_counter() - t0)

    def record(
        self, segments_done: int, frontier: np.ndarray, exact: bool
    ) -> None:
        """Persist a verified segment boundary (gated by `every`; the
        final boundary before finish() need not be saved — finish()
        carries the verdict)."""
        st = self._state
        st["segments_done"] = int(segments_done)
        st["exact"] = bool(exact)
        st["frontier"] = _enc_arr(np.asarray(frontier))
        if segments_done % self.every == 0:
            self._save()

    def invalidate(self, reason: str = "") -> None:
        """Exact-tier escalation: every fast checkpoint is void
        (restart-from-segment-0 semantics). Durably records the
        escalation so a kill mid-exact-pass resumes on the exact
        tier, not back on fast."""
        _bump("invalidations")
        st = self._state
        st["segments_done"] = 0
        st["frontier"] = None
        st["exact"] = True
        st["reason"] = reason
        self._save()

    def finish(
        self,
        alive: bool,
        taint: bool,
        died: int,
        death_frontier: Optional[np.ndarray] = None,
    ) -> None:
        """Persist the final verdict: a re-run of the same check
        replays it with zero launches."""
        st = self._state
        st["verdict"] = {
            "alive": bool(alive),
            "taint": bool(taint),
            "died": int(died),
        }
        st["frontier"] = None
        if death_frontier is not None:
            st["death_frontier"] = _enc_arr(np.asarray(death_frontier))
        self._save()

    # -- persistence ---------------------------------------------------

    def _save(self) -> None:
        from jepsen_tpu_torch.store import atomic_write_text

        t0 = time.perf_counter()
        st = dict(self._state)
        st["payload_sha"] = _payload_sha(st)
        atomic_write_text(self.path, json.dumps(st))
        _bump("saves")
        _bump("overhead_s", time.perf_counter() - t0)
        if self.after_save is not None:
            self.after_save(self, st)

    def _load(self, content_hash: str) -> Optional[dict]:
        """The stored state, or None when absent/stale/tampered (the
        latter two bump `rejected` — the caller runs cold)."""
        try:
            with open(self.path) as f:
                st = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            self.rejected = True
            _bump("rejected")
            return None
        try:
            ok = (
                st.get("version") == VERSION
                and st.get("content_hash") == content_hash
                and st.get("payload_sha") == _payload_sha(st)
            )
        except (TypeError, ValueError):
            ok = False
        if not ok:
            self.rejected = True
            _bump("rejected")
            return None
        st.pop("payload_sha", None)
        return st

    # -- views ---------------------------------------------------------

    def frontier_array(self) -> Optional[np.ndarray]:
        st = self._state or {}
        fr = st.get("frontier")
        return _dec_arr(fr) if fr is not None else None

    def death_frontier_array(self) -> Optional[np.ndarray]:
        st = self._state or {}
        fr = st.get("death_frontier")
        return _dec_arr(fr) if fr is not None else None

    def summary(self) -> Dict[str, Any]:
        """Per-check checkpoint block for results/engine stats."""
        out = {
            "path": self.path,
            "segments_total": self.segments_total,
            "resumed_from_segment": self.resumed_from,
            "replayed_verdict": self.replayed,
            "rejected_stale": self.rejected,
        }
        if self.owner is not None:
            out["owner"] = self.owner
        if self.resumed_from_owner is not None:
            out["resumed_from_owner"] = self.resumed_from_owner
        return out
