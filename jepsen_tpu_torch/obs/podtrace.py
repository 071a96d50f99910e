"""Pod-wide flight recorder: per-member trace persistence and the merged
timeline (a copy of jepsen_tpu.obs.podtrace).

The flight recorder is per process: each pod member owns its own ring.
This module joins them in three steps:

1. every member persists its ring atomically to ``member-NNN.trace.json``
   in a shared run directory (``store.atomic_write_text``, so a killed
   member never leaves a torn file for the merger to trip on);
2. the clock handshake that ``pod/topology.init_pod`` runs right after
   the rendezvous records each member's ``perf_counter_ns`` anchor (one
   int64 all_gather), giving a per-member offset and a skew bound;
3. :func:`merge_pod_trace` rebases all members onto member 0's timeline
   and emits ONE Perfetto/Chrome trace with a ``process_name`` /
   ``process_sort_index`` metadata row per member, the skew bound
   disclosed as trace metadata, so collective stalls line up across
   processes with the alignment error bar stated.

The tracing env seam is a single variable, ``JEPSEN_TPU_TRACE_DIR``:
the pod launcher propagates it to members, members persist into it, and
process 0 (or the parent) merges out of it.

Everything here is stdlib-only (the store and topology imports are
deferred into function bodies), so ``jepsen_tpu_torch.obs`` stays
importable without torch.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import List, Optional

from jepsen_tpu_torch.obs.trace import TRACER

#: env seam: directory pod members persist their rings into.  Set by
#: the pod launcher (``launch_pod(..., trace_dir=...)``) or directly by
#: the operator; read by ``cli analyze`` in every pod member.
ENV_TRACE_DIR = "JEPSEN_TPU_TRACE_DIR"

#: schema tag stamped on every per-member file and the merged trace.
SCHEMA_VERSION = 1

_MEMBER_GLOB = "member-*.trace.json"


def member_trace_path(trace_dir: str, process_index: int) -> str:
    """Canonical per-member trace file path inside ``trace_dir``."""
    return os.path.join(trace_dir, "member-%03d.trace.json" % process_index)


def persist_member_trace(
    trace_dir: str,
    *,
    process_index: Optional[int] = None,
    n_hosts: Optional[int] = None,
    events: Optional[List[dict]] = None,
    clock: Optional[dict] = None,
) -> str:
    """Atomically persist this member's ring (raw ns events) to disk.

    Defaults come from the live pod topology and tracer; every field is
    overridable so tests can persist synthetic members without a pod.
    Returns the path written.
    """
    if process_index is None or n_hosts is None or clock is None:
        from jepsen_tpu_torch.pod import topology as _topology

        snap = _topology.topology_snapshot()
        if process_index is None:
            process_index = int(snap.get("process_index") or 0)
        if n_hosts is None:
            n_hosts = int(snap.get("n_hosts") or 1)
        if clock is None:
            clock = _topology.pod_clock()
    if events is None:
        events = TRACER.spans()

    from jepsen_tpu_torch import store

    payload = {
        "schema": SCHEMA_VERSION,
        "process_index": int(process_index),
        "n_hosts": int(n_hosts),
        "clock": clock,
        "events": events,
    }
    os.makedirs(trace_dir, exist_ok=True)
    path = member_trace_path(trace_dir, int(process_index))
    store.atomic_write_text(path, json.dumps(payload))
    return path


def load_member_trace(path: str) -> dict:
    """Load and shape-check one per-member trace file."""
    with open(path, "r", encoding="utf-8") as fh:
        obj = json.load(fh)
    if not isinstance(obj, dict) or "events" not in obj:
        raise ValueError("not a member trace file: %s" % path)
    if int(obj.get("schema", -1)) != SCHEMA_VERSION:
        raise ValueError(
            "member trace schema %r != %d in %s"
            % (obj.get("schema"), SCHEMA_VERSION, path)
        )
    return obj


def _member_files(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, _MEMBER_GLOB)))


def merge_pod_trace(
    trace_dir: str,
    out_path: Optional[str] = None,
    *,
    expect_members: Optional[int] = None,
    timeout_s: float = 0.0,
) -> dict:
    """Merge all per-member traces in ``trace_dir`` onto one timeline.

    Each member's raw ``perf_counter_ns`` timestamps are rebased by its
    recorded clock offset (member's anchor minus coordinator's anchor),
    then the whole trace is shifted so the earliest event sits at t=0.
    Members become Perfetto processes (pid = process_index + 1) with
    ``process_name``/``process_sort_index`` rows; threads within a
    member keep their names via ``thread_name`` rows.

    With ``expect_members`` set the merge polls (up to ``timeout_s``)
    for the files of members 0 .. expect_members-1 and raises loudly if
    they never appear — a silent partial merge would defeat the point
    of the exercise. Other member files in the directory (an earlier,
    larger pod's) are not read. Members whose clock records carry the
    handshake's ``anchors_ns`` must all carry the same ones: a file left
    by another pod run makes the merge raise.
    """
    deadline = time.monotonic() + max(0.0, timeout_s)
    if expect_members is None:
        files = _member_files(trace_dir)
    else:
        wanted = [member_trace_path(trace_dir, i)
                  for i in range(expect_members)]
        files = [f for f in wanted if os.path.exists(f)]
        while len(files) < expect_members:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "merge_pod_trace: expected %d member traces in %s, "
                    "found %d: %s"
                    % (expect_members, trace_dir, len(files),
                       [os.path.basename(f) for f in files])
                )
            time.sleep(0.05)
            files = [f for f in wanted if os.path.exists(f)]
    if not files:
        raise RuntimeError("merge_pod_trace: no member traces in %s" % trace_dir)

    members = [load_member_trace(f) for f in files]
    members.sort(key=lambda m: int(m["process_index"]))
    runs = {tuple(m["clock"]["anchors_ns"]) for m in members
            if (m.get("clock") or {}).get("anchors_ns") is not None}
    if len(runs) > 1:
        raise RuntimeError(
            "merge_pod_trace: the member traces in %s come from %d pod "
            "runs (their handshake anchors differ)" % (trace_dir, len(runs))
        )

    # Rebase each member's events into the coordinator's clock domain,
    # collecting the global t0 and the worst skew bound as we go.  No
    # span/instant emission happens in these loops (JT304): this is the
    # merger, not the hot path.
    rebased: List[dict] = []   # (pid, event) pairs flattened below
    meta_members: List[dict] = []
    skew_bound_ns = 0
    t0: Optional[int] = None
    for m in members:
        pidx = int(m["process_index"])
        clk = m.get("clock") or {}
        offset_ns = int(clk.get("offset_ns") or 0)
        member_skew = int(clk.get("skew_bound_ns") or 0)
        skew_bound_ns = max(skew_bound_ns, member_skew)
        evs = []
        for ev in m["events"]:
            ts = int(ev.get("ts", 0)) - offset_ns
            evs.append((ts, ev))
            if t0 is None or ts < t0:
                t0 = ts
        rebased.append({"pid": pidx + 1, "process_index": pidx, "events": evs})
        meta_members.append({
            "process_index": pidx,
            "offset_ns": offset_ns,
            "skew_bound_ns": member_skew,
            "events": len(evs),
        })
    if t0 is None:
        t0 = 0

    trace_events: List[dict] = []
    for member in rebased:
        pid = member["pid"]
        pidx = member["process_index"]
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "pod-member-%d" % pidx},
        })
        trace_events.append({
            "name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0,
            "args": {"sort_index": pidx},
        })
        tids: dict = {}
        for ts, ev in member["events"]:
            raw_tid = ev.get("tid", 0)
            if raw_tid not in tids:
                tids[raw_tid] = len(tids) + 1
                trace_events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tids[raw_tid],
                    "args": {"name": str(ev.get("tname", "thread-%s" % raw_tid))},
                })
            tid = tids[raw_tid]
            out = {
                "name": ev.get("name", "?"),
                "cat": ev.get("kind", "span"),
                "ph": ev.get("ph", "X"),
                "pid": pid,
                "tid": tid,
                "ts": (ts - t0) / 1e3,  # ns -> us
                "args": dict(ev.get("args") or {}),
            }
            if out["ph"] == "X":
                out["dur"] = int(ev.get("dur", 0)) / 1e3
            elif out["ph"] == "i":
                out["s"] = "t"
            trace_events.append(out)

    merged = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "metadata": {
            "schema": SCHEMA_VERSION,
            "clock_skew_bound_ns": skew_bound_ns,
            "members": meta_members,
        },
    }
    if out_path is not None:
        from jepsen_tpu_torch import store

        store.atomic_write_text(out_path, json.dumps(merged))
    return merged
