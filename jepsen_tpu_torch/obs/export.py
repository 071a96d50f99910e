"""Trace exporters: Chrome-trace/Perfetto JSON and a JSONL sink. A copy
of jepsen_tpu.obs.export, writing through the port's
store.atomic_write_text.

``chrome_trace`` lowers the recorder's event dicts into the Chrome
Trace Event Format (the JSON object form Perfetto's legacy importer
loads directly): complete events (``ph: "X"``) with microsecond
``ts``/``dur``, thread-scoped instants (``ph: "i", s: "t"``), and
``thread_name`` metadata so the per-thread rows read as the plane's
actual actors (dispatch-plane-prep, handler threads, the collecting
caller). ``validate_chrome_trace`` is the golden schema the tests
pin: an export that stops loading in Perfetto fails a test, not an
operator's browser.
"""

from __future__ import annotations

import json
from typing import List

#: event keys every recorder record carries (pre-stamp)
_REQUIRED = ("name", "kind", "ph", "ts")


def chrome_trace(events: List[dict], pid: int = 1) -> dict:
    """Lower recorder events (trace.spans() output) to a Chrome-trace
    JSON object. Timestamps arrive in ns from the monotonic clock and
    leave as µs floats rebased to the earliest event (Perfetto renders
    from zero; raw perf_counter origins are meaningless anyway)."""
    t0 = min((e["ts"] for e in events), default=0)
    out = []
    tids = {}
    for e in events:
        tid = e.get("tid", 0)
        if tid not in tids:
            # stable small ids keep the JSON compact and the Perfetto
            # row order deterministic
            tids[tid] = len(tids) + 1
            out.append({
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tids[tid],
                "args": {"name": e.get("tname") or f"thread-{tid}"},
            })
        rec = {
            "name": e["name"],
            "cat": e["kind"],
            "ph": e["ph"],
            "pid": pid,
            "tid": tids[tid],
            "ts": (e["ts"] - t0) / 1e3,
            "args": dict(e.get("args") or {}),
        }
        if e["ph"] == "X":
            rec["dur"] = e.get("dur", 0) / 1e3
        else:
            rec["s"] = "t"  # thread-scoped instant
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj: dict) -> List[str]:
    """The golden Chrome-trace schema check: returns a list of
    violations (empty = Perfetto-loadable). Deliberately strict about
    exactly the fields the importer needs."""
    errors: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with 'traceEvents'"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "C"):
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errors.append(f"{where}: missing name")
        for k in ("pid", "tid"):
            if not isinstance(e.get(k), int):
                errors.append(f"{where}: {k} must be an int")
        if ph == "M":
            continue
        if not isinstance(e.get("ts"), (int, float)) or e["ts"] < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            errors.append(f"{where}: complete event missing dur")
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            errors.append(f"{where}: instant missing scope s")
        if "args" in e and not isinstance(e["args"], dict):
            errors.append(f"{where}: args must be an object")
    return errors


def write_chrome_trace(path: str, events: List[dict]) -> dict:
    """Export events to ``path`` as Perfetto-loadable JSON (atomic —
    a killed analyze never leaves a torn trace). Returns the object
    written, so callers can count spans without re-reading."""
    from jepsen_tpu_torch.store import atomic_write_text

    obj = chrome_trace(events)
    atomic_write_text(path, json.dumps(obj))
    return obj


def write_jsonl(path: str, events: List[dict]) -> int:
    """One event dict per line — the grep/jq-friendly sink. Returns
    the event count written."""
    from jepsen_tpu_torch.store import atomic_write_text

    atomic_write_text(
        path,
        "".join(json.dumps(e, default=str) + "\n" for e in events),
    )
    return len(events)
