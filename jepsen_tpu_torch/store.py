"""The run-directory artifact writers the port needs: copies of
jepsen_tpu.store's write_history_jsonl, write_results_json,
atomic_write_text and atomic_write_json, with the JSON encoding they
rest on (tagged KV pairs, tuples, sets and dicts with non-string keys)
and the crash-safe write discipline: serialize into a temporary file in
the same directory, fsync it, rename it over the destination, fsync the
directory.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

from jepsen_tpu_torch.history.ops import Op

#: single-key shapes reserved by the tag scheme: a user dict with
#: exactly one of these keys encodes via __dict__ instead
_TAGS = (
    frozenset({"__kv__"}), frozenset({"__tuple__"}),
    frozenset({"__set__"}), frozenset({"__dict__"}),
)

#: ops per write chunk of a history file
HISTORY_WRITE_CHUNK = 16_384


def _fsync_dir(path: str) -> None:
    """Flush a directory entry to disk; a rename is only durable once
    its directory is. No-op where the directory cannot be opened."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: str, write) -> None:
    """Durably replace `path` with what write(file) writes."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path))


def atomic_write_text(path: str, data: str) -> None:
    """Durably replace `path` with `data` (the checkpoint and stream
    files' writer): a kill mid-write leaves the previous file."""
    _atomic_write(path, lambda f: f.write(data))


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_text(
        path, json.dumps(_encode_value(obj), indent=2, default=str)
    )


def _encode_value(v):
    from jepsen_tpu_torch.independent import KV

    if isinstance(v, KV):
        return {"__kv__": [_encode_value(v.key), _encode_value(v.value)]}
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_value(x) for x in v]}
    if isinstance(v, (set, frozenset)):
        # sort by canonical JSON so mixed-type elements do not raise
        return {
            "__set__": sorted(
                (_encode_value(x) for x in v),
                key=lambda e: json.dumps(e, sort_keys=True, default=str),
            )
        }
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v) and set(v) not in _TAGS:
            return {k: _encode_value(x) for k, x in v.items()}
        # non-string keys: JSON would stringify them, so keep pairs
        return {
            "__dict__": [
                [_encode_value(k), _encode_value(x)] for k, x in v.items()
            ]
        }
    if isinstance(v, list):
        return [_encode_value(x) for x in v]
    return v


def op_to_json(op: Op) -> dict:
    d = {
        "type": op.type,
        "f": op.f,
        "value": _encode_value(op.value),
        "process": op.process,
        "time": op.time,
        "index": op.index,
    }
    if op.error is not None:
        d["error"] = op.error
    if op.extra:
        d["extra"] = _encode_value(op.extra)
    return d


def write_history_jsonl(path: str, ops: Iterable[Op]) -> None:
    """One op per JSON line, written in HISTORY_WRITE_CHUNK batches,
    atomically."""
    def write(f):
        buf = []
        for op in ops:
            buf.append(json.dumps(op_to_json(op), default=str))
            if len(buf) >= HISTORY_WRITE_CHUNK:
                f.write("\n".join(buf) + "\n")
                buf.clear()
        if buf:
            f.write("\n".join(buf) + "\n")

    _atomic_write(path, write)


def write_results_json(path: str, results: Any) -> None:
    text = json.dumps(_encode_value(results), indent=2, default=str)
    _atomic_write(path, lambda f: f.write(text))
