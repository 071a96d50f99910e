"""Structured request audit log for the checker daemon (a copy of
jepsen_tpu.service.audit: one format, so either package's
``read_audit_log`` reads the other's log).

One JSONL record per HTTP request the daemon answers — who asked
(tenant), what the admission layer decided (admitted / shed reason),
what the wire saw (HTTP status), and what it cost (wall seconds,
device launches attributed to the request window). The op log and the
control audit log are two of the reference's three observability
planes (SURVEY.md §5); this is the service-side control audit plane,
greppable with jq and cheap enough to leave on.

Durability follows the store's two-phase discipline, adapted to an
append stream: every record is written as ONE complete line and
fsync'd before ``record()`` returns (phase one — the bytes are on
disk before the HTTP response leaves), and size rotation swaps
``audit.jsonl`` to ``audit.jsonl.1`` via atomic ``os.replace`` plus a
directory fsync (phase two — a SIGKILL leaves the old generation or
the new one, never a half-rotated log). ``read_audit_log`` tolerates
a torn trailing line (possible only if the process dies inside a
single ``write``) by skipping it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List

from jepsen_tpu_torch.store import _fsync_dir

#: rotate once the live file crosses this many bytes (the record
#: stream is unbounded; two bounded generations keep the disk bill
#: flat while always retaining at least max_bytes of history)
DEFAULT_MAX_BYTES = 4 * 1024 * 1024


class AuditLog:
    """Size-rotated, crash-safe JSONL appender (module docstring).

    Thread-safe: handler threads call ``record()`` concurrently; a
    single lock serializes the append + rotation check so records
    never interleave mid-line and rotation never races an append.
    """

    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_BYTES,
                 fsync: bool = True):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.fsync = fsync
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")

    def record(self, *, tenant: str, path: str, admission: str,
               status: int, wall_s: float, launches: int,
               **extra) -> dict:
        """Append one request record; returns the dict written."""
        rec = {
            "ts": time.time(),
            "tenant": str(tenant),
            "path": str(path),
            "admission": str(admission),
            "status": int(status),
            "wall_s": round(float(wall_s), 6),
            "launches": int(launches),
        }
        rec.update(extra)
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            if self._f.tell() >= self.max_bytes:
                self._rotate_locked()
        return rec

    def _rotate_locked(self) -> None:
        self._f.close()
        os.replace(self.path, self.path + ".1")
        _fsync_dir(os.path.dirname(self.path))
        self._f = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    def __enter__(self) -> "AuditLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_audit_log(path: str,
                   include_rotated: bool = False) -> List[dict]:
    """Load audit records (oldest first). A torn trailing line — the
    only partial state the append discipline can leave — is skipped,
    never a parse error. ``include_rotated`` prepends the ``.1``
    generation when present."""
    paths = ([path + ".1"] if include_rotated else []) + [path]
    out: List[dict] = []
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                if not line.endswith("\n"):
                    break  # torn tail: the crash window of one write()
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out


def default_audit_path(root: str) -> str:
    """Where the daemon keeps its audit log inside a store root."""
    return os.path.join(root, ".service", "audit.jsonl")
