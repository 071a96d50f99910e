"""Persistence: run directories, history serialization, symlinks. A
copy of jepsen_tpu.store (the layout of jepsen's store.clj:
store/<name>/<start-time>/, the two-phase save, load/latest and the
current/latest symlinks), rebuilding the port's own Op, History and
independent.KV. A run directory written by either package's Store is
read by the other, file for file.

Histories serialize as JSON Lines (one op per line: append-friendly,
streamable), test maps and results as JSON. Values carry a small tag
scheme: __kv__ for independent tuples, __tuple__ for tuples, __set__
for sets and __dict__ for dicts with non-string keys.

Every write is crash-safe: serialize into a temporary file in the same
directory, fsync it, rename it over the destination, fsync the
directory; the latest/current symlinks swap through a temporary link
and a rename. A kill at any instant leaves the old state or the new
one, never a torn file. checker/checkpoint.py rides the same primitive
for mid-check segment checkpoints.
"""

from __future__ import annotations

import json
import os
import time as _time
from typing import Any, Dict, Iterable, List, Optional

from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import Op

DEFAULT_ROOT = "store"

#: single-key shapes reserved by the tag scheme: a user dict with
#: exactly one of these keys encodes via __dict__ instead
_TAGS = (
    frozenset({"__kv__"}), frozenset({"__tuple__"}),
    frozenset({"__set__"}), frozenset({"__dict__"}),
)

#: ops per write chunk of a history file
HISTORY_WRITE_CHUNK = 16_384

#: test-map slots that are protocol objects or runtime state, never
#: serialized (store.clj:167-175's nonserializable-keys)
STRIP_KEYS = (
    "client", "nemesis", "checker", "generator", "db", "os", "net",
    "remote", "history", "results", "barrier", "store",
    "_sessions", "_ip_cache",
)


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


def _decode_value(v):
    from jepsen_tpu_torch.independent import KV

    if isinstance(v, dict):
        if set(v) == {"__kv__"}:
            k, val = v["__kv__"]
            return KV(_decode_value(k), _decode_value(val))
        if set(v) == {"__tuple__"}:
            return tuple(_decode_value(x) for x in v["__tuple__"])
        if set(v) == {"__set__"}:
            return set(_decode_value(x) for x in v["__set__"])
        if set(v) == {"__dict__"}:
            return {
                _decode_value(k): _decode_value(x)
                for k, x in v["__dict__"]
            }
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
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


def op_from_json(d: dict) -> Op:
    return Op(
        type=d["type"],
        f=d.get("f"),
        value=_decode_value(d.get("value")),
        process=d.get("process"),
        time=d.get("time", -1),
        index=d.get("index", -1),
        error=d.get("error"),
        extra=_decode_value(d.get("extra") or {}),
    )


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


class Store:
    """A run-directory store rooted at `root` (default ./store)."""

    def __init__(self, root: str = DEFAULT_ROOT):
        self.root = root

    # -- paths (store.clj:125-147) ---------------------------------------

    def path(self, name: str, stamp: str) -> str:
        return os.path.join(self.root, name, stamp)

    def service_checkpoint_path(self, tenant: str, check_id: str) -> str:
        """Where a checker service persists a durable check's segment
        checkpoint, keyed by (tenant, content-derived check id). Tenant
        names come off the wire: only a safe slug is kept, so a hostile
        tenant cannot path-traverse out of the root."""
        slug = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in tenant
        ) or "default"
        return os.path.join(
            self.root, ".service", slug, check_id, "checkpoint.json"
        )

    def make_run_dir(self, test: Dict[str, Any]) -> str:
        name = test.get("name", "noname")
        start = test.get("start_time", _time.time())
        stamp = _time.strftime(
            "%Y%m%dT%H%M%S", _time.localtime(start)
        ) + f".{int(start * 1000) % 1000:03d}"
        d = self.path(name, stamp)
        os.makedirs(d, exist_ok=True)
        self._symlink(os.path.join(self.root, name, "latest"), stamp)
        self._symlink(
            os.path.join(self.root, "current"), os.path.join(name, stamp)
        )
        test["run_dir"] = d
        return d

    @staticmethod
    def _symlink(link: str, target: str) -> None:
        """Atomic swap: build a temporary symlink next to `link` and
        rename it into place, so a reader (or a crash) never sees
        `latest`/`current` missing or dangling."""
        tmp = f"{link}.tmp.{os.getpid()}"
        try:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            os.symlink(target, tmp)
            os.replace(tmp, link)
            _fsync_dir(os.path.dirname(link))
        except OSError:  # filesystems without symlink support
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- two-phase save (store.clj:367-392) -------------------------------

    def save_1(self, test: Dict[str, Any]) -> str:
        """Phase 1, before analysis: test map (stripped) + history."""
        d = test.get("run_dir") or self.make_run_dir(test)
        clean = {
            k: v for k, v in test.items()
            if k not in STRIP_KEYS and not k.startswith("_")
        }
        atomic_write_json(os.path.join(d, "test.json"), clean)
        history: Optional[History] = test.get("history")
        if history is not None:
            write_history_jsonl(
                os.path.join(d, "history.jsonl"), history.ops
            )
        return d

    def save_2(self, test: Dict[str, Any]) -> str:
        """Phase 2, after analysis: results."""
        d = test.get("run_dir") or self.make_run_dir(test)
        write_results_json(
            os.path.join(d, "results.json"), test.get("results")
        )
        return d

    # -- load (store.clj:177-300) -----------------------------------------

    def load_history(self, run_dir: str) -> History:
        ops: List[Op] = []
        with open(os.path.join(run_dir, "history.jsonl")) as f:
            for line in f:
                line = line.strip()
                if line:
                    ops.append(op_from_json(json.loads(line)))
        return History(ops, indexed=True)

    def load_test(self, run_dir: str) -> dict:
        with open(os.path.join(run_dir, "test.json")) as f:
            return _decode_value(json.load(f))

    def load_results(self, run_dir: str) -> Optional[dict]:
        p = os.path.join(run_dir, "results.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return _decode_value(json.load(f))

    def tests(self, name: Optional[str] = None) -> Dict[str, List[str]]:
        """{test-name: [stamps...]} of stored runs."""
        out: Dict[str, List[str]] = {}
        if not os.path.isdir(self.root):
            return out
        names = [name] if name else sorted(os.listdir(self.root))
        for n in names:
            d = os.path.join(self.root, n)
            if not os.path.isdir(d) or n == "current":
                continue
            stamps = sorted(
                s for s in os.listdir(d)
                if s != "latest" and os.path.isdir(os.path.join(d, s))
            )
            if stamps:
                out[n] = stamps
        return out

    def latest(self, name: Optional[str] = None) -> Optional[str]:
        """Path of the most recent run (for `name`, or overall)."""
        best = None
        for n, stamps in self.tests(name).items():
            if best is None or stamps[-1] > best[0]:
                best = (stamps[-1], n)
        if best is None:
            return None
        return self.path(best[1], best[0])


def save_run(test: Dict[str, Any], root: str = DEFAULT_ROOT) -> str:
    """Both save phases for a completed, analyzed test."""
    st = Store(root)
    st.save_1(test)
    return st.save_2(test)
