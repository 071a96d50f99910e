"""Dirty-read / version-divergence checkers (galera, crate,
elasticsearch suites). A copy of jepsen_tpu.checker.divergence (numpy,
host), interning values with the port's history.columnar.intern_key.

Three related anomaly families, each a vectorized set/group reduction
over interned value codes — no per-row Python in the verdict:

- DirtyReadsChecker (galera/src/jepsen/galera/dirty_reads.clj:73-96):
  writers set EVERY row to a unique value inside one transaction;
  readers read all rows. A failed transaction's value visible to any
  reader is a dirty read; a read whose rows differ is an inconsistent
  (torn) read.
- StrongDirtyReadChecker (crate/src/jepsen/crate/dirty_read.clj:143-
  192): single-row reads during chaos plus one final strong read per
  node. dirty = read but on no strong set; lost = acked write on no
  strong set; nodes must agree (intersection == union).
- MultiVersionChecker (crate/src/jepsen/crate/version_divergence.clj:
  94-108): reads return (value, _version); a version observed with
  more than one distinct value is divergence.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from jepsen_tpu_torch.history.columnar import intern_key


class _Interner:
    def __init__(self):
        self.codes: Dict[Any, int] = {}
        self.rev: List[Any] = []

    def code(self, v) -> int:
        k = intern_key(v)
        c = self.codes.get(k)
        if c is None:
            c = len(self.rev)
            self.codes[k] = c
            self.rev.append(v)
        return c


def _as_history(history):
    from jepsen_tpu_torch.history.history import History

    if not isinstance(history, History):
        history = History(list(history))
    return history


class DirtyReadsChecker:
    """dirty-reads checker (galera dirty_reads.clj:73-96)."""

    def check(self, test, history, opts=None) -> dict:
        h = _as_history(history)
        it = _Interner()
        failed_writes = set()
        read_rows: List[tuple] = []  # (op_index, codes ndarray)
        for o in h.ops:
            if o.f == "write" and o.type == "fail" \
                    and o.value is not None:
                failed_writes.add(it.code(o.value))
            elif o.f == "read" and o.is_ok and o.value is not None:
                read_rows.append((
                    o.index,
                    np.asarray([it.code(x) for x in o.value], np.int64),
                ))
        failed = np.asarray(sorted(failed_writes), np.int64)
        dirty = []
        inconsistent = []
        for idx, codes in read_rows:
            if len(codes) and not np.all(codes == codes[0]):
                inconsistent.append({
                    "op_index": idx,
                    "values": [it.rev[c] for c in codes],
                })
            if len(failed) and np.any(np.isin(codes, failed)):
                seen = np.unique(codes[np.isin(codes, failed)])
                dirty.append({
                    "op_index": idx,
                    "failed_values": [it.rev[c] for c in seen],
                })
        return {
            # Reference parity (dirty_reads.clj:94): only dirty reads
            # fail the verdict; inconsistent (torn) reads are reported
            # but non-fatal — the workload's writers overlap, so torn
            # reads occur even under serializability when a read lands
            # between two committed full-table writes.
            "valid?": not dirty,
            "read_count": len(read_rows),
            "failed_write_count": int(failed.size),
            "dirty_reads": dirty,
            "inconsistent_reads": inconsistent,
        }


class StrongDirtyReadChecker:
    """dirty-read checker with final strong reads
    (crate dirty_read.clj:143-192)."""

    def check(self, test, history, opts=None) -> dict:
        h = _as_history(history)
        it = _Interner()
        writes, reads, strong_sets = [], [], []
        for o in h.ops:
            if not o.is_ok:
                continue
            if o.f == "write":
                writes.append(it.code(o.value))
            elif o.f == "read" and o.value is not None:
                reads.append(it.code(o.value))
            elif o.f == "strong-read" and o.value is not None:
                strong_sets.append(
                    np.unique(np.asarray(
                        [it.code(x) for x in o.value], np.int64
                    ))
                )
        writes_a = np.unique(np.asarray(writes, np.int64))
        reads_a = np.unique(np.asarray(reads, np.int64))
        if strong_sets:
            on_all = strong_sets[0]
            on_some = strong_sets[0]
            for s in strong_sets[1:]:
                on_all = np.intersect1d(on_all, s, assume_unique=True)
                on_some = np.union1d(on_some, s)
        else:
            on_all = on_some = np.asarray([], np.int64)
        dirty = np.setdiff1d(reads_a, on_some, assume_unique=True)
        lost = np.setdiff1d(writes_a, on_some, assume_unique=True)
        some_lost = np.setdiff1d(writes_a, on_all, assume_unique=True)
        not_on_all = np.setdiff1d(on_some, on_all, assume_unique=True)
        nodes_agree = bool(on_all.size == on_some.size)

        def dec(a):
            return [it.rev[c] for c in a]

        return {
            "valid?": nodes_agree and not dirty.size and not lost.size,
            "nodes-agree?": nodes_agree,
            "read-count": int(reads_a.size),
            "on-all-count": int(on_all.size),
            "on-some-count": int(on_some.size),
            "not-on-all-count": int(not_on_all.size),
            "not-on-all": dec(not_on_all),
            "dirty-count": int(dirty.size),
            "dirty": dec(dirty),
            "lost-count": int(lost.size),
            "lost": dec(lost),
            "some-lost-count": int(some_lost.size),
            "some-lost": dec(some_lost),
        }


class MultiVersionChecker:
    """multiversion-checker (crate version_divergence.clj:94-108):
    read values look like (value, version) pairs or
    {"value": v, "_version": n} maps."""

    def check(self, test, history, opts=None) -> dict:
        h = _as_history(history)
        it = _Interner()
        vers: List[int] = []
        vals: List[int] = []
        for o in h.ops:
            if not (o.is_ok and o.f == "read") or o.value is None:
                continue
            v = o.value
            if isinstance(v, dict):
                val, ver = v.get("value"), v.get("_version")
            else:
                val, ver = v[0], v[1]
            if ver is None:
                continue
            vers.append(int(ver))
            vals.append(it.code(val))
        if not vers:
            return {"valid?": True, "multis": {}}
        vers_a = np.asarray(vers, np.int64)
        vals_a = np.asarray(vals, np.int64)
        # versions whose distinct-value count exceeds 1: sort by
        # (version, value), count unique pairs per version.
        order = np.lexsort((vals_a, vers_a))
        sv, sc = vers_a[order], vals_a[order]
        new_pair = np.ones(len(sv), bool)
        new_pair[1:] = (sv[1:] != sv[:-1]) | (sc[1:] != sc[:-1])
        uniq_v = sv[new_pair]
        vcounts = np.unique(uniq_v, return_counts=True)
        bad = vcounts[0][vcounts[1] > 1]
        multis = {
            int(ver): sorted(
                {it.rev[c] for c in np.unique(sc[sv == ver])},
                key=repr,
            )
            for ver in bad
        }
        return {"valid?": not multis, "multis": multis}


def dirty_reads() -> DirtyReadsChecker:
    return DirtyReadsChecker()


def strong_dirty_read() -> StrongDirtyReadChecker:
    return StrongDirtyReadChecker()


def multiversion() -> MultiVersionChecker:
    return MultiVersionChecker()
