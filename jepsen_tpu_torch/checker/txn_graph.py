"""Transactional anomaly checking as tensor search (a port of
jepsen_tpu.checker.txn_graph on one CUDA device).

Adya's cycle anomalies (G1c, G-single, G2-item — ref: Adya's PhD thesis
§4; Elle, VLDB '20) reduce to cycle detection over the wr/ww/rw
transaction dependency graph. This module makes that detection
device-native:

  1. A host encoder (``encode_txn_graph``) lowers a list-append /
     register micro-op history into a columnar txn plane
     (``TxnGraphPlane``) — one interning pass, reusable across checks.
  2. ``extract_edges`` derives the wr/ww/rw edge classes from the plane
     with vectorized numpy (lexsort group logic, no per-op Python), the
     same inference Elle uses: version chains from the longest observed
     list per key, wr = writer-of-last-observed -> reader, ww = chain
     adjacency, rw = reader-of-prefix -> writer-of-next.
  3. Cycles never cross weakly-connected components, so components are
     packed into dense per-edge-class boolean adjacency batches
     [B, N, N] bucketed by component size (``GRAPH_BUCKETS``), and the
     device program (``graph_counts_torch``, torch ops on the stacks'
     device) finds cycles by repeated-squaring reachability
     (``R = min(R + R @ R, 1)``, ceil(log2 N) batched bfloat16
     matmuls) under per-anomaly edge-class masks:

         G1c       cycle in wr|ww          diag(closure(wr|ww)) > 0
         G-single  cycle with exactly 1 rw rw & closure(wr|ww).T
         G2-item   cycle with >= 1 rw      rw & closure(wr|ww|rw).T

  4. Adjacency batches ride ``DispatchPlane`` as the "graph" bucket
     kind — keyed by (n_txns-bucket, edge-class needs) — so concurrent
     graph checks coalesce into one launch exactly like bitset buckets.
     Components larger than the biggest bucket take a solo [1, N, N]
     launch up to ``_SOLO_MAX_N`` txns, and the host census above it.
  5. The pure-Python record fold (``fold_txn_graph``) stays as the
     parity oracle: identical edge inference, census, and witness rules,
     differential-tested against the device path.

Anomaly census counts are pair-level: G-single / G2-item count distinct
rw (reader, writer) pairs whose reversal closes a cycle (G-single pairs
are a subset of G2-item pairs). Witnesses are reconstructed on the host
only when an anomaly exists (failure analysis is rare and worth the
re-run), by canonical deterministic rules, so device and oracle verdicts
are bit-identical.

Not ported yet: the mesh arms (the batch axis sharded over devices, and
an oversize component's row-sharded closure), trace spans and knob
profiles (the knob defaults are the module constants below).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

#: dependency edge classes (Adya/Elle): wr = write-read (read-from),
#: ww = write-write (version order), rw = read-write (anti-dependency)
EDGE_CLASSES = ("wr", "ww", "rw")

#: anomaly census keys, in reporting order
ANOMALIES = ("G1c", "G-single", "G2-item")

#: component-size buckets for dense adjacency batches; components above
#: the last bucket go down the oversize path (a solo launch).
#: A ~1.5x ladder: closure FLOPs grow with N^3, so padding a size-12
#: component to N=16 costs 2.4x the matmuls of padding to N=12 —
#: denser rungs trade a few extra launches for much tighter stacks.
GRAPH_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
                 384, 512, 768, 1024)

#: per-future adjacency stack cap (elements per [B, N, N] array) — keeps
#: any one coalesced launch's memory bounded
_SUBMIT_ELEMS = 1 << 23

#: largest single-graph (oversize component) launch without a mesh
_SOLO_MAX_N = 8192

TXN_GRAPH_STATS = {
    "encodes": 0,            # histories lowered to columnar planes
    "extracts": 0,           # vectorized edge extractions
    "extract_memo_hits": 0,  # re-checks served from the plane's memo
    "graph_prog_compiles": 0,  # adjacency batch programs built
    "graph_prog_hits": 0,    # re-checks reusing a compiled program
    "edges_wr": 0,           # keyed edges extracted, per class
    "edges_ww": 0,
    "edges_rw": 0,
    "device_graphs": 0,      # adjacency matrices shipped to the device
    "matmul_rounds": 0,      # repeated-squaring iterations launched
    "oversize_components": 0,
    "row_sharded_launches": 0,
    "host_fallback_components": 0,
    "oracle_folds": 0,       # record-level parity-oracle runs
}

_stats_lock = threading.Lock()


def reset_txn_graph_stats() -> None:
    with _stats_lock:
        for k in TXN_GRAPH_STATS:
            TXN_GRAPH_STATS[k] = 0


def _note(key: str, n: int = 1) -> None:
    with _stats_lock:
        TXN_GRAPH_STATS[key] += n


def txn_graph_stats() -> dict:
    """Locked copy for snapshot readers."""
    with _stats_lock:
        return dict(TXN_GRAPH_STATS)


# -- columnar txn plane ------------------------------------------------------


@dataclass
class TxnGraphPlane:
    """Columnar view of a committed-txn micro-op history.

    One row per micro-op of an ok txn: (txn_id, op, key, ver, pos), with
    read observations flattened into (obs_ptr, obs_len) -> obs_ver.
    Versions are interned (key, value) pairs, so a version code names a
    unique (key, written-value) and ``writer[ver]`` is well-defined even
    when the same value appears under different keys."""

    n_txns: int
    op_index: np.ndarray          # int64 [T] history index per txn
    txn_id: np.ndarray            # int64 [M]
    op: np.ndarray                # int8  [M] 0=r 1=w 2=append
    key: np.ndarray               # int64 [M] key code
    ver: np.ndarray               # int64 [M] version code (-1 for reads)
    pos: np.ndarray               # int64 [M] mop position within txn
    obs_ptr: np.ndarray           # int64 [M] (-1 for writes)
    obs_len: np.ndarray           # int64 [M]
    obs_ver: np.ndarray           # int64 [L] flattened observed versions
    keys: list                    # key code -> user key
    ver_key: np.ndarray           # int64 [V] key code per version
    ver_val: list                 # version code -> written value
    append_key: np.ndarray        # bool [n_keys]
    warnings: list = field(default_factory=list)

    @property
    def n_mops(self) -> int:
        return len(self.txn_id)


def is_txn_value(v) -> bool:
    """True when v looks like a txn payload: a non-empty sequence of
    (f, k, v) micro-op triples with f in r/w/append."""
    if not isinstance(v, (list, tuple)) or not v:
        return False
    for m in v:
        if not isinstance(m, (list, tuple)) or len(m) != 3:
            return False
        if m[0] not in ("r", "w", "append"):
            return False
    return True


def encode_txn_graph(history) -> TxnGraphPlane:
    """Lower a history to the columnar txn plane (one interning pass).

    Only ok txns participate (info/fail ops are skipped — their effects
    are indeterminate and this checker does not speculate). Key mode is
    inferred: append evidence = an ``append`` mop or a list observation;
    register evidence = a ``w`` mop or a scalar observation. A key with
    both kinds of evidence is structurally suspect ("mixed-key-mode")."""
    from jepsen_tpu_torch.history.columnar import intern_key
    from jepsen_tpu_torch.history.history import History

    if not isinstance(history, History):
        history = History(list(history))

    _note("encodes")
    key_codes: dict = {}
    keys: list = []
    ver_codes: dict = {}
    ver_key: list = []
    ver_val: list = []
    app_evidence: set = set()
    reg_evidence: set = set()
    warnings: set = set()

    def kc(k):
        ik = intern_key(k)
        code = key_codes.get(ik)
        if code is None:
            code = key_codes[ik] = len(keys)
            keys.append(k)
        return code

    def vc(kcode, v):
        ik = (kcode, intern_key(v))
        code = ver_codes.get(ik)
        if code is None:
            code = ver_codes[ik] = len(ver_key)
            ver_key.append(kcode)
            ver_val.append(v)
        return code

    txn_id: list = []
    opc: list = []
    keyc: list = []
    ver: list = []
    pos: list = []
    obs_ptr: list = []
    obs_len: list = []
    obs_ver: list = []
    op_index: list = []
    t = 0
    for i, o in enumerate(history.ops):
        if o.type != "ok" or not is_txn_value(o.value):
            continue
        for j, mop in enumerate(o.value):
            f, k, v = mop[0], mop[1], mop[2]
            kcode = kc(k)
            txn_id.append(t)
            keyc.append(kcode)
            pos.append(j)
            if f == "r":
                opc.append(0)
                ver.append(-1)
                if v is None:
                    obs_ptr.append(-1)
                    obs_len.append(0)
                elif isinstance(v, (list, tuple)):
                    app_evidence.add(kcode)
                    obs_ptr.append(len(obs_ver))
                    obs_len.append(len(v))
                    for x in v:
                        obs_ver.append(vc(kcode, x))
                else:
                    reg_evidence.add(kcode)
                    obs_ptr.append(len(obs_ver))
                    obs_len.append(1)
                    obs_ver.append(vc(kcode, v))
            elif f == "w":
                reg_evidence.add(kcode)
                opc.append(1)
                ver.append(vc(kcode, v))
                obs_ptr.append(-1)
                obs_len.append(0)
            else:  # append
                app_evidence.add(kcode)
                opc.append(2)
                ver.append(vc(kcode, v))
                obs_ptr.append(-1)
                obs_len.append(0)
        op_index.append(o.index if o.index >= 0 else i)
        t += 1

    append_key = np.zeros(len(keys), bool)
    for k_ in app_evidence:
        append_key[k_] = True
    if app_evidence & reg_evidence:
        warnings.add("mixed-key-mode")

    i64 = np.int64
    return TxnGraphPlane(
        n_txns=t,
        op_index=np.asarray(op_index, i64),
        txn_id=np.asarray(txn_id, i64),
        op=np.asarray(opc, np.int8),
        key=np.asarray(keyc, i64),
        ver=np.asarray(ver, i64),
        pos=np.asarray(pos, i64),
        obs_ptr=np.asarray(obs_ptr, i64),
        obs_len=np.asarray(obs_len, i64),
        obs_ver=np.asarray(obs_ver, i64),
        keys=keys,
        ver_key=np.asarray(ver_key, i64),
        ver_val=ver_val,
        append_key=append_key,
        warnings=sorted(warnings),
    )


# -- edge extraction ---------------------------------------------------------


@dataclass
class EdgeSet:
    """Normalized keyed dependency edges: per class an int64 [E, 3]
    array of (src_txn, dst_txn, key_code) rows, deduplicated and sorted
    (np.unique row order) — the canonical graph both the device path and
    the parity oracle consume."""

    n_txns: int
    wr: np.ndarray
    ww: np.ndarray
    rw: np.ndarray
    keys: list
    op_index: np.ndarray
    warnings: list = field(default_factory=list)

    def counts(self) -> dict:
        return {"wr": len(self.wr), "ww": len(self.ww), "rw": len(self.rw)}


_E3 = np.zeros((0, 3), np.int64)


def _norm_edges(src, dst, key) -> np.ndarray:
    """Stack, drop self-edges, dedupe, sort — the canonical edge array.
    Rows are deduped/sorted via one packed-int64 unique (lexicographic
    (src, dst, key) order, same as np.unique(axis=0), without the
    void-view row sort)."""
    if len(src) == 0:
        return _E3
    a = np.stack(
        [np.asarray(src, np.int64), np.asarray(dst, np.int64),
         np.asarray(key, np.int64)], axis=1,
    )
    a = a[a[:, 0] != a[:, 1]]
    if len(a) == 0:
        return _E3
    md = int(a[:, 1].max()) + 1
    mk = int(a[:, 2].max()) + 1
    if float(int(a[:, 0].max()) + 1) * md * mk < float(1 << 62):
        packed = np.unique((a[:, 0] * md + a[:, 1]) * mk + a[:, 2])
        rest, k = np.divmod(packed, mk)
        s, d = np.divmod(rest, md)
        return np.stack([s, d, k], axis=1)
    return np.unique(a, axis=0)  # overflow-proof fallback


def _rep_starts(lens: np.ndarray) -> np.ndarray:
    """Per-element local offsets for variable-length repeat blocks:
    arange(sum) - repeat(starts, lens)."""
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(starts, lens)


def extract_edges(plane: TxnGraphPlane) -> EdgeSet:
    """Vectorized wr/ww/rw inference from the columnar plane.

    Rules (mirrored record-for-record by ``fold_edges``):
      - ext read = first mop of a (txn, key) group is a read (lexsort on
        (txn, key, pos)); reads after own writes/appends are internal.
      - append keys: the version chain is the longest ext-read-observed
        list (tie -> earliest mop); every other observation must be a
        prefix ("incompatible-prefix" otherwise). A key with zero
        observations and exactly one append gets the singleton chain
        (Elle's recoverable empty-read trick). ww = chain adjacency,
        wr = writer(last observed) -> reader, rw = reader of prefix j ->
        writer(chain[j]) (covers empty reads at j = 0).
      - register keys: wr = writer(v) -> reader(v); RMW txns (ext read
        v1 + ext write v2 on one key) give ww = writer(v1) -> txn and
        rw = every reader(v1) -> txn; a read of None on a key with
        exactly one written version gives rw = reader -> writer.
      - observed versions with no writer on append keys warn
        ("phantom-observed-version") and contribute no edge; self-edges
        are dropped everywhere."""
    memo = getattr(plane, "_edges_memo", None)
    if memo is not None:
        _note("extract_memo_hits")
        return memo
    _note("extracts")
    T = plane.n_txns
    warnings = list(plane.warnings)
    if T == 0 or plane.n_mops == 0:
        es = EdgeSet(T, _E3, _E3, _E3, plane.keys, plane.op_index,
                     warnings)
        plane._edges_memo = es
        return es

    tid, op, key = plane.txn_id, plane.op, plane.key
    ver, pos = plane.ver, plane.pos
    optr, olen, obs = plane.obs_ptr, plane.obs_len, plane.obs_ver
    nk = len(plane.keys)
    nv = len(plane.ver_key)
    app = plane.append_key

    # ext reads: first mop per (txn, key) group, if it is a read
    order = np.lexsort((pos, key, tid))
    t_s, k_s = tid[order], key[order]
    first = np.ones(len(order), bool)
    first[1:] = (t_s[1:] != t_s[:-1]) | (k_s[1:] != k_s[:-1])
    ext_r = order[first & (op[order] == 0)]

    # register ext writes: last "w" mop per (txn, key) group
    wsel = np.nonzero(op == 1)[0]
    if len(wsel):
        worder = wsel[np.lexsort((pos[wsel], key[wsel], tid[wsel]))]
        wlast = np.empty(len(worder), bool)
        wlast[-1] = True
        wlast[:-1] = (tid[worder][1:] != tid[worder][:-1]) | (
            key[worder][1:] != key[worder][:-1]
        )
        ext_w = worder[wlast]
    else:
        ext_w = wsel
    ap_sel = np.nonzero(op == 2)[0]  # every append defines a version

    # writer table: version -> defining txn (last definer in mop order)
    writer = np.full(max(nv, 1), -1, np.int64)
    for idxs in (ap_sel, ext_w):
        if len(idxs) == 0:
            continue
        vs = ver[idxs]
        pairs = np.unique(np.stack([vs, tid[idxs]], 1), axis=0)
        vu, cnt = np.unique(pairs[:, 0], return_counts=True)
        if (cnt > 1).any():
            warnings.append("duplicate-version-writer")
        writer[vs] = tid[idxs]

    wr_p: list = [(_E3[:, 0], _E3[:, 1], _E3[:, 2])]
    ww_p: list = [(_E3[:, 0], _E3[:, 1], _E3[:, 2])]
    rw_p: list = [(_E3[:, 0], _E3[:, 1], _E3[:, 2])]
    phantom = False

    # ---- append keys: version chains from the longest observed list ----
    er_app = ext_r[app[key[ext_r]]] if nk else ext_r[:0]
    chain_len = np.zeros(nk, np.int64)
    if len(er_app):
        np.maximum.at(chain_len, key[er_app], olen[er_app])
    rep = np.full(nk, -1, np.int64)
    if len(er_app):
        cand = er_app[olen[er_app] == chain_len[key[er_app]]]
        cand = cand[chain_len[key[cand]] > 0]
        if len(cand):
            big = np.iinfo(np.int64).max
            tmp = np.full(nk, big, np.int64)
            np.minimum.at(tmp, key[cand], cand)
            rep = np.where(tmp < big, tmp, -1)
    off = np.zeros(nk + 1, np.int64)
    np.cumsum(chain_len, out=off[1:])
    total = int(off[-1])
    if total:
        kk = np.repeat(np.arange(nk), chain_len)
        jj = np.arange(total, dtype=np.int64) - off[kk]
        chain = obs[optr[rep[kk]] + jj]
    else:
        kk = np.zeros(0, np.int64)
        chain = np.zeros(0, np.int64)

    # prefix consistency: every observation is a prefix of its chain
    if len(er_app):
        L = olen[er_app]
        if L.sum():
            rkk = np.repeat(key[er_app], L)
            base = np.repeat(optr[er_app], L)
            loc = _rep_starts(L)
            if (obs[base + loc] != chain[off[rkk] + loc]).any():
                warnings.append("incompatible-prefix")

    # single-append extension: unobserved keys with exactly one append
    one = np.full(nk, -1, np.int64)
    if len(ap_sel):
        av = np.unique(ver[ap_sel])
        apk = np.bincount(plane.ver_key[av], minlength=nk)
        singles = (chain_len == 0) & (apk[:nk] == 1) & app
        tmp = np.full(nk, -1, np.int64)
        tmp[plane.ver_key[av]] = av
        one = np.where(singles, tmp, -1)

    if total:
        # ww: chain adjacency within a key
        adj = np.nonzero(kk[:-1] == kk[1:])[0] if total > 1 else np.zeros(
            0, np.int64)
        s = writer[chain[adj]]
        d = writer[chain[adj + 1]]
        okm = (s >= 0) & (d >= 0)
        phantom = phantom or bool((~okm).any())
        ww_p.append((s[okm], d[okm], kk[adj][okm]))
        # wr: writer(last observed) -> reader
        rr = er_app[olen[er_app] > 0]
        last = obs[optr[rr] + olen[rr] - 1]
        s = writer[last]
        okm = s >= 0
        phantom = phantom or bool((~okm).any())
        wr_p.append((s[okm], tid[rr][okm], key[rr][okm]))
        # rw: reader of prefix j -> writer(chain[j])
        rr = er_app[olen[er_app] < chain_len[key[er_app]]]
        nxt = chain[off[key[rr]] + olen[rr]]
        d = writer[nxt]
        okm = d >= 0
        phantom = phantom or bool((~okm).any())
        rw_p.append((tid[rr][okm], d[okm], key[rr][okm]))
    if (one >= 0).any():
        # rw: empty reads against the single unobserved append
        rr = er_app[(olen[er_app] == 0) & (one[key[er_app]] >= 0)]
        if len(rr):
            rw_p.append((tid[rr], writer[one[key[rr]]], key[rr]))

    # ---- register keys -------------------------------------------------
    er_reg = ext_r[~app[key[ext_r]]] if nk else ext_r[:0]
    rd1 = er_reg[olen[er_reg] == 1]  # reads that observed a value
    if len(rd1):
        rv = obs[optr[rd1]]
        okm = writer[rv] >= 0
        wr_p.append((writer[rv[okm]], tid[rd1][okm], key[rd1][okm]))
    if len(rd1) and len(ext_w):
        # RMW join on (txn, key): ext read of v1 + ext write of v2
        ca = tid[rd1] * np.int64(nk) + key[rd1]
        cb = tid[ext_w] * np.int64(nk) + key[ext_w]
        _, ia, ib = np.intersect1d(ca, cb, return_indices=True)
        v1 = obs[optr[rd1[ia]]]
        t2 = tid[ext_w[ib]]
        k2 = key[ext_w[ib]]
        okm = writer[v1] >= 0
        ww_p.append((writer[v1[okm]], t2[okm], k2[okm]))
        # rw: every reader of v1 -> the RMW txn
        va = obs[optr[rd1]]
        sidx = np.argsort(va, kind="stable")
        va_s = va[sidx]
        readers_s = tid[rd1][sidx]
        lo = np.searchsorted(va_s, v1)
        hi = np.searchsorted(va_s, v1, side="right")
        cnt = hi - lo
        if cnt.sum():
            loc = _rep_starts(cnt)
            src = readers_s[np.repeat(lo, cnt) + loc]
            rw_p.append((src, np.repeat(t2, cnt), np.repeat(k2, cnt)))
    if len(ext_w):
        # read-of-None rw on single-writer register keys
        uw = np.unique(ver[ext_w])
        per_key = np.bincount(plane.ver_key[uw], minlength=nk)
        tmp = np.full(nk, -1, np.int64)
        tmp[plane.ver_key[uw]] = uw
        one_reg = np.where(per_key[:nk] == 1, tmp, -1)
        rr = er_reg[(olen[er_reg] == 0) & (one_reg[key[er_reg]] >= 0)]
        if len(rr):
            rw_p.append((tid[rr], writer[one_reg[key[rr]]], key[rr]))

    if phantom:
        warnings.append("phantom-observed-version")

    def cat(parts):
        return _norm_edges(
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]),
        )

    es = EdgeSet(T, cat(wr_p), cat(ww_p), cat(rw_p), plane.keys,
                 plane.op_index, sorted(set(warnings)))
    _note("edges_wr", len(es.wr))
    _note("edges_ww", len(es.ww))
    _note("edges_rw", len(es.rw))
    plane._edges_memo = es
    return es


def fold_edges(history) -> EdgeSet:
    """Record-level reference-shaped edge inference: plain dicts over
    txn records, one rule at a time — the parity mirror of
    ``extract_edges`` (identical EdgeSet on identical input, including
    key/txn code assignment order)."""
    from jepsen_tpu_torch.history.columnar import intern_key
    from jepsen_tpu_torch.history.history import History

    if not isinstance(history, History):
        history = History(list(history))

    key_codes: dict = {}
    keys: list = []
    txns: list = []
    op_index: list = []

    def kc(k):
        ik = intern_key(k)
        if ik not in key_codes:
            key_codes[ik] = len(keys)
            keys.append(k)
        return key_codes[ik]

    for i, o in enumerate(history.ops):
        if o.type != "ok" or not is_txn_value(o.value):
            continue
        txns.append(o.value)
        op_index.append(o.index if o.index >= 0 else i)
    T = len(txns)

    warnings: set = set()
    app_keys: set = set()
    reg_keys: set = set()
    # per txn: ordered ext reads {key: obs}, register ext writes
    # {key: val}, appends [(key, val)...]
    ext_reads: list = []
    ext_writes: list = []
    appends: list = []
    for mops in txns:
        touched: set = set()
        er: dict = {}
        ew: dict = {}
        ap: list = []
        for f, k, v in mops:
            kcode = kc(k)
            if f == "r":
                if kcode not in touched and kcode not in er:
                    er[kcode] = v
                if isinstance(v, (list, tuple)):
                    app_keys.add(kcode)
                elif v is not None:
                    reg_keys.add(kcode)
            elif f == "w":
                reg_keys.add(kcode)
                touched.add(kcode)
                ew[kcode] = v
            else:  # append
                app_keys.add(kcode)
                touched.add(kcode)
                ap.append((kcode, v))
        ext_reads.append(er)
        ext_writes.append(ew)
        appends.append(ap)
    if app_keys & reg_keys:
        warnings.add("mixed-key-mode")

    def ik(v):
        return intern_key(v)

    # writer: (key, value) -> txn, last definer in (txn, mop) order
    writer: dict = {}
    dup = False
    for t in range(T):
        for kcode, v in appends[t]:
            kv = (kcode, ik(v))
            if kv in writer and writer[kv] != t:
                dup = True
            writer[kv] = t
    for t in range(T):
        for kcode, v in ext_writes[t].items():
            kv = (kcode, ik(v))
            if kv in writer and writer[kv] != t:
                dup = True
            writer[kv] = t
    if dup:
        warnings.add("duplicate-version-writer")

    wr: set = set()
    ww: set = set()
    rw: set = set()
    phantom = False

    def add(bag, s, d, k):
        if s != d:
            bag.add((s, d, k))

    # append keys: chains from the longest ext-read observation.
    # Observations normalize to tuples: None -> () (empty prefix),
    # scalars -> 1-tuples (only reachable on mixed-mode keys, already
    # warned) — mirroring the columnar encoder's obs_len semantics.
    def app_obs(v):
        if v is None:
            return ()
        if isinstance(v, (list, tuple)):
            return tuple(v)
        return (v,)

    chains: dict = {}
    for t in range(T):
        for kcode, v in ext_reads[t].items():
            if kcode not in app_keys:
                continue
            obs = app_obs(v)
            if len(obs) > len(chains.get(kcode, ())):
                chains[kcode] = obs
    # prefix consistency (every observation vs the chain)
    for t in range(T):
        for kcode, v in ext_reads[t].items():
            if kcode not in app_keys:
                continue
            obs = app_obs(v)
            ch = chains.get(kcode, ())
            if [ik(x) for x in obs] != [ik(x) for x in ch[: len(obs)]]:
                warnings.add("incompatible-prefix")
    # single-append extension: an unobserved key with exactly one
    # distinct appended value gets the singleton chain (Elle's
    # recoverable empty-read trick); the generic rules below then emit
    # exactly the rw edges the columnar path emits for it.
    app_counts: dict = {}
    app_one: dict = {}
    for t in range(T):
        for kcode, v in appends[t]:
            app_counts.setdefault(kcode, set()).add(ik(v))
            app_one[kcode] = v
    for kcode, seen in app_counts.items():
        if len(chains.get(kcode, ())) == 0 and len(seen) == 1:
            chains[kcode] = (app_one[kcode],)

    def w_of(kcode, v):
        return writer.get((kcode, ik(v)), -1)

    for kcode, ch in chains.items():
        for a, b in zip(ch, ch[1:]):
            s, d = w_of(kcode, a), w_of(kcode, b)
            if s < 0 or d < 0:
                phantom = True
                continue
            add(ww, s, d, kcode)
    for t in range(T):
        for kcode, v in ext_reads[t].items():
            if kcode not in app_keys:
                continue
            obs = app_obs(v)
            ch = chains.get(kcode, ())
            if len(obs):
                s = w_of(kcode, obs[-1])
                if s < 0:
                    phantom = True
                else:
                    add(wr, s, t, kcode)
            if len(obs) < len(ch):
                d = w_of(kcode, ch[len(obs)])
                if d < 0:
                    phantom = True
                else:
                    add(rw, t, d, kcode)

    # register keys
    readers: dict = {}
    for t in range(T):
        for kcode, v in ext_reads[t].items():
            if kcode in app_keys or v is None or isinstance(v, (list, tuple)):
                continue
            s = w_of(kcode, v)
            if s >= 0:
                add(wr, s, t, kcode)
            readers.setdefault((kcode, ik(v)), []).append(t)
    for t in range(T):
        for kcode, v2 in ext_writes[t].items():
            v1 = ext_reads[t].get(kcode)
            if (kcode in app_keys or v1 is None
                    or isinstance(v1, (list, tuple))):
                continue
            s = w_of(kcode, v1)
            if s >= 0:
                add(ww, s, t, kcode)
            for rdr in readers.get((kcode, ik(v1)), ()):
                add(rw, rdr, t, kcode)
    # read-of-None rw on single-writer register keys
    reg_vers: dict = {}
    for t in range(T):
        for kcode, v in ext_writes[t].items():
            reg_vers.setdefault(kcode, set()).add(ik(v))
    for t in range(T):
        for kcode, v in ext_reads[t].items():
            if kcode in app_keys or v is not None:
                continue
            vers = reg_vers.get(kcode, ())
            if len(vers) == 1:
                d = writer.get((kcode, next(iter(vers))), -1)
                if d >= 0:
                    add(rw, t, d, kcode)

    if phantom:
        warnings.add("phantom-observed-version")

    def arr(bag):
        if not bag:
            return _E3
        return np.asarray(sorted(bag), np.int64)

    return EdgeSet(T, arr(wr), arr(ww), arr(rw), keys,
                   np.asarray(op_index, np.int64), sorted(warnings))


# -- host census + witnesses (shared by oracle and failure path) -------------


def _pairs(*arrs) -> np.ndarray:
    """Unique (src, dst) pairs across keyed edge arrays, in
    lexicographic order (packed-int64 unique — equivalent to
    np.unique(axis=0) but one flat sort)."""
    parts = [a[:, :2] for a in arrs if len(a)]
    if not parts:
        return np.zeros((0, 2), np.int64)
    p = np.concatenate(parts)
    m = int(p[:, 1].max()) + 1
    s, d = np.divmod(np.unique(p[:, 0] * m + p[:, 1]), m)
    return np.stack([s, d], axis=1)


def _scc_ids(n: int, pairs: np.ndarray) -> List[int]:
    """Iterative Tarjan SCC over nodes 0..n-1; returns component ids
    (nodes share an id iff they share an SCC)."""
    adj: List[list] = [[] for _ in range(n)]
    for u, v in pairs:
        adj[u].append(v)
    index = [-1] * n
    low = [0] * n
    onstk = [False] * n
    stk: list = []
    comp = [-1] * n
    counter = 0
    ccount = 0
    for s in range(n):
        if index[s] != -1:
            continue
        work = [(s, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stk.append(v)
                onstk[v] = True
            advanced = False
            ws = adj[v]
            for i in range(pi, len(ws)):
                w = ws[i]
                if index[w] == -1:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if onstk[w] and index[w] < low[v]:
                    low[v] = index[w]
            if advanced:
                continue
            if low[v] == index[v]:
                while True:
                    w = stk.pop()
                    onstk[w] = False
                    comp[w] = ccount
                    if w == v:
                        break
                ccount += 1
            work.pop()
            if work:
                u, _ = work[-1]
                if low[v] < low[u]:
                    low[u] = low[v]
    return comp


def _scc_labels(n: int, pairs: np.ndarray):
    """SCC labels for nodes 0..n-1 (nodes share a label iff they share
    an SCC — only equality of labels is meaningful). scipy's C
    implementation when present, the iterative Tarjan otherwise."""
    try:
        from scipy.sparse import coo_matrix, csgraph
    except ImportError:
        return np.asarray(_scc_ids(n, pairs), np.int64)
    g = coo_matrix(
        (np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])),
        shape=(n, n),
    )
    return csgraph.connected_components(
        g, directed=True, connection="strong")[1].astype(np.int64)


def _census_py(es: EdgeSet) -> dict:
    """Host anomaly census over the normalized edge arrays — identical
    counts to the device kernel by construction (pair-level rw
    counting, closure semantics)."""
    n = es.n_txns
    wrww = _pairs(es.wr, es.ww)
    rwp = _pairs(es.rw)
    full = _pairs(es.wr, es.ww, es.rw)
    comp_full = _scc_labels(n, full) if len(full) else np.zeros(n, np.int64)
    comp1 = _scc_labels(n, wrww) if len(wrww) else np.zeros(n, np.int64)
    sizes1 = np.bincount(comp1, minlength=n)
    g1c = int((sizes1[comp1] > 1).sum()) if len(wrww) else 0
    cands = (
        rwp[comp_full[rwp[:, 0]] == comp_full[rwp[:, 1]]]
        if len(rwp) else rwp
    )
    g2 = len(cands)
    gs = 0
    if g2:
        adj1 = _adj_sorted(wrww)
        for u, v in cands:
            if _reaches(adj1, v, u):
                gs += 1
    return {"G1c": int(g1c), "G-single": int(gs), "G2-item": int(g2)}


def _reaches(adj: dict, src: int, dst: int) -> bool:
    if src == dst:
        return True
    seen = {src}
    frontier = [src]
    while frontier:
        nxt = []
        for u in frontier:
            for w in adj.get(u, ()):
                if w == dst:
                    return True
                if w not in seen:
                    seen.add(w)
                    nxt.append(w)
        frontier = nxt
    return False


def _edge_label(es: EdgeSet, u: int, v: int,
                classes: Sequence[str]) -> tuple:
    """(class, key_code) for edge (u, v) with deterministic preference:
    first class (in the given order) carrying the pair, then its
    smallest key code. Vectorized per lookup — witness cycles are a
    handful of edges, so no global label map is ever materialized."""
    for cname in classes:
        arr = getattr(es, cname)
        if not len(arr):
            continue
        m = (arr[:, 0] == u) & (arr[:, 1] == v)
        if m.any():
            return cname, int(arr[m, 2].min())
    raise KeyError((u, v))


class _AdjSorted:
    """Sorted-neighbor adjacency over an [E, 2] pair array without
    materializing per-node lists: neighbors of u are a searchsorted
    slice of the (src, dst)-lexsorted array, ascending — the same
    iteration order a sorted per-node list would give."""

    def __init__(self, pairs: np.ndarray):
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        p = pairs[order]
        self._src = p[:, 0]
        self._dst = p[:, 1]

    def get(self, u, default=()):
        lo = np.searchsorted(self._src, u, side="left")
        hi = np.searchsorted(self._src, u, side="right")
        if lo == hi:
            return default
        return self._dst[lo:hi]


def _adj_sorted(pairs: np.ndarray) -> "_AdjSorted":
    return _AdjSorted(pairs)


def _bfs_path(adj: dict, src: int, dst: int) -> Optional[list]:
    """Shortest path src -> dst (BFS, sorted neighbor order) as a node
    list, or None. Deterministic: first shortest path in sorted order."""
    if src == dst:
        return [src]
    parent = {src: None}
    frontier = [src]
    while frontier:
        nxt = []
        for u in frontier:
            for w in adj.get(u, ()):
                if w in parent:
                    continue
                parent[w] = u
                if w == dst:
                    path = [w]
                    while parent[path[-1]] is not None:
                        path.append(parent[path[-1]])
                    return path[::-1]
                nxt.append(w)
        frontier = nxt
    return None


def _steps(es: EdgeSet, cycle: list, lab_classes: Sequence[str]) -> list:
    out = []
    for u, v in zip(cycle, cycle[1:]):
        cname, k = _edge_label(es, int(u), int(v), lab_classes)
        out.append({
            "type": cname,
            "key": es.keys[k],
            "from": int(u),
            "to": int(v),
            "from_op": int(es.op_index[u]),
            "to_op": int(es.op_index[v]),
        })
    return out


def _witnesses(es: EdgeSet, need: set,
               scope: Optional[np.ndarray] = None) -> dict:
    """Reconstruct one concrete minimal cycle per requested anomaly, by
    canonical deterministic rules (lowest txn id / pair, BFS shortest
    path with sorted neighbors) — identical from the device path and
    the oracle because it only reads the shared EdgeSet.

    ``scope`` (node ids) restricts the search to the components the
    device flagged: every counted cycle lives inside a flagged weak
    component, so filtering edges to flagged endpoints preserves the
    canonical minima exactly while the host search touches a few dozen
    edges instead of the whole graph."""
    if scope is not None:
        m = np.zeros(es.n_txns, bool)
        m[scope] = True

        def _sub(a):
            return a[m[a[:, 0]] & m[a[:, 1]]] if len(a) else a

        es = EdgeSet(es.n_txns, _sub(es.wr), _sub(es.ww), _sub(es.rw),
                     es.keys, es.op_index, es.warnings)
    out: dict = {}
    n = es.n_txns
    wrww = _pairs(es.wr, es.ww)
    rwp = _pairs(es.rw)
    full = _pairs(es.wr, es.ww, es.rw)
    adj1 = _adj_sorted(wrww)
    adjf = _adj_sorted(full)
    comp_full = _scc_labels(n, full) if len(full) else np.zeros(
        n, np.int64)

    if "G1c" in need:
        comp1 = _scc_labels(n, wrww) if len(wrww) else np.zeros(
            n, np.int64)
        sizes = np.bincount(comp1, minlength=n)
        nodes = np.nonzero(sizes[comp1] > 1)[0]
        if len(nodes):
            start = int(nodes.min())
            best = None
            for w in adj1.get(start, ()):
                path = _bfs_path(adj1, w, start)
                if path is not None and (best is None or
                                         len(path) < len(best)):
                    best = [start] + path
            if best is not None:
                out["G1c"] = {
                    "cycle": [int(x) for x in best],
                    "steps": _steps(es, best, ("wr", "ww")),
                    "cycle_len": len(best) - 1,
                }

    def rw_witness(adj, classes):
        # np.unique row order IS ascending (u, v) — the canonical
        # min-pair-first scan.
        cands = (
            rwp[comp_full[rwp[:, 0]] == comp_full[rwp[:, 1]]]
            if len(rwp) else rwp
        )
        for u, v in ((int(a), int(b)) for a, b in cands):
            path = _bfs_path(adj, v, u)
            if path is None:
                continue
            cycle = [u] + path
            steps = [{
                "type": "rw",
                "key": es.keys[_edge_label(es, u, v, ("rw",))[1]],
                "from": u,
                "to": v,
                "from_op": int(es.op_index[u]),
                "to_op": int(es.op_index[v]),
            }] + _steps(es, path, classes)
            return {
                "cycle": [int(x) for x in cycle],
                "steps": steps,
                "cycle_len": len(cycle) - 1,
            }
        return None

    if "G-single" in need:
        w = rw_witness(adj1, ("wr", "ww"))
        if w is not None:
            out["G-single"] = w
    if "G2-item" in need:
        w = rw_witness(adjf, ("wr", "ww", "rw"))
        if w is not None:
            out["G2-item"] = w
    return out


def _verdict_from(es: EdgeSet, counts: dict, need: set, method: str,
                  extra: Optional[dict] = None,
                  scope: Optional[np.ndarray] = None) -> dict:
    found = {a: counts.get(a, 0) for a in ANOMALIES
             if a in need and counts.get(a, 0) > 0}
    wits = _witnesses(es, set(found), scope) if found else {}
    anomalies = {
        a: {"count": int(c), **wits.get(a, {})} for a, c in found.items()
    }
    if found:
        valid: Any = False
    elif es.warnings:
        valid = "unknown"
    else:
        valid = True
    out = {
        "valid?": valid,
        "n_txns": es.n_txns,
        "n_keys": len(es.keys),
        "edges": es.counts(),
        "census": {a: int(counts.get(a, 0)) for a in ANOMALIES
                   if a in need},
        "anomalies": anomalies,
        "warnings": list(es.warnings),
        "method": method,
    }
    if extra:
        out.update(extra)
    return out


def fold_txn_graph(history, classes: Sequence[str] = ANOMALIES) -> dict:
    """The pure-Python parity oracle: record-level edge fold + host
    census + canonical witnesses. Same verdict surface as the device
    path (modulo ``method``/device extras) on every input."""
    _note("oracle_folds")
    es = fold_edges(history)
    return _verdict_from(es, _census_py(es), set(classes),
                         method="cpu-txn-fold")


# -- device program ----------------------------------------------------------


def _n_iters(n: int) -> int:
    """Repeated-squaring rounds for closure over paths up to length n."""
    return max(1, int(math.ceil(math.log2(max(2, int(n))))))


def graph_counts_torch(wrww: torch.Tensor, allm: torch.Tensor,
                       rw: torch.Tensor, n_iters: int, need1: bool,
                       need2: bool):
    """The reference's _graph_counts_body as torch ops on the stacks'
    device: boolean reachability by repeated squaring and the three
    per-anomaly masks. wrww and allm are float32 [B, N, N], rw bool.
    Returns per-graph int32 counts (g1c, g_single, g2), each [B]; a
    class the needs leave out counts 0.

    One inner product for every N: a round is min(R + R @ R, 1) as a
    batched bfloat16 matmul (the tensor cores on the card). Entries are
    0 or 1 and only ``> 0`` is ever read; a sum of non-negative terms
    rounds to 0 only when every term is 0, so the counts are exact. The
    reference's second branch, rows packed into words for N <= 32, is
    not kept: as torch ops it was the slowest closure at every bucket
    timed (``tools/kernel_times.py --graph``, PERF.md section 6)."""
    B = int(wrww.shape[0])
    z = torch.zeros(B, dtype=torch.int32, device=wrww.device)
    rwb = rw > 0
    g1c = gs = g2 = z

    def closure(a):
        a = a.to(torch.bfloat16)
        for _ in range(n_iters):
            a = (a + torch.bmm(a, a)).clamp_max(1.0)
        return a > 0

    if need1:
        c1 = closure(wrww)
        g1c = torch.diagonal(c1, dim1=1, dim2=2).sum(-1).to(torch.int32)
        gs = (rwb & c1.transpose(1, 2)).sum((-2, -1)).to(torch.int32)
    if need2:
        c2 = closure(allm)
        g2 = (rwb & c2.transpose(1, 2)).sum((-2, -1)).to(torch.int32)
    return g1c, gs, g2


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "txn_graph's mesh arms (the batch axis sharded over devices, "
            "an oversize component's row-sharded closure) are not "
            "ported: ROADMAP queue 1 item 10"
        )


def note_graph_launch(B: int, N: int, need1: bool, need2: bool) -> None:
    """Count a graph launch's graphs and squaring rounds in
    TXN_GRAPH_STATS. Its callers count once, before their guard runs
    the launch (a guard may run it again)."""
    _note("matmul_rounds", _n_iters(N) * (int(need1) + int(need2)))
    _note("device_graphs", B)


def launch_graph_batch(wrww, allm, rw, need1: bool = True,
                       need2: bool = True, mesh=None):
    """Launch one [B, N, N] adjacency batch on the stacks' device;
    returns the device tensors (g1c, gs, g2), each [B]. Called by
    DispatchPlane._launch_graph_group under the plane's guard, and by
    _oversize_counts for a solo component; each counts the launch with
    note_graph_launch first."""
    from jepsen_tpu_torch.device import _bump_launch

    _no_mesh(mesh)
    n_iters = _n_iters(int(wrww.shape[-1]))
    out = graph_counts_torch(wrww, allm, rw, n_iters, need1, need2)
    _bump_launch("launches")
    return out


def _sub_edge_matrices(es: EdgeSet, nodes: np.ndarray,
                       labels: np.ndarray, comp: int, N: int):
    """Dense [N, N] adjacency for one component (local node order =
    ascending txn id), padded to N."""
    local = np.full(es.n_txns, -1, np.int64)
    local[nodes] = np.arange(len(nodes))
    wrww = np.zeros((N, N), np.float32)
    allm = np.zeros((N, N), np.float32)
    rwm = np.zeros((N, N), bool)
    for arr, is_rw in ((es.wr, False), (es.ww, False), (es.rw, True)):
        if not len(arr):
            continue
        m = labels[arr[:, 0]] == comp
        s, d = local[arr[m, 0]], local[arr[m, 1]]
        allm[s, d] = 1.0
        if is_rw:
            rwm[s, d] = True
        else:
            wrww[s, d] = 1.0
    return wrww, allm, rwm


def _oversize_counts(es: EdgeSet, nodes: np.ndarray, labels: np.ndarray,
                     comp: int, need1: bool, need2: bool, mesh,
                     device, guard=None) -> dict:
    """Counts for one component too large for the dense buckets: a solo
    single-graph launch on ``device`` up to _SOLO_MAX_N txns, or a host
    census restricted to the component as the last resort. ``guard``
    runs the launch and its fetch (a plane's guard: it may retry them);
    the stats count once, outside it."""
    from jepsen_tpu_torch.device import _host_get

    _no_mesh(mesh)
    _note("oversize_components")
    size = len(nodes)
    if size <= _SOLO_MAX_N:
        stacks = [torch.as_tensor(m[None], device=device)
                  for m in _sub_edge_matrices(es, nodes, labels, comp, size)]
        note_graph_launch(1, size, need1, need2)

        def launch():
            # ONE batched tuple fetch: per-element fetches would pay the
            # sync three times
            return _host_get(launch_graph_batch(*stacks, need1, need2))

        g1c, gs, g2 = (int(v[0]) for v in (guard or (lambda f: f()))(launch))
        return {"G1c": g1c, "G-single": gs, "G2-item": g2}
    # beyond any single-device placement: host census on the component
    _note("host_fallback_components")
    local = np.full(es.n_txns, -1, np.int64)
    local[nodes] = np.arange(size)

    def sub(arr):
        if not len(arr):
            return _E3
        m = labels[arr[:, 0]] == comp
        out = arr[m].copy()
        out[:, 0] = local[out[:, 0]]
        out[:, 1] = local[out[:, 1]]
        return out

    sub_es = EdgeSet(size, sub(es.wr), sub(es.ww), sub(es.rw), es.keys,
                     es.op_index[nodes], [])
    return _census_py(sub_es)


def _weak_components(n: int, pairs: np.ndarray):
    """Weakly-connected component labels — cycles never cross them, so
    each component's closure runs independently. scipy's C
    implementation when present, union-find otherwise; both number the
    components in the order of their smallest node."""
    try:
        from scipy.sparse import coo_matrix, csgraph
    except ImportError:
        return _weak_components_uf(n, pairs)
    g = coo_matrix(
        (np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])),
        shape=(n, n),
    )
    ncomp, labels = csgraph.connected_components(
        g, directed=True, connection="weak")
    return labels.astype(np.int64), int(ncomp)


def _weak_components_uf(n: int, pairs: np.ndarray):
    """_weak_components without scipy: union-find, then the roots
    renumbered by their component's smallest node (scipy's order)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for u, v in pairs:
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    if n == 0:
        return np.zeros(0, np.int64), 0
    roots = np.array([find(i) for i in range(n)], np.int64)
    _, first, inv = np.unique(roots, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv], len(first)


# -- checker -----------------------------------------------------------------


class TxnGraphChecker:
    """Device-native Adya cycle checker over txn micro-op histories.

    check() accepts a history (list/History of ops whose ok values are
    micro-op triples) or a pre-encoded ``TxnGraphPlane``. The device
    path extracts edges, decomposes into weakly-connected components,
    and rides the shared ``DispatchPlane`` "graph" bucket kind so
    concurrent checks coalesce; ``check_async`` returns a resolver for
    submit-then-hold callers. ``oracle=True`` pins the pure-Python fold.

    device: None means the CUDA card (a check raises without it); "cpu"
    runs the device program's torch ops on the CPU. A checker with a
    ``plane`` runs on the plane's device; plane=None takes
    ``dispatch.default_plane(device)``.

    Unlike the reference, which answers ANY fault from the host census,
    the resolver catches only the plane's PlaneFault, and only where the
    plane degrades (the CPU plane, or ``degrade=True``): the census then
    answers, ``degraded`` on the verdict and ``method="cpu-txn-fold"``.
    On the card's default plane the PlaneFault reaches the caller, and
    an error that is no device fault always does."""

    def __init__(
        self,
        classes: Sequence[str] = ANOMALIES,
        plane=None,
        oracle: bool = False,
        buckets: Optional[Sequence[int]] = None,
        device=None,
    ):
        if buckets is None:
            buckets = GRAPH_BUCKETS
        bad = set(classes) - set(ANOMALIES)
        if bad:
            raise ValueError(f"unknown anomaly classes: {sorted(bad)}")
        if plane is not None and device is not None:
            raise ValueError("pass a plane or a device, not both: the "
                             "checker runs on its plane's device")
        self.classes = tuple(c for c in ANOMALIES if c in set(classes))
        self.plane = plane
        self.oracle = oracle
        self.device = device
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("need at least one graph bucket size")

    # -- public --------------------------------------------------------

    def check(self, test, history, opts=None) -> dict:
        return self.check_async(test, history)()

    def check_async(self, test, history):
        """Encode + extract + submit now; return a resolver that blocks
        on the coalesced launches and builds the verdict."""
        if isinstance(history, TxnGraphPlane):
            plane, hist = history, None
        else:
            hist, plane = history, encode_txn_graph(history)

        need = set(self.classes)
        if self.oracle:
            if hist is not None:
                h = hist
                return lambda: fold_txn_graph(h, self.classes)
            es = extract_edges(plane)
            return lambda: _verdict_from(
                es, _census_py(es), need, method="cpu-txn-fold")

        dp = self.plane
        if dp is None:
            from jepsen_tpu_torch.checker import dispatch as _dp

            dp = _dp.default_plane(self.device)
        dev = dp.device
        es = extract_edges(plane)
        need1 = bool({"G1c", "G-single"} & need)
        need2 = "G2-item" in need
        zero = {a: 0 for a in ANOMALIES}

        # The adjacency batch program (component labels + packed
        # [B, N, N] stacks, parked on the device) is a pure function of
        # the plane's edges and (buckets, needs, device) — compiled once
        # and memoized on the plane. Re-checks pay only submission, the
        # device closure, and the verdict.
        key = (self.buckets, need1, need2, str(dev))
        cache = getattr(plane, "_graph_prog", None)
        prog = cache.get(key) if cache else None
        if prog is None:
            prog = self._compile_graph_prog(es, need1, need2, dev)
            if cache is None:
                cache = {}
                plane._graph_prog = cache
            cache[key] = prog
            _note("graph_prog_compiles")
        else:
            _note("graph_prog_hits")

        if prog["empty"]:
            return lambda: _verdict_from(es, zero, need,
                                         method="gpu-txn-graph",
                                         extra=prog["extra"])

        futs = [
            (dp.submit_graph(wrww, allm, rwm, (need1, need2)), chunk)
            for wrww, allm, rwm, chunk in prog["payloads"]
        ]
        extra = prog["extra"]
        labels = prog["labels"]
        sizes = prog["sizes"]
        comp_start = prog["comp_start"]
        node_order = prog["node_order"]

        def resolve() -> dict:
            from jepsen_tpu_torch.checker import chaos

            counts = dict(zero)
            flagged = []
            try:
                # every bucket this check rides dispatches now; resolved
                # from the last submitted, one wait covers the train
                dp.flush_for([f for f, _ in futs])
                for fut, chunk in reversed(futs):
                    g1c, gs, g2 = fut.result()
                    a1 = np.asarray(g1c, np.int64)
                    a2 = np.asarray(gs, np.int64)
                    a3 = np.asarray(g2, np.int64)
                    counts["G1c"] += int(a1.sum())
                    counts["G-single"] += int(a2.sum())
                    counts["G2-item"] += int(a3.sum())
                    hot = (a1 + a2 + a3) > 0
                    if hot.any():
                        flagged.append(chunk[hot])
                for comp, nodes in zip(prog["oversize"],
                                       prog["oversize_list"]):
                    # the solo launch runs under the plane's guard: a
                    # spent budget is the plane's PlaneFault
                    sub = _oversize_counts(
                        es, nodes, labels, int(comp), need1, need2, None,
                        dev, guard=lambda f: dp.guard("launch", f))
                    for a in ANOMALIES:
                        counts[a] += sub[a]
                    if any(sub[a] for a in ANOMALIES):
                        flagged.append(np.asarray([comp], np.int64))
            except chaos.PlaneFault:
                if not dp.degrade:
                    raise
                chaos.note_oracle_fallback()
                host = _census_py(es)
                return _verdict_from(es, host, need,
                                     method="cpu-txn-fold",
                                     extra={"degraded": True})
            scope = None
            if flagged:
                cs = np.concatenate(flagged)
                scope = np.sort(np.concatenate([
                    node_order[comp_start[c]:comp_start[c] + sizes[c]]
                    for c in cs.tolist()
                ]))
            return _verdict_from(es, counts, need,
                                 method="gpu-txn-graph", extra=extra,
                                 scope=scope)

        return resolve

    def _compile_graph_prog(self, es: EdgeSet, need1: bool,
                            need2: bool, device) -> dict:
        """Lower an EdgeSet to its device batch program: weak-component
        decomposition, bucket assignment, and dense adjacency stacks on
        ``device``, plus the index maps the resolver needs to turn
        per-graph counts back into node scopes."""
        all_pairs = _pairs(es.wr, es.ww, es.rw)
        extra_base = {
            "components": {"count": 0, "max_size": 0, "oversize": 0,
                           "buckets": {}},
            "matmul_rounds": 0,
        }
        if len(all_pairs) == 0:
            return {"empty": True, "extra": extra_base}

        labels, ncomp = _weak_components(es.n_txns, all_pairs)
        sizes = np.bincount(labels, minlength=ncomp)
        interesting = sizes >= 2
        bl = np.asarray(self.buckets, np.int64)
        bidx = np.searchsorted(bl, sizes)
        assigned = np.where(interesting & (bidx < len(bl)), bidx, -1)
        oversize = np.nonzero(interesting & (bidx >= len(bl)))[0]

        # node order within a component = ascending txn id
        node_order = np.argsort(labels, kind="stable")
        comp_start = np.searchsorted(labels[node_order], np.arange(ncomp))
        local = np.empty(es.n_txns, np.int64)
        local[node_order] = (
            np.arange(es.n_txns, dtype=np.int64)
            - comp_start[labels[node_order]]
        )

        edge_arrs = [(es.wr, False), (es.ww, False), (es.rw, True)]
        payloads = []
        rounds = 0
        bucket_counts: dict = {}
        for b_i, N in enumerate(self.buckets):
            comps = np.nonzero(assigned == b_i)[0]
            if not len(comps):
                continue
            bucket_counts[N] = int(len(comps))
            per_chunk = max(1, _SUBMIT_ELEMS // (N * N))
            slot = np.full(ncomp, -1, np.int64)
            slot[comps] = np.arange(len(comps))
            for c0 in range(0, len(comps), per_chunk):
                chunk = comps[c0:c0 + per_chunk]
                B = len(chunk)
                wrww = np.zeros((B, N, N), np.float32)
                allm = np.zeros((B, N, N), np.float32)
                rwm = np.zeros((B, N, N), bool)
                for arr, is_rw in edge_arrs:
                    if not len(arr):
                        continue
                    c = labels[arr[:, 0]]
                    sl = slot[c]
                    m = (sl >= c0) & (sl < c0 + B)
                    b = sl[m] - c0
                    s, d = local[arr[m, 0]], local[arr[m, 1]]
                    allm[b, s, d] = 1.0
                    if is_rw:
                        rwm[b, s, d] = True
                    else:
                        wrww[b, s, d] = 1.0
                rounds += _n_iters(N) * (int(need1) + int(need2))
                # park the stacks on the device now: re-checks of a
                # resident plane submit without a host->device copy
                payloads.append((
                    torch.as_tensor(wrww, device=device),
                    torch.as_tensor(allm, device=device),
                    torch.as_tensor(rwm, device=device),
                    chunk,
                ))
        oversize_list = [np.sort(np.nonzero(labels == c)[0]).astype(
            np.int64) for c in oversize]

        return {
            "empty": False,
            "payloads": payloads,
            "labels": labels,
            "sizes": sizes,
            "comp_start": comp_start,
            "node_order": node_order,
            "oversize": oversize,
            "oversize_list": oversize_list,
            "extra": {
                "components": {
                    "count": int(interesting.sum()),
                    "max_size": int(sizes.max()) if ncomp else 0,
                    "oversize": int(len(oversize)),
                    "buckets": bucket_counts,
                },
                "matmul_rounds": rounds,
            },
        }


def txn_graph_checker(**kw) -> TxnGraphChecker:
    return TxnGraphChecker(**kw)
