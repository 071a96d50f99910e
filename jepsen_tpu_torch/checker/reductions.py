"""Vectorized O(n) checkers: set, set-full, counter, total-queue,
unique-ids, queue — single-pass reductions over dense history columns.
A port of jepsen_tpu.checker.reductions.

The reference implements these as sequential Clojure reducers over op
maps (jepsen/src/jepsen/checker.clj:160-233 set/queue, :236-534
set-full, :570-629 total-queue, :631-676 unique-ids, :679-734 counter).
Here each becomes masked column arithmetic: boolean masks over the
columnar view's int32 columns, np.unique multiset accounting, cumulative
sums for interval bounds, and (for set-full) chunked element×read
presence matrices. The counter's bounds also run as torch ops on the
card (counter_bounds_torch), in float64, for histories of 100k ops or
more.

Every checker consumes ColumnarHistory columns (plus the record view
where payloads are collections) and returns the reference's verdict-map
shape.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from jepsen_tpu_torch.checker.core import UNKNOWN
from jepsen_tpu_torch.device import _host_get, resolve_device
from jepsen_tpu_torch.history.columnar import ColumnarHistory, intern_key
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import INVOKE, OK, Op
from jepsen_tpu_torch.utils.util import integer_interval_set_str


def _as_history(history) -> History:
    if isinstance(history, History):
        return history
    return History(history)


class _Interner:
    """Dense value<->code map keyed through intern_key (typed equality),
    shared by the multiset-style checkers."""

    def __init__(self):
        self.codes: Dict[Any, int] = {}
        self.decode: Dict[int, Any] = {}

    def code(self, v) -> int:
        k = intern_key(v)
        c = self.codes.get(k)
        if c is None:
            c = len(self.codes)
            self.codes[k] = c
            self.decode[c] = v
        return c

    def __len__(self) -> int:
        return len(self.codes)


def _dict_key(v):
    """Values become verdict-dict keys; unhashable ones key by repr."""
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


def _client_columns(h: History) -> ColumnarHistory:
    return ColumnarHistory.from_history(h)


# -- set ---------------------------------------------------------------------


class SetChecker:
    """Adds followed by a final read: every acknowledged add must be
    read; nothing unexpected may appear.
    Ref: jepsen/src/jepsen/checker.clj:182-233.
    """

    def check(self, test, history, opts=None) -> dict:
        h = _as_history(history)
        interner = _Interner()
        attempts_l: List[int] = []
        adds_l: List[int] = []
        final_read = None
        for op in h.ops:
            if op.f == "add":
                if op.is_invoke:
                    attempts_l.append(interner.code(op.value))
                elif op.is_ok:
                    adds_l.append(interner.code(op.value))
            elif op.f == "read" and op.is_ok:
                final_read = op.value
        if final_read is None:
            return {"valid?": UNKNOWN, "error": "Set was never read"}

        read_l = [interner.code(v) for v in final_read]

        attempts = np.unique(np.asarray(attempts_l, np.int64))
        adds = np.unique(np.asarray(adds_l, np.int64))
        read = np.unique(np.asarray(read_l, np.int64))

        ok = read[np.isin(read, attempts)]
        unexpected = read[~np.isin(read, attempts)]
        lost = adds[~np.isin(adds, read)]
        recovered = ok[~np.isin(ok, adds)]

        def dec(arr):
            return [interner.decode[int(c)] for c in arr]

        return {
            "valid?": len(lost) == 0 and len(unexpected) == 0,
            "attempt-count": int(attempts.size),
            "acknowledged-count": int(adds.size),
            "ok-count": int(ok.size),
            "lost-count": int(lost.size),
            "recovered-count": int(recovered.size),
            "unexpected-count": int(unexpected.size),
            "ok": integer_interval_set_str(dec(ok)),
            "lost": integer_interval_set_str(dec(lost)),
            "unexpected": integer_interval_set_str(dec(unexpected)),
            "recovered": integer_interval_set_str(dec(recovered)),
        }


# -- counter -----------------------------------------------------------------


#: history length (ops) from which the counter's bounds run on the card
_COUNTER_DEVICE_OPS = 100_000


def counter_bounds_torch(vals: torch.Tensor, inv_add: torch.Tensor,
                         ok_add: torch.Tensor, inv_pos: torch.Tensor,
                         comp_pos: torch.Tensor) -> torch.Tensor:
    """The counter's bounds in one pass on vals' device: vals [n]
    float64 deltas and reads, inv_add / ok_add [n] bool (attempted /
    acknowledged adds), inv_pos / comp_pos [m] int64 (each completed
    read's invocation and completion rows). Returns ONE stacked [4, m]
    float64 tensor (lo, hi, v, bad), so the host fetches it in one
    round trip. float64 throughout: cumulative sums of 100k+ deltas
    lose integers past 2^24 in float32."""
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    upper = torch.cumsum(torch.where(inv_add, vals, zero), 0)
    lower = torch.cumsum(torch.where(ok_add, vals, zero), 0)
    lo = lower[inv_pos]
    hi = upper[comp_pos]
    v = vals[comp_pos]
    bad = torch.isnan(v) | (v < lo) | (hi < v)
    return torch.stack([lo, hi, v, bad.to(vals.dtype)])


class CounterChecker:
    """Interval-bound counter check: each read must land between the sum
    of acknowledged increments (lower) and attempted increments (upper)
    at its invocation/completion points.
    Ref: jepsen/src/jepsen/checker.clj:679-734.

    device: None means the CUDA card (check() raises without it); "cpu"
    keeps the bounds on the host unless force_device. force_device:
    True runs counter_bounds_torch on the resolved device, False the
    numpy path; None decides by length (_COUNTER_DEVICE_OPS, on the
    card only).
    """

    def __init__(self, device=None):
        self.device = device

    def check(self, test, history, opts=None, force_device=None) -> dict:
        dev = resolve_device(self.device)
        vals, inv_add, ok_add, inv_positions, comp_pos = \
            self.bounds_inputs(history)
        # Device path: the cumulative bound construction and the bounds
        # check are one pass of torch ops on the card; the numpy path is
        # the differential anchor and the small-history default (the
        # host-device round trip outweighs the math below ~100k ops).
        use_device = force_device if force_device is not None else (
            len(vals) >= _COUNTER_DEVICE_OPS and dev.type == "cuda"
        )
        if use_device:
            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            lo_a, hi_a, v_a, bad_a = _host_get(counter_bounds_torch(
                up(np.asarray(vals, np.float64)), up(inv_add), up(ok_add),
                up(inv_positions), up(comp_pos),
            ))
            bad_a = bad_a > 0.5
        else:
            upper_cum = np.cumsum(np.where(inv_add, vals, 0))
            lower_cum = np.cumsum(np.where(ok_add, vals, 0))
            lo_a = lower_cum[inv_positions]
            hi_a = upper_cum[comp_pos]
            v_a = vals[comp_pos]
            bad_a = np.isnan(v_a) | (v_a < lo_a) | (hi_a < v_a)

        def pynum(x):
            x = float(x)
            return int(x) if x.is_integer() else x

        reads = [
            [pynum(lo), None if np.isnan(v) else pynum(v), pynum(hi)]
            for lo, v, hi in zip(lo_a, v_a, hi_a)
        ]
        errors = [r for r, bad in zip(reads, bad_a) if bad]
        return {
            "valid?": len(errors) == 0,
            "reads": reads,
            "errors": errors,
        }

    @staticmethod
    def bounds_inputs(history):
        """The host pass: (vals, inv_add, ok_add, inv_pos, comp_pos),
        the inputs of the bounds (counter_bounds_torch's, or the numpy
        path's). vals [n] are the deltas and reads, int64 where every
        payload is an int, else float64 (NaN for a garbage read);
        inv_add / ok_add [n] mark attempted / acknowledged adds;
        inv_pos / comp_pos [m] int64 are each completed read's
        invocation and completion rows."""
        h = _as_history(history).complete()
        # Drop failed invocations and :fail completions up front, as the
        # reference does (remove :fails?, remove op/fail?).
        h = h.filter(lambda o: not (o.is_fail or o.get("fails")))
        cols = _client_columns(h)
        add_c = cols.encoder.f_codes.get("add")
        read_c = cols.encoder.f_codes.get("read")

        is_invoke = cols.type == 0
        is_ok = cols.type == 1
        is_add = cols.f == (add_c if add_c is not None else -2)
        is_read = cols.f == (read_c if read_c is not None else -2)

        # num is only valid where num_ok; non-int payloads (e.g. float
        # deltas) fall back to the record view so they aren't read as 0.
        vals = cols.num.astype(np.float64)
        relevant = (is_add | is_read) & ~cols.num_ok
        # Any fallback assignment — numeric rescue OR a NaN garbage-read
        # marker — means the float copy carries information cols.num
        # doesn't; only revert to the int columns when untouched.
        if relevant.any():
            for p in np.nonzero(relevant)[0]:
                v = h.ops[p].value
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    vals[p] = v
                else:
                    vals[p] = np.nan if is_read[p] else 0.0
        else:
            vals = cols.num

        # Completed reads: invocation position -> completion position,
        # via a sorted-index join instead of a per-read dict loop.
        order = np.argsort(cols.index, kind="stable")
        sorted_idx = cols.index[order]
        inv_positions = np.nonzero(is_invoke & is_read)[0]
        pair_idx = cols.pair[inv_positions]
        where = np.searchsorted(sorted_idx, pair_idx)
        where = np.clip(where, 0, len(order) - 1)
        comp_pos = order[where]
        found = sorted_idx[where] == pair_idx
        keep = (pair_idx >= 0) & found & is_ok[comp_pos]
        return (vals, is_invoke & is_add, is_ok & is_add,
                inv_positions[keep].astype(np.int64),
                comp_pos[keep].astype(np.int64))


# -- unique ids --------------------------------------------------------------


class UniqueIdsChecker:
    """Every :generate ack must return a distinct id.
    Ref: jepsen/src/jepsen/checker.clj:631-676.
    """

    def check(self, test, history, opts=None) -> dict:
        h = _as_history(history)
        attempted = 0
        acks: List[Any] = []
        for op in h.ops:
            if op.f == "generate":
                if op.is_invoke:
                    attempted += 1
                elif op.is_ok:
                    acks.append(op.value)
        interner = _Interner()
        codes = np.asarray([interner.code(v) for v in acks], np.int64)
        uniq, counts = np.unique(codes, return_counts=True)
        dups: Dict[Any, int] = {
            _dict_key(interner.decode[int(u)]): int(c)
            for u, c in zip(uniq, counts)
            if c > 1
        }
        rng: Optional[list] = None
        if acks:
            try:
                rng = [min(acks), max(acks)]
            except TypeError:
                key = repr
                rng = [min(acks, key=key), max(acks, key=key)]
        return {
            "valid?": len(dups) == 0,
            "attempted-count": attempted,
            "acknowledged-count": len(acks),
            "duplicated-count": len(dups),
            "duplicated": dict(
                sorted(dups.items(), key=lambda kv: -kv[1])[:48]
            ),
            "range": rng,
        }


# -- queue (model-based) -----------------------------------------------------


class UnorderedQueue:
    """Multiset queue model (knossos model/unordered-queue analog):
    enqueue always ok; dequeue must match some enqueued element."""

    def __init__(self):
        self.counts: Dict[Any, int] = {}
        self.inconsistent: Optional[str] = None

    def step(self, op: Op) -> "UnorderedQueue":
        if self.inconsistent:
            return self
        if op.f == "enqueue":
            k = intern_key(op.value)
            self.counts[k] = self.counts.get(k, 0) + 1
        elif op.f == "dequeue":
            k = intern_key(op.value)
            n = self.counts.get(k, 0)
            if n <= 0:
                self.inconsistent = f"can't dequeue {op.value!r}"
            else:
                self.counts[k] = n - 1
        return self


class QueueChecker:
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue happened, only ok dequeues happened, and fold the model.
    Ref: jepsen/src/jepsen/checker.clj:160-180.
    """

    def __init__(self, model_factory=UnorderedQueue):
        self.model_factory = model_factory

    def check(self, test, history, opts=None) -> dict:
        h = _as_history(history)
        model = self.model_factory()
        for op in h.ops:
            if op.f == "enqueue" and op.is_invoke:
                model = model.step(op)
            elif op.f == "dequeue" and op.is_ok:
                model = model.step(op)
        if model.inconsistent:
            return {"valid?": False, "error": model.inconsistent}
        return {"valid?": True, "final-queue": dict(model.counts)}


# -- total queue -------------------------------------------------------------


def expand_queue_drain_ops(h: History):
    """Expand ok :drain ops (value = collection) into per-element
    :dequeue invoke/ok pairs. Returns (history, crashed_drains):
    a crashed (:info) drain may have consumed elements whose
    observations are lost — it contributes nothing, and the count lets
    the checker degrade would-be "lost" verdicts to unknown instead of
    manufacturing false data loss (real wire clients crash drains on
    transport errors after jobs were acked, protocols/clients.py).
    Ref: jepsen/src/jepsen/checker.clj:536-569."""
    out: List[Op] = []
    crashed = 0
    for op in h.ops:
        if op.f != "drain":
            out.append(op)
        elif op.is_invoke or op.is_fail:
            continue
        elif op.is_ok:
            for el in op.value or ():
                out.append(op.with_(type=INVOKE, f="dequeue", value=None))
                out.append(op.with_(type=OK, f="dequeue", value=el))
        else:  # crashed drain: indeterminate consumption
            crashed += 1
    return History(out, indexed=True), crashed


class TotalQueueChecker:
    """What goes in must come out: multiset accounting over enqueues and
    dequeues (history must drain the queue).
    Ref: jepsen/src/jepsen/checker.clj:570-629.
    """

    def check(self, test, history, opts=None) -> dict:
        h, crashed_drains = expand_queue_drain_ops(
            _as_history(history)
        )
        interner = _Interner()
        att_l, enq_l, deq_l = [], [], []
        for op in h.ops:
            if op.f == "enqueue":
                if op.is_invoke:
                    att_l.append(interner.code(op.value))
                elif op.is_ok:
                    enq_l.append(interner.code(op.value))
            elif op.f == "dequeue" and op.is_ok:
                deq_l.append(interner.code(op.value))

        n = len(interner)
        att = np.bincount(np.asarray(att_l, np.int64), minlength=n)
        enq = np.bincount(np.asarray(enq_l, np.int64), minlength=n)
        deq = np.bincount(np.asarray(deq_l, np.int64), minlength=n)
        if n == 0:
            att = enq = deq = np.zeros(0, np.int64)

        ok = np.minimum(deq, att)
        unexpected = np.where(att == 0, deq, 0)
        duplicated = np.maximum(deq - att, 0) - unexpected
        lost = np.maximum(enq - deq, 0)
        recovered = np.maximum(ok - enq, 0)

        def ms(counts) -> Dict[Any, int]:
            return {
                _dict_key(interner.decode[i]): int(c)
                for i, c in enumerate(counts)
                if c > 0
            }

        # Apparent losses with a crashed drain in play are
        # indeterminate: the elements may sit in the drain that never
        # reported (UNKNOWN, the validity lattice's middle).
        clean = int(lost.sum()) == 0 and int(unexpected.sum()) == 0
        if not clean and int(lost.sum()) > 0 and crashed_drains:
            valid = (
                False if int(unexpected.sum()) > 0 else "unknown"
            )
        else:
            valid = clean
        return {
            "valid?": valid,
            "crashed-drain-count": crashed_drains,
            "attempt-count": int(att.sum()),
            "acknowledged-count": int(enq.sum()),
            "ok-count": int(ok.sum()),
            "unexpected-count": int(unexpected.sum()),
            "duplicated-count": int(duplicated.sum()),
            "lost-count": int(lost.sum()),
            "recovered-count": int(recovered.sum()),
            "lost": ms(lost),
            "unexpected": ms(unexpected),
            "duplicated": ms(duplicated),
            "recovered": ms(recovered),
        }


# -- set-full ----------------------------------------------------------------


def _frequency_distribution(points, xs) -> Optional[dict]:
    """Quantile map at the given points (0-1).
    Ref: jepsen/src/jepsen/checker.clj:351-363."""
    xs = np.sort(np.asarray(list(xs)))
    if xs.size == 0:
        return None
    idx = np.minimum(xs.size - 1, np.floor(xs.size * np.asarray(points)).astype(int))
    return {p: int(xs[i]) for p, i in zip(points, idx)}


#: memory cap for one set-full presence block (cells = elements x reads)
_SETFULL_BLOCK_CELLS = 32_000_000


def _setfull_block_reduce(
    presence, eligible, r_inv, r_inv_t, r_comp, r_comp_t
):
    """Per-element masked reductions over one [E_blk, R] block, in
    numpy as in the reference (tests/test_torch_reductions.py holds the
    verdicts against it)."""
    NEG = np.int64(-1)
    pres = presence & eligible
    abst = ~presence & eligible
    lp_pos = np.where(
        pres.any(1), np.argmax(np.where(pres, r_inv, NEG), axis=1), -1
    )
    la_pos = np.where(
        abst.any(1), np.argmax(np.where(abst, r_inv, NEG), axis=1), -1
    )
    # Known: add-ok completion, or first observing read's completion,
    # whichever comes first in history order.
    first_obs_pos = np.where(
        pres.any(1),
        np.argmin(np.where(pres, r_comp, np.iinfo(np.int64).max), 1),
        -1,
    )
    last_present = np.where(lp_pos >= 0, r_inv[lp_pos], -1)
    last_absent = np.where(la_pos >= 0, r_inv[la_pos], -1)
    first_obs_idx = np.where(
        first_obs_pos >= 0, r_comp[first_obs_pos], -1
    )
    first_obs_time = np.where(
        first_obs_pos >= 0, r_comp_t[first_obs_pos], -1
    )
    la_inv_t = np.where(la_pos >= 0, r_inv_t[la_pos], -1)
    lp_inv_t = np.where(lp_pos >= 0, r_inv_t[lp_pos], -1)
    return (last_present, last_absent, first_obs_idx, first_obs_time,
            la_inv_t, lp_inv_t)


class SetFullChecker:
    """Per-element visibility timeline analysis: for each added element,
    infer the known/stable/lost times from which reads observed it.

    Vectorized core: element add-invocation indices [E] against read
    invocation/completion indices [R]; presence as a chunked [E, R]
    boolean matrix scattered from (element, read) observation pairs;
    last-present / last-absent / known via masked maxima and minima per
    row. Semantics per jepsen/src/jepsen/checker.clj:236-534:

    - A read only informs elements whose add *invoked* before the read
      completed (the reference tracks elements from add invocation).
    - stable: some eligible read observed it after the last miss.
    - lost: known (acked or once-observed), then missed after the last
      observation, with the miss after the known point.
    - never-read: neither; includes adds concurrent with every miss.
    - With linearizable=True, stale elements (stable-latency > 0) are
      failures too.

    The reference also tracks per-read duplicate elements; its
    multiplicity filter `(< v 1)` keeps nothing (inverted comparison),
    so duplicates are always empty there — here multiplicities > 1 are
    reported as the docstring intends.
    """

    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, history, opts=None) -> dict:
        h = _as_history(history)
        interner = _Interner()
        code = interner.code
        decode = interner.decode

        # Element records, in add-invocation order.
        add_inv_idx: List[int] = []  # history index of add invocation
        add_ok_idx: List[int] = []  # completion index or -1
        add_ok_time: List[int] = []
        el_of_code: Dict[int, int] = {}  # element code -> element row
        # Reads: (inv_index, inv_time, comp_index, comp_time, [codes])
        reads: List[tuple] = []
        open_reads: Dict[Any, Op] = {}
        dups: Dict[Any, int] = {}

        for op in h.ops:
            if not op.is_client_op:
                continue
            if op.f == "add":
                c = code(op.value)
                if op.is_invoke:
                    if c not in el_of_code:
                        el_of_code[c] = len(add_inv_idx)
                        add_inv_idx.append(op.index)
                        add_ok_idx.append(-1)
                        add_ok_time.append(-1)
                    else:
                        # Re-add of a tracked element: the reference
                        # overwrites with a fresh record (checker.clj
                        # set-full assoc), so reset the row — earlier
                        # reads become ineligible via the r_comp > a_inv
                        # gate below.
                        row = el_of_code[c]
                        add_inv_idx[row] = op.index
                        add_ok_idx[row] = -1
                        add_ok_time[row] = -1
                elif op.is_ok and c in el_of_code:
                    row = el_of_code[c]
                    if add_ok_idx[row] < 0:
                        add_ok_idx[row] = op.index
                        add_ok_time[row] = op.time
            elif op.f == "read":
                if op.is_invoke:
                    open_reads[op.process] = op
                elif op.is_fail:
                    open_reads.pop(op.process, None)
                elif op.is_ok:
                    inv = open_reads.pop(op.process, None)
                    if inv is None:
                        continue
                    vals = op.value or ()
                    rcodes = [code(v) for v in vals]
                    uniq, counts = np.unique(
                        np.asarray(rcodes or [0], np.int64),
                        return_counts=True,
                    )
                    if rcodes:
                        for u, c2 in zip(uniq, counts):
                            if c2 > 1:
                                v = _dict_key(decode[int(u)])
                                dups[v] = max(dups.get(v, 0), int(c2))
                    reads.append(
                        (inv.index, inv.time, op.index, op.time, rcodes)
                    )

        E = len(add_inv_idx)
        R = len(reads)
        results: List[dict] = []
        if E:
            a_inv = np.asarray(add_inv_idx, np.int64)
            a_ok_idx = np.asarray(add_ok_idx, np.int64)
            a_ok_time = np.asarray(add_ok_time, np.int64)
            r_inv = np.asarray([r[0] for r in reads], np.int64)
            r_inv_t = np.asarray([r[1] for r in reads], np.int64)
            r_comp = np.asarray([r[2] for r in reads], np.int64)
            r_comp_t = np.asarray([r[3] for r in reads], np.int64)

            # Observation pairs (element row, read) — sparse, one per
            # element occurrence in a read payload.
            pe: List[int] = []
            pr: List[int] = []
            for r, rec in enumerate(reads):
                for c in rec[4]:
                    row = el_of_code.get(c)
                    if row is not None:
                        pe.append(row)
                        pr.append(r)
            pairs_e = np.asarray(pe, np.int64)
            pairs_r = np.asarray(pr, np.int64)

            if R:
                # Blocked presence analysis: the naive [E, R] matrix is
                # O(E*R) memory (VERDICT: it won't survive big
                # histories); blocks of elements bound it at
                # [E_BLK, R] while keeping every reduction vectorized.
                blk = max(_SETFULL_BLOCK_CELLS // max(R, 1), 1)
                outs = []
                for lo in range(0, E, blk):
                    hi = min(lo + blk, E)
                    sel = (pairs_e >= lo) & (pairs_e < hi)
                    presence = np.zeros((hi - lo, R), bool)
                    presence[pairs_e[sel] - lo, pairs_r[sel]] = True
                    eligible = r_comp[None, :] > a_inv[lo:hi, None]
                    outs.append(_setfull_block_reduce(
                        presence, eligible, r_inv, r_inv_t, r_comp,
                        r_comp_t,
                    ))
                (last_present, last_absent, first_obs_idx,
                 first_obs_time, la_inv_t, lp_inv_t) = (
                    np.concatenate([o[i] for o in outs])
                    for i in range(6)
                )
            else:
                last_present = last_absent = np.full(E, -1, np.int64)
                first_obs_idx = first_obs_time = np.full(E, -1, np.int64)
                la_inv_t = lp_inv_t = np.full(E, -1, np.int64)
            known_idx = np.where(
                (a_ok_idx >= 0)
                & ((first_obs_idx < 0) | (a_ok_idx < first_obs_idx)),
                a_ok_idx,
                first_obs_idx,
            )
            known_time = np.where(
                (a_ok_idx >= 0)
                & ((first_obs_idx < 0) | (a_ok_idx < first_obs_idx)),
                a_ok_time,
                first_obs_time,
            )

            stable = (last_present >= 0) & (last_absent < last_present)
            lost = (
                (known_idx >= 0)
                & (last_absent >= 0)
                & (last_present < last_absent)
                & (known_idx < last_absent)
            )
            # stable-time = just after the last absent read invocation
            # (0 if none); latency relative to known time, clamped at 0.
            stable_time = np.where(last_absent >= 0, la_inv_t + 1, 0)
            lost_time = np.where(last_present >= 0, lp_inv_t + 1, 0)
            stable_lat = np.maximum(stable_time - known_time, 0) // 1_000_000
            lost_lat = np.maximum(lost_time - known_time, 0) // 1_000_000

            rev = {row: c for c, row in el_of_code.items()}
            op_at = {o.index: o for o in h.ops}
            for e in range(E):
                outcome = (
                    "stable"
                    if stable[e]
                    else "lost" if lost[e] else "never-read"
                )
                results.append(
                    {
                        "element": decode[rev[e]],
                        "outcome": outcome,
                        "stable-latency": (
                            int(stable_lat[e]) if stable[e] else None
                        ),
                        "lost-latency": int(lost_lat[e]) if lost[e] else None,
                        "known": op_at.get(int(known_idx[e])),
                        "last-absent": op_at.get(int(last_absent[e])),
                    }
                )

        stable_rs = [r for r in results if r["outcome"] == "stable"]
        lost_rs = [r for r in results if r["outcome"] == "lost"]
        never_rs = [r for r in results if r["outcome"] == "never-read"]
        stale = [r for r in stable_rs if r["stable-latency"] > 0]
        worst_stale = sorted(
            stale, key=lambda r: -r["stable-latency"]
        )[:8]

        if lost_rs:
            valid: Any = False
        elif not stable_rs:
            valid = UNKNOWN
        elif self.linearizable and stale:
            valid = False
        else:
            valid = True
        if dups:
            valid = False

        out = {
            "valid?": valid,
            "attempt-count": len(results),
            "stable-count": len(stable_rs),
            "lost-count": len(lost_rs),
            "lost": sorted((r["element"] for r in lost_rs), key=repr),
            "never-read-count": len(never_rs),
            "never-read": sorted(
                (r["element"] for r in never_rs), key=repr
            ),
            "stale-count": len(stale),
            "stale": sorted((r["element"] for r in stale), key=repr),
            "worst-stale": worst_stale,
            "duplicated-count": len(dups),
            "duplicated": dups,
        }
        points = [0, 0.5, 0.95, 0.99, 1]
        sl = _frequency_distribution(
            points, [r["stable-latency"] for r in stable_rs]
        )
        if sl is not None:
            out["stable-latencies"] = sl
        ll = _frequency_distribution(
            points, [r["lost-latency"] for r in lost_rs]
        )
        if ll is not None:
            out["lost-latencies"] = ll
        return out


def set_checker() -> SetChecker:
    return SetChecker()


def set_full(linearizable: bool = False) -> SetFullChecker:
    return SetFullChecker(linearizable=linearizable)


def counter(device=None) -> CounterChecker:
    return CounterChecker(device=device)


def unique_ids() -> UniqueIdsChecker:
    return UniqueIdsChecker()


def queue(model_factory=UnorderedQueue) -> QueueChecker:
    return QueueChecker(model_factory)


def total_queue() -> TotalQueueChecker:
    return TotalQueueChecker()
