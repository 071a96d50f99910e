"""History sentry: validation/repair ahead of the encoder (a copy of
jepsen_tpu.history.sentry, kept so the port imports nothing of the JAX
package).

A stored history that reaches `analyze` after a crashed control plane
(or a hostile writer) can violate the structural invariants every
checker stage silently assumes: dense unique indices, invoke-before-
completion per process, at most one completion per invocation,
monotone timestamps, nemesis ops segregated from client streams.
history.pairs()/complete() tolerate some of these by construction and
silently mis-pair on others (test_history.py pins both) — so the
sentry runs FIRST, producing either a verified-clean pass-through or
a repaired copy plus a structured report.

Corruption classes and their dispositions:

- duplicate_index     two ops share a history index (pairs() keys by
                      index and clobbers) -> repair: reindex densely.
- missing_index       unindexed (< 0) ops -> repair: reindex densely.
- orphan_completion   completion with no open invocation on its
                      process (pairs() ignores it; kept implicit
                      until now) -> quarantine.
- double_completion   second completion for one invocation (pairs()
                      ignores it) -> quarantine.
- inversion           completion ordered BEFORE its own invocation
                      (adjacent transposition from an unsynchronized
                      writer) -> repair: swap back when the very next
                      op on that process is the matching invoke;
                      otherwise quarantine.
- unpaired_info       a client :info completion with no open invoke —
                      indistinguishable from an orphan, quarantined
                      (a crashed op's :invoke staying open forever is
                      NOT a defect; that is the crash semantics).
- non_monotone_time   a process's own timestamps running backwards —
                      causally impossible, a process is sequential
                      (GLOBAL monotonicity is deliberately NOT
                      required: the runtime stamps ops before taking
                      the journal lock, so healthy concurrent runs
                      interleave stamps slightly out of order) ->
                      repair: clamp to the process's running max
                      (order is authoritative; time is advisory).
- nemesis_interleaved a nemesis op carrying a client-like integer
                      process (it would enter the client window) ->
                      quarantine.

Repairs route through the SAME pairing definition History.pairs()
uses (completion = next op on the process), so a repaired history
means exactly what the checker will read. Strict mode raises
HistorySentryError naming every class found instead of repairing —
the `analyze --strict-history` contract (exit code 3).

The clean path is zero-copy: validate_history returns the ORIGINAL
History object untouched when no defect is found, so existing
differential guarantees (memoized streams included) are unaffected.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, NEMESIS, OK, Op
from jepsen_tpu_torch.obs import trace as obs_trace

#: every corruption class the sentry detects (strict mode raises on
#: any of them; tests iterate this to prove per-class coverage)
CORRUPTION_CLASSES = (
    "duplicate_index",
    "missing_index",
    "orphan_completion",
    "double_completion",
    "inversion",
    "unpaired_info",
    "non_monotone_time",
    "nemesis_interleaved",
)

_COMPLETIONS = (OK, FAIL, INFO)


class HistorySentryError(ValueError):
    """Strict-mode refusal: the history failed validation."""

    def __init__(self, classes: Dict[str, int]):
        self.classes = dict(classes)
        detail = ", ".join(
            f"{k}x{v}" for k, v in sorted(classes.items())
        )
        super().__init__(
            f"history failed sentry validation: {detail}"
        )


def _scan(ops: List[Op]) -> Dict[str, int]:
    """Detect-only pass: {corruption class: count}. Mirrors
    History.pairs()' open-invokes walk exactly, so what it calls
    mis-paired is precisely what the checker would mis-read."""
    found: Dict[str, int] = {}

    def note(cls: str, n: int = 1) -> None:
        found[cls] = found.get(cls, 0) + n

    seen_idx = set()
    open_inv: Dict = {}  # process -> position of open invoke
    last_done: Dict = {}  # process -> f of last CONSUMED invocation
    last_t: Dict = {}  # process -> running max time
    for i, o in enumerate(ops):
        idx = o.index
        if idx is None or idx < 0:
            note("missing_index")
        elif idx in seen_idx:
            note("duplicate_index")
        else:
            seen_idx.add(idx)
        if o.time is not None and o.time >= 0:
            if o.time < last_t.get(o.process, o.time):
                note("non_monotone_time")
            else:
                last_t[o.process] = o.time
        if o.process == NEMESIS:
            continue
        if not isinstance(o.process, int):
            continue  # non-client, non-nemesis: outside the window
        if o.type == INVOKE:
            open_inv[o.process] = i
        elif o.type in _COMPLETIONS:
            if o.process in open_inv:
                open_inv.pop(o.process)
                last_done[o.process] = o.f
            else:
                # No open invoke. Disambiguate by what the process
                # just did and does next: a repeat of the last
                # CONSUMED invocation's f is a double completion; a
                # matching invoke as the literal next op on this
                # process is an inversion (adjacent transposition);
                # anything else is an orphan (which for :info is the
                # unpaired-crash class).
                nxt = next(
                    (
                        n for n in ops[i + 1:]
                        if n.process == o.process
                    ),
                    None,
                )
                if last_done.get(o.process) == o.f:
                    note("double_completion")
                elif (
                    nxt is not None
                    and nxt.type == INVOKE
                    and nxt.f == o.f
                ):
                    note("inversion")
                elif o.type == INFO:
                    note("unpaired_info")
                else:
                    note("orphan_completion")
    # nemesis ops that would enter the client window: an integer
    # process on a nemesis-flagged op (extra["nemesis"]) — or, the
    # common corruption, a nemesis f (start/stop/heal) riding an int
    # process while true nemesis ops with the same f exist.
    nem_fs = {
        o.f for o in ops if o.process == NEMESIS and o.f is not None
    }
    if nem_fs:
        for o in ops:
            if (
                isinstance(o.process, int)
                and o.f in nem_fs
            ):
                note("nemesis_interleaved")
    return found


def _repair(
    ops: List[Op],
) -> Tuple[List[Op], Dict[str, int], List[int]]:
    """One repair pass. Returns (repaired ops, repairs applied,
    quarantined original indices). Quarantined ops are REMOVED —
    their original indices land in the report so nothing disappears
    silently."""
    repairs: Dict[str, int] = {}
    quarantined: List[int] = []

    def note(cls: str, n: int = 1) -> None:
        repairs[cls] = repairs.get(cls, 0) + n

    nem_fs = {
        o.f for o in ops if o.process == NEMESIS and o.f is not None
    }

    # Pass 1: fix inversions by swapping adjacent (completion, invoke)
    # pairs on one process back into invoke-first order. The same
    # disambiguation as _scan: a repeat of the last consumed
    # invocation's f is a DOUBLE completion, not an inversion — leave
    # it for pass 2's quarantine.
    ops = list(ops)
    changed = True
    while changed:
        changed = False
        open_inv: Dict = {}
        last_done: Dict = {}
        i = 0
        while i < len(ops):
            o = ops[i]
            if isinstance(o.process, int):
                if o.type == INVOKE:
                    open_inv[o.process] = i
                elif o.type in _COMPLETIONS:
                    if o.process in open_inv:
                        open_inv.pop(o.process)
                        last_done[o.process] = o.f
                    elif last_done.get(o.process) != o.f:
                        nxt = next(
                            (
                                j for j in range(i + 1, len(ops))
                                if ops[j].process == o.process
                            ),
                            None,
                        )
                        if (
                            nxt is not None
                            and ops[nxt].type == INVOKE
                            and ops[nxt].f == o.f
                        ):
                            inv = ops.pop(nxt)
                            ops.insert(i, inv)
                            note("inversion")
                            changed = True
                            break
            i += 1

    # Pass 2: quarantine walk. open_count keeps each process's last
    # invocation with its completion count — the SAME pairing rule
    # pairs() applies (completion = next op on the process), except
    # the entry survives its first completion so a second one
    # classifies as double_completion rather than orphan (matching
    # _scan's definition).
    out: List[Op] = []
    open_count: Dict = {}
    for o in ops:
        if isinstance(o.process, int):
            if o.f in nem_fs and nem_fs:
                note("nemesis_interleaved")
                quarantined.append(o.index)
                continue
            if o.type == INVOKE:
                open_count[o.process] = 0
                out.append(o)
                continue
            if o.type in _COMPLETIONS:
                if o.process not in open_count:
                    note(
                        "unpaired_info"
                        if o.type == INFO
                        else "orphan_completion"
                    )
                    quarantined.append(o.index)
                    continue
                if open_count[o.process] >= 1:
                    note("double_completion")
                    quarantined.append(o.index)
                    continue
                open_count[o.process] += 1
                out.append(o)
                continue
        out.append(o)

    # Pass 3: clamp each process's non-monotone timestamps to its own
    # running max (global interleaving jitter is healthy — see module
    # docstring).
    last_t: Dict = {}
    fixed: List[Op] = []
    for o in out:
        if o.time is not None and o.time >= 0:
            prev = last_t.get(o.process)
            if prev is not None and o.time < prev:
                o = o.with_(time=prev)
                note("non_monotone_time")
            else:
                last_t[o.process] = o.time
        fixed.append(o)

    # Pass 4: reindex densely when indices are duplicated/missing
    # (original indices persist in op.extra["orig_index"] so failure
    # reports can still point at the stored file's line).
    idxs = [o.index for o in fixed]
    needs_reindex = any(
        i is None or i < 0 for i in idxs
    ) or len(set(idxs)) != len(idxs)
    if needs_reindex:
        dup = sum(
            1 for n, i in enumerate(idxs)
            if i is not None and i >= 0 and i in idxs[:n]
        )
        miss = sum(1 for i in idxs if i is None or i < 0)
        if dup:
            note("duplicate_index", dup)
        if miss:
            note("missing_index", miss)
        fixed = [
            o.with_(index=i, orig_index=o.index)
            for i, o in enumerate(fixed)
        ]
    return fixed, repairs, quarantined


def scan_history(history) -> Dict[str, int]:
    """Detect-only entry: {corruption class: count}, empty when clean.
    No repair, no raise — the shape services use to triage a payload
    (admission logging, /stats attribution) without committing to the
    strict-or-repair decision validate_history makes."""
    if not isinstance(history, History):
        history = History(history)
    return _scan(history.ops)


@obs_trace.traced("sentry")
def validate_history(
    history, strict: bool = False
) -> Tuple[History, Dict]:
    """The sentry's entry: (history to check, history_report).

    Clean histories return the ORIGINAL object unchanged (zero-copy —
    memoized event streams and differential guarantees untouched)
    with {"clean": True}. Dirty ones return a repaired COPY plus the
    full report; strict=True raises HistorySentryError instead of
    repairing."""
    if not isinstance(history, History):
        history = History(history)
    found = _scan(history.ops)
    if not found:
        return history, {"clean": True, "repairs": {}, "quarantined": []}
    if strict:
        raise HistorySentryError(found)
    fixed, repairs, quarantined = _repair(history.ops)
    # A second scan proves the repair converged; anything left is a
    # shape this sentry cannot mend (never seen in practice — belt
    # and braces for hostile inputs).
    residue = _scan(fixed)
    report = {
        "clean": False,
        "detected": found,
        "repairs": repairs,
        "quarantined": quarantined,
        "n_in": len(history),
        "n_out": len(fixed),
    }
    if residue:
        report["residue"] = residue
    return History(fixed, indexed=True), report
