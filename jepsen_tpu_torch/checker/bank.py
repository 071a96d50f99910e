"""Bank checker: every read of all accounts must sum to the constant
total, balances must be non-nil (and non-negative unless allowed).
A port of jepsen_tpu.checker.bank.

Reference semantics: jepsen/src/jepsen/tests/bank.clj:57-121 — reads
carry {account: balance} maps; errors classify as unexpected-key /
nil-balance / wrong-total / negative-value, with the worst offender
reported per class (err-badness, bank.clj:46-55).

The host interns account ids once and packs all ok reads into a dense
[R, A] float32 balance matrix (NaN = nil/missing); the verdict is a
handful of row reductions: numpy on the host, or torch ops on the card
(bank_reduce_torch) once the matrix reaches _DEVICE_CELLS, with the
four answers stacked into one [4, R] fetch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from jepsen_tpu_torch.checker.events import bucket as _bucket
from jepsen_tpu_torch.device import _host_get, resolve_device

_NAN = float("nan")

#: cells above which the reduction moves onto the card (below it, the
#: host<->device round trip costs more than the math)
_DEVICE_CELLS = 2_000_000


def bank_reduce_torch(bal: torch.Tensor, total: float) -> torch.Tensor:
    """bal [R, A] float32 (NaN = nil) -> ONE stacked [4, R] float32
    tensor (has_nil, wrong_total, negative, sums) on bal's device, so
    the host fetches it in one round trip, not four. All-NaN padding
    rows report has_nil and are sliced off by the caller. The sums stay
    float32, as the reference's are, so sums != total compares the same
    way."""
    has_nil = torch.isnan(bal).any(dim=1)
    sums = torch.where(has_nil, torch.zeros((), dtype=bal.dtype,
                                            device=bal.device),
                       torch.nansum(bal, dim=1))
    wrong_total = ~has_nil & (sums != total)
    negative = ~has_nil & (bal < 0).any(dim=1)
    return torch.stack([
        has_nil.to(bal.dtype),
        wrong_total.to(bal.dtype),
        negative.to(bal.dtype),
        sums,
    ])


def _bank_reduce(bal, total, dev: torch.device, force_device=None):
    use_device = force_device if force_device is not None else (
        bal.size >= _DEVICE_CELLS and dev.type == "cuda"
    )
    if use_device:
        out = _host_get(bank_reduce_torch(
            torch.from_numpy(bal).to(dev), total))
        return (out[0] > 0.5, out[1] > 0.5, out[2] > 0.5, out[3])
    has_nil = np.any(np.isnan(bal), axis=1)
    with np.errstate(invalid="ignore"):
        sums = np.where(has_nil, np.float32(0), np.nansum(bal, axis=1))
        negative = ~has_nil & np.any(bal < 0, axis=1)
    wrong_total = ~has_nil & (sums != total)
    return has_nil, wrong_total, negative, sums


@dataclass
class BankPlane:
    """Columnar view of a bank history: the dense [rows, A] balance
    matrix (NaN = nil/excluded) the device reduction consumes, plus the
    record-view anchors needed for error artifacts. Encoded once
    (BankChecker.encode), checked many times."""

    bal: np.ndarray  # [n_rows >= R, A] float32; rows past R are padding
    reads: List[Any]  # the R ok-read ops, in history order
    #: reads excluded at encode time: (op, unexpected_keys)
    unexpected: List[tuple] = field(default_factory=list)


class BankChecker:
    """checker() analog (bank.clj:84-121). Spec keys consumed from the
    test map: accounts (default range(8)), total_amount (default 100).

    device: None means the CUDA card (check() raises without it); "cpu"
    keeps every reduction on the host unless force_device. force_device:
    True runs the torch reduction on the resolved device, False the
    numpy one; None decides by size (_DEVICE_CELLS, on the card only).
    """

    def __init__(self, negative_balances: bool = False,
                 force_device=None, device=None):
        self.negative_balances = negative_balances
        self.force_device = force_device
        self.device = device

    @staticmethod
    def encode(test, history) -> BankPlane:
        """One host pass interning balances into the dense matrix.
        Object-keyed checks happen here; everything numeric is left to
        the vectorized verdict in check()."""
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        accounts = list(test.get("accounts", range(8)))
        acct_idx = {a: i for i, a in enumerate(accounts)}
        A = len(accounts)

        reads: List[Any] = [
            o for o in history.ops if o.is_ok and o.f == "read"
            and isinstance(o.value, dict)
        ]
        R = len(reads)
        unexpected_rows: List[tuple] = []

        # Rows pad up to a power-of-two bucket. Fast path: reads whose
        # key tuple matches the account order exactly (how clients
        # build them) turn into one row tuple, with no per-item
        # indexing.
        acct_tuple = tuple(accounts)
        n_rows = _bucket(max(R, 1))
        rows: List[Any] = []
        slow: List[tuple] = []  # (row, op) pairs needing keyed fill
        zero_row = (0.0,) * A
        for i, op in enumerate(reads):
            v = op.value
            if tuple(v) == acct_tuple:
                rows.append([
                    _NAN if x is None else x for x in v.values()
                ])
                continue
            unexpected = [k for k in v if k not in acct_idx]
            if unexpected:
                rows.append([_NAN] * A)  # excluded row
                unexpected_rows.append((op, unexpected))
                continue
            # Missing accounts count 0 toward the sum (surfacing as
            # wrong-total, as in the reference, which sums only the
            # provided balances — bank.clj:58-75); only an explicit
            # nil balance is a nil-balance error.
            rows.append(list(zero_row))
            slow.append((i, op))
        rows.extend([[_NAN] * A] * (n_rows - len(rows)))
        bal = np.asarray(rows, np.float32)
        for i, op in slow:
            for k, x in op.value.items():
                bal[i, acct_idx[k]] = _NAN if x is None else x
        return BankPlane(bal=bal, reads=reads, unexpected=unexpected_rows)

    def check(self, test, history, opts=None) -> dict:
        dev = resolve_device(self.device)
        total = test.get("total_amount", 100)
        plane = (
            history
            if isinstance(history, BankPlane)
            else self.encode(test, history)
        )
        bal, reads = plane.bal, plane.reads
        R = len(reads)
        errors: Dict[str, dict] = {}

        def record(kind: str, op, **details):
            e = errors.setdefault(
                kind, {"count": 0, "first": None, "worst": None,
                       "_badness": -1.0}
            )
            e["count"] += 1
            entry = {"op_index": op.index, "value": op.value, **details}
            if e["first"] is None:
                e["first"] = entry
            badness = details.get("badness", 0.0)
            if badness > e["_badness"]:
                e["_badness"] = badness
                e["worst"] = entry

        for op, unexpected in plane.unexpected:
            record(
                "unexpected-key", op,
                unexpected=unexpected, badness=float(len(unexpected)),
            )

        if R:
            has_nil, wrong_total, negative, sums = _bank_reduce(
                bal, float(total), dev, force_device=self.force_device
            )
            for i in np.nonzero(has_nil[:R])[0]:
                op = reads[i]
                nils = [k for k, v in op.value.items() if v is None]
                if not nils:
                    continue  # row skipped as unexpected-key
                record("nil-balance", op, nils=nils,
                       badness=float(len(nils)))
            for i in np.nonzero(wrong_total[:R])[0]:
                op = reads[i]
                record(
                    "wrong-total", op, total=float(sums[i]),
                    badness=abs(float(sums[i]) - total) / max(total, 1),
                )
            if not self.negative_balances:
                for i in np.nonzero(negative[:R])[0]:
                    op = reads[i]
                    neg = [v for v in op.value.values()
                           if v is not None and v < 0]
                    record(
                        "negative-value", op,
                        negative=neg, badness=float(-sum(neg)),
                    )

        for e in errors.values():
            e.pop("_badness", None)
        error_count = sum(e["count"] for e in errors.values())
        first = None
        for e in errors.values():
            if e["first"] is not None and (
                first is None or e["first"]["op_index"] < first["op_index"]
            ):
                first = e["first"]
        return {
            "valid?": not errors,
            "read_count": R,
            "error_count": error_count,
            "first_error": first,
            "errors": errors,
        }


def bank_checker(negative_balances: bool = False,
                 device=None) -> BankChecker:
    return BankChecker(negative_balances=negative_balances, device=device)
