"""Long-fork detector: the parallel-snapshot-isolation anomaly where
two concurrent writes are observed in conflicting orders by different
readers. A port of jepsen_tpu.checker.longfork.

Reference semantics: jepsen/src/jepsen/tests/long_fork.clj — write txns
are single writes of unique keys, read txns read a whole n-key group;
two reads *fork* when each observes a write the other missed
(read-compare returning incomparable, long_fork.clj:158-196); multiple
writes to one key make the history unknown, distinct non-nil values for
one key make it illegal.

Since every key is written at most once, a read's observation per key
reduces to present/absent. Each group's distinct read states pack into
a binary [R, n] matrix V, and fork detection is ONE batched product:

    G = (V @ (1 - V).T) > 0        # G[a,b]: a saw something b missed
    forks = G & G.T (off-diagonal)

Groups batch along a leading axis (padded to the widest group), so a
256-key x 500k-op history (BASELINE config 5) is a single torch.einsum
on the resolved device, on every backend, as the reference runs its
jit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import txn as txnlib
from jepsen_tpu_torch.checker.events import bucket as _bucket
from jepsen_tpu_torch.device import _bump_launch, _host_get, resolve_device


def fork_pairs_torch(V: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """V [G, R, n] float32 0/1 presence; live [G, R] bool (padding rows
    dead). Returns the [G, R, R] bool fork-pair matrix on V's device."""
    missed = torch.einsum("grk,gsk->grs", V, 1.0 - V) > 0.5
    both = live[:, :, None] & live[:, None, :]
    return missed & missed.transpose(1, 2) & both


class LongForkChecker:
    """checker(n) analog (long_fork.clj:296-316).

    device: None means the CUDA card (check() raises without it);
    "cpu" runs the product with torch on the CPU."""

    def __init__(self, n: int = 2, device=None):
        self.n = n
        self.device = device

    def check(self, test, history, opts=None) -> dict:
        dev = resolve_device(self.device)
        got = self.group_states(history)
        if isinstance(got, dict):
            return got
        base, glist = got
        if glist:
            V, live = self.state_matrix(glist)
            # One solo device launch for the whole batched group
            # product, counted in the plane's ledgers like any launch.
            from jepsen_tpu_torch.checker import dispatch as _dispatch

            _dispatch._bump("requests")
            _dispatch._bump("solo_launches")
            _bump_launch("launches")
            pair = _host_get(fork_pairs_torch(
                torch.from_numpy(V).to(dev), torch.from_numpy(live).to(dev)
            ))
            fork_list = self.forks(glist, pair)
            if fork_list:
                return {**base, "valid?": False, "forks": fork_list}
        return {**base, "valid?": True}

    def group_states(self, history):
        """The host pass: a final verdict dict when the history is
        unknown or illegal, else (base counts, groups), each group a
        (key tuple, [(state, witness op), ...]) over its DISTINCT
        observation states (at most 2^n, usually a handful): forks are
        a property of states, not of individual reads, so a 500k-op
        history collapses to a few states per group in one O(R) pass,
        where the find-forks pairwise scan (long_fork.clj:216-224) is
        O(R^2)."""
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))

        # Multiple writes to one key -> unknown (long_fork.clj:259-275).
        written = set()
        for o in history.ops:
            if o.is_invoke and self._is_write_txn(o.value):
                k = o.value[0][1]
                if k in written:
                    return {
                        "valid?": "unknown",
                        "error": ["multiple-writes", k],
                    }
                written.add(k)

        reads = [
            o for o in history.ops
            if o.is_ok and self._is_read_txn(o.value)
        ]
        early = late = 0
        groups: Dict[Tuple, List[Tuple[Any, dict]]] = {}
        for o in reads:
            vals = {m[1]: m[2] for m in o.value}
            if len(vals) != self.n:
                return {
                    "valid?": "unknown",
                    "error": [
                        "wrong-group-size", sorted(vals), "expected", self.n
                    ],
                }
            if all(v is None for v in vals.values()):
                early += 1
            if all(v is not None for v in vals.values()):
                late += 1
            groups.setdefault(tuple(sorted(vals)), []).append((o, vals))

        base = {
            "reads_count": len(reads),
            "early_read_count": early,
            "late_read_count": late,
        }

        # Distinct non-nil values for one key -> illegal
        # (read-compare's final throw, long_fork.clj:190-196).
        for gkey, items in groups.items():
            seen: Dict[Any, Any] = {}
            for _, vals in items:
                for k, v in vals.items():
                    if v is None:
                        continue
                    if k in seen and seen[k] != v:
                        return {
                            **base,
                            "valid?": "unknown",
                            "error": ["distinct-values", k],
                        }
                    seen[k] = v

        glist = []
        for gkey, items in groups.items():
            state_witness: Dict[Tuple, Any] = {}
            for o, vals in items:
                state = tuple(
                    0 if vals[k] is None else 1 for k in gkey
                )
                state_witness.setdefault(state, o)
            glist.append((gkey, list(state_witness.items())))
        return base, glist

    def state_matrix(self, glist) -> Tuple[np.ndarray, np.ndarray]:
        """The product's inputs: V [G, Smax, n] float32 presence and
        live [G, Smax] bool, Smax the widest group's state count
        bucketed to a power of two."""
        Smax = _bucket(max(len(states) for _, states in glist))
        G = len(glist)
        V = np.zeros((G, Smax, self.n), np.float32)
        live = np.zeros((G, Smax), bool)
        for gi, (gkey, states) in enumerate(glist):
            for si, (state, _) in enumerate(states):
                live[gi, si] = True
                V[gi, si, :] = state
        return V, live

    @staticmethod
    def forks(glist, pair) -> list:
        """The verdict's fork list from the [G, Smax, Smax] fork-pair
        matrix: each unordered pair of fork states once, as its two
        witness reads."""
        out = []
        for gi, ri, si in zip(*np.nonzero(np.triu(pair, k=1))):
            a = glist[gi][1][ri][1]
            b = glist[gi][1][si][1]
            out.append(
                [
                    {"op_index": a.index, "value": a.value},
                    {"op_index": b.index, "value": b.value},
                ]
            )
        return out

    @staticmethod
    def _is_read_txn(v) -> bool:
        return (
            isinstance(v, (list, tuple))
            and len(v) > 0
            and all(
                isinstance(m, (list, tuple)) and len(m) == 3
                and m[0] == txnlib.R
                for m in v
            )
        )

    @staticmethod
    def _is_write_txn(v) -> bool:
        return (
            isinstance(v, (list, tuple))
            and len(v) == 1
            and isinstance(v[0], (list, tuple))
            and len(v[0]) == 3
            and v[0][0] == txnlib.W
        )


def long_fork_checker(n: int = 2, device=None) -> LongForkChecker:
    return LongForkChecker(n, device=device)
