"""Histories (a copy of jepsen_tpu.history.history, kept so the port
imports nothing of the JAX package): ordered sequences of operations plus the structural queries
checkers need (indexing, invocation/completion pairing, completion fill-in).

Reference behaviors reimplemented here:
- index assignment: knossos history/index, used at jepsen/src/jepsen/core.clj:441
- invoke/complete pairing: jepsen/src/jepsen/checker/timeline.clj:33-53 and
  jepsen/src/jepsen/util.clj:599-633 (history->latencies)
- completion fill-in ("complete"): knossos history/complete, used at
  jepsen/src/jepsen/checker.clj:699 — an :ok completion's value is
  authoritative, so it is copied back onto the invocation
- crash semantics: an :invoke with an :info completion (or none) stays
  concurrent with everything after it (jepsen/src/jepsen/core.clj:338-355)
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional, Sequence

from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, OK, Op, op as coerce_op


class History:
    """An immutable-by-convention sequence of Ops with checker-side queries."""

    def __init__(self, ops: Iterable = (), indexed: bool = False):
        self.ops: List[Op] = [coerce_op(o) for o in ops]
        if not indexed:
            self._assign_indices()
        self._pairs: Optional[dict] = None
        self._pos: Optional[dict] = None

    def _assign_indices(self) -> None:
        # Never mutate caller-owned Ops: two Histories built from one op list
        # must not clobber each other's indices.
        self.ops = [
            o if o.index == i else o.with_(index=i)
            for i, o in enumerate(self.ops)
        ]

    def _position(self, index: int) -> Optional[int]:
        """Position in self.ops of the op with the given history index.

        On filtered/sliced histories list position != op.index, so every
        pair-following query resolves through this map.
        """
        if self._pos is None:
            self._pos = {o.index: i for i, o in enumerate(self.ops)}
        return self._pos.get(index)

    # -- sequence protocol --------------------------------------------------
    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return History(self.ops[i], indexed=True)
        return self.ops[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, History):
            return self.ops == other.ops
        return NotImplemented

    def __repr__(self) -> str:
        return f"History<{len(self.ops)} ops>"

    # -- structural queries -------------------------------------------------
    def pairs(self) -> dict:
        """Map from invocation index -> completion index (and back).

        A completion is the next op by the same process after the invocation.
        Invocations without completions map to None.
        """
        if self._pairs is not None:
            return self._pairs
        out: dict = {}
        open_invokes: dict = {}  # process -> invocation index
        for o in self.ops:
            if o.is_invoke:
                open_invokes[o.process] = o.index
            elif o.type in (OK, FAIL, INFO) and o.process in open_invokes:
                inv = open_invokes.pop(o.process)
                out[inv] = o.index
                out[o.index] = inv
        for inv in open_invokes.values():
            out[inv] = None
        self._pairs = out
        return out

    def completion(self, invocation: Op) -> Optional[Op]:
        j = self.pairs().get(invocation.index)
        if j is None:
            return None
        p = self._position(j)
        return None if p is None else self.ops[p]

    def invocation(self, completion: Op) -> Optional[Op]:
        j = self.pairs().get(completion.index)
        if j is None:
            return None
        p = self._position(j)
        return None if p is None else self.ops[p]

    def complete(self) -> "History":
        """Fill in invocations from their completions, mirroring knossos
        history/complete (used at checker.clj:699):

        - :ok completion — its value is authoritative; copy it back onto the
          invocation.
        - :fail completion — the op definitely did not happen; mark the
          invocation with fails=True.
        - :info completion or none — the process crashed; the op stays
          concurrent with everything after it; mark crashed=True.
        """
        pairs = self.pairs()
        new_ops = []
        for o in self.ops:
            if o.is_invoke:
                j = pairs.get(o.index)
                p = self._position(j) if j is not None else None
                comp = self.ops[p] if p is not None else None
                if comp is not None and comp.is_ok:
                    o = o.with_(value=comp.value)
                elif comp is not None and comp.is_fail:
                    o = o.with_(fails=True)
                else:
                    o = o.with_(crashed=True)
            new_ops.append(o)
        return History(new_ops, indexed=True)

    # -- filters ------------------------------------------------------------
    def filter(self, pred: Callable[[Op], bool]) -> "History":
        return History([o for o in self.ops if pred(o)], indexed=True)

    def client_ops(self) -> "History":
        return self.filter(lambda o: o.is_client_op)

    def nemesis_ops(self) -> "History":
        return self.filter(lambda o: o.is_nemesis_op)

    def oks(self) -> "History":
        return self.filter(lambda o: o.is_ok)

    def invokes(self) -> "History":
        return self.filter(lambda o: o.is_invoke)

    def remove_failures(self) -> "History":
        """Drop :fail completions and their invocations: a failed op
        definitely did not happen (ref: checker.clj set/counter paths).
        """
        pairs = self.pairs()
        failed_invokes = set()
        for o in self.ops:
            if o.is_fail:
                inv = pairs.get(o.index)
                if inv is not None:
                    failed_invokes.add(inv)
        return self.filter(
            lambda o: not (o.is_fail or o.index in failed_invokes)
        )

    def by_f(self, f) -> "History":
        return self.filter(lambda o: o.f == f)

    def processes(self) -> set:
        return {o.process for o in self.ops}

    def latencies(self) -> List[tuple]:
        """[(invocation, completion, latency_nanos)] for completed client ops.
        Ref: jepsen/src/jepsen/util.clj:599-633."""
        pairs = self.pairs()
        out = []
        for o in self.ops:
            if o.is_invoke and o.is_client_op:
                j = pairs.get(o.index)
                p = self._position(j) if j is not None else None
                if p is not None:
                    comp = self.ops[p]
                    out.append((o, comp, comp.time - o.time))
        return out

    # -- interop ------------------------------------------------------------
    def to_dicts(self) -> List[dict]:
        return [o.to_dict() for o in self.ops]

    @classmethod
    def from_dicts(cls, ds: Sequence[dict], indexed: bool = False) -> "History":
        h = cls(ds, indexed=True)
        if not indexed or any(o.index < 0 for o in h.ops):
            h._assign_indices()
        return h
