"""Long-fork workload: unique single-key write txns plus whole-group
read txns, hunting the parallel-SI fork anomaly.

Reference: jepsen/src/jepsen/tests/long_fork.clj:96-156 — workers
alternate writing a fresh key and reading that key's n-key group,
occasionally reading another worker's active group. The in-memory
LongForkClient's `forked=True` mode maintains two replicas with
write-propagation split by key parity and serves reads from alternating
replicas — the canonical long-fork behavior.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from jepsen_tpu_torch import txn as txnlib
from jepsen_tpu_torch.checker.longfork import LongForkChecker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client


def group_for(n: int, k: int) -> List[int]:
    lo = k - (k % n)
    return list(range(lo, lo + n))


def read_txn_for(n: int, k: int, rng: random.Random) -> List:
    ks = group_for(n, k)
    rng.shuffle(ks)
    return [list(txnlib.r(kk)) for kk in ks]


class LongForkGenerator(gen.Generator):
    """Pure-functional port of the stateful generator
    (long_fork.clj:120-156): each thread alternates a fresh-key write
    txn and a read of that key's group; occasionally reads another
    thread's active group instead of writing."""

    def __init__(self, n: int, rng: random.Random, _state=None):
        self.n = n
        self.rng = rng
        self._state = _state or {"next_key": 0, "workers": {}}

    def op(self, test, ctx):
        free = gen.free_threads(ctx)
        threads = [t for t in free if not isinstance(t, str)]
        if not threads:
            return gen.PENDING, self
        t = threads[0]
        st = {
            "next_key": self._state["next_key"],
            "workers": dict(self._state["workers"]),
        }
        pending = st["workers"].get(t)
        if pending is not None:
            o = {
                "f": "read",
                "value": read_txn_for(self.n, pending, self.rng),
                "process": ctx["workers"][t],
            }
            st["workers"][t] = None
        else:
            actives = [k for k in st["workers"].values() if k is not None]
            if actives and self.rng.random() < 0.5:
                k = self.rng.choice(actives)
                o = {
                    "f": "read",
                    "value": read_txn_for(self.n, k, self.rng),
                    "process": ctx["workers"][t],
                }
            else:
                k = st["next_key"]
                st["next_key"] = k + 1
                st["workers"][t] = k
                o = {
                    "f": "write",
                    "value": [list(txnlib.w(k, 1))],
                    "process": ctx["workers"][t],
                }
        o.setdefault("type", "invoke")
        o.setdefault("time", ctx["time"])
        return o, LongForkGenerator(self.n, self.rng, st)

    def update(self, test, ctx, event):
        return self


class LongForkClient(Client):
    """In-memory store. forked=False: one linearizable map (no forks
    possible). forked=True: two replicas; writes land on one replica
    first by key parity, reads alternate replicas — readers observe
    conflicting write orders."""

    def __init__(self, forked: bool = False, _shared=None):
        self.forked = forked
        if _shared is not None:
            (self._lock, self._replicas, self._rr) = _shared
        else:
            self._lock = threading.Lock()
            self._replicas = [{}, {}]
            self._rr = [0]

    def open(self, test, node):
        return LongForkClient(
            self.forked, (self._lock, self._replicas, self._rr)
        )

    def invoke(self, test, op: Op) -> Op:
        mops = op.value
        with self._lock:
            if op.f == "write":
                (_, k, v), = mops
                if self.forked:
                    # Propagate to only one replica, chosen by parity —
                    # the other replica lags forever.
                    self._replicas[k % 2][k] = v
                else:
                    for rep in self._replicas:
                        rep[k] = v
                return op.with_(type="ok")
            if op.f == "read":
                rep = self._replicas[self._rr[0] % 2]
                self._rr[0] += 1
                out = [
                    [f, k, rep.get(k)] for f, k, _ in mops
                ]
                return op.with_(type="ok", value=out)
        raise ValueError(f"unknown op {op.f!r}")


def workload(
    n: int = 2,
    n_ops: int = 200,
    rng: Optional[random.Random] = None,
    forked: bool = False,
    device=None,
) -> dict:
    """Test-map slots; ``device`` is the checker's (None: the CUDA
    card)."""
    rng = rng or random.Random(0)
    return {
        "client": LongForkClient(forked=forked),
        "generator": gen.clients(
            gen.limit(n_ops, LongForkGenerator(n, rng))
        ),
        "checker": LongForkChecker(n, device=device),
    }
