"""List-append transaction workload for the dependency-graph checker.

Elle-style (PAPERS.md: "Elle: Inferring Isolation Anomalies from
Experimental Observations") list-append transactions: every append
value is globally unique, so the version order of each key is fully
recoverable from any read and wr/ww/rw dependency edges can be
inferred by checker/txn_graph.py without tracking the database's
internals.

The in-memory client executes txns over one lock (serializable — the
checker must report valid). `stale_reads=True` serves reads from a
snapshot that lags the live state by up to one commit: appends still land
live, so observed prefixes stay consistent, but readers can miss
committed appends — manufacturing rw anti-dependency edges and, with
enough contention, G-single/G2-item cycles for the checker to find.
"""

from __future__ import annotations

import random
import threading
from typing import List, Optional

from jepsen_tpu_torch import txn as txnlib
from jepsen_tpu_torch.checker.txn_graph import TxnGraphChecker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client


class TxnGraphGenerator(gen.Generator):
    """Emit f="txn" invokes of random append-mode transactions over
    rotating disjoint key groups (fresh groups keep dependency
    components small — the bucketed [B,N,N] device path's sweet spot).
    Pure: the unique-value counter and group cursor ride the
    generator's state, not module globals."""

    def __init__(self, keys_per_group: int, txns_per_group: int,
                 rng: random.Random, _state=None):
        self.kpg = keys_per_group
        self.tpg = txns_per_group
        self.rng = rng
        self._state = _state or {"group": 0, "left": txns_per_group,
                                 "next_val": 0}

    def op(self, test, ctx):
        free = gen.free_threads(ctx)
        threads = [t for t in free if not isinstance(t, str)]
        if not threads:
            return gen.PENDING, self
        st = dict(self._state)
        if st["left"] <= 0:
            st["group"] += 1
            st["left"] = self.tpg
        st["left"] -= 1
        keys = [st["group"] * self.kpg + j for j in range(self.kpg)]
        counter = [st["next_val"]]
        intents = txnlib.gen_txn(
            keys, rng=self.rng, mode="append", counter=counter
        )
        st["next_val"] = counter[0]
        o = {
            "f": "txn",
            "value": [list(m) for m in intents],
            "process": ctx["workers"][threads[0]],
            "type": "invoke",
            "time": ctx["time"],
        }
        return o, TxnGraphGenerator(self.kpg, self.tpg, self.rng, st)

    def update(self, test, ctx, event):
        return self


class TxnGraphClient(Client):
    """In-memory list-append store. One lock per txn keeps the default
    mode serializable. stale_reads=True answers reads from a snapshot
    refreshed only every other commit — readers lag the live lists by
    up to one committed txn, seeding rw edges."""

    def __init__(self, stale_reads: bool = False, _shared=None):
        self.stale_reads = stale_reads
        if _shared is not None:
            self._lock, self._live, self._snap, self._commits = _shared
        else:
            self._lock = threading.Lock()
            self._live: dict = {}
            self._snap: dict = {}
            self._commits = [0]

    def open(self, test, node):
        return TxnGraphClient(
            self.stale_reads,
            (self._lock, self._live, self._snap, self._commits),
        )

    def invoke(self, test, op: Op) -> Op:
        out: List[list] = []
        with self._lock:
            read_src = self._snap if self.stale_reads else self._live
            for f, k, v in op.value:
                if f == txnlib.R:
                    out.append([f, k, list(read_src.get(k) or ())])
                elif f == txnlib.APPEND:
                    self._live[k] = tuple(self._live.get(k) or ()) + (v,)
                    out.append([f, k, v])
                else:
                    raise ValueError(f"unknown micro-op {f!r}")
            if self.stale_reads:
                # Refresh only every other commit: readers lag the
                # live lists by up to one committed txn, so a txn that
                # reads-then-appends a hot key misses its ww
                # predecessor's append — the rw half of a G-single.
                self._commits[0] += 1
                if self._commits[0] % 2 == 0:
                    self._snap.update(self._live)
        return op.with_(type="ok", value=out)


def workload(
    n_ops: int = 200,
    keys_per_group: int = 3,
    txns_per_group: int = 12,
    rng: Optional[random.Random] = None,
    stale_reads: bool = False,
    device=None,
) -> dict:
    """Test-map slots; ``device`` is the checker's (None: the CUDA
    card)."""
    rng = rng or random.Random(0)
    return {
        "client": TxnGraphClient(stale_reads=stale_reads),
        "generator": gen.clients(
            gen.limit(
                n_ops,
                TxnGraphGenerator(keys_per_group, txns_per_group, rng),
            )
        ),
        "checker": TxnGraphChecker(device=device),
    }
