"""Set workload: add unique elements, read the set back, account for
every acknowledged element.

Reference: the set workloads the suites build on the set / set-full
checkers (jepsen/src/jepsen/checker.clj:182-233, :236-534; e.g.
tidb/src/tidb/sets.clj). The in-memory SetClient's `lossy` mode
acknowledges adds and then drops a fraction — the lost-update anomaly
the set checkers exist to catch.
"""

from __future__ import annotations

import itertools
import random
import threading
from typing import Optional, Set

from jepsen_tpu_torch.checker.reductions import SetFullChecker, set_checker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client


def adds(counter=None):
    """Unique-element add ops."""
    counter = counter if counter is not None else itertools.count()
    return lambda: {"f": "add", "value": next(counter)}


def reads(*_):
    return {"f": "read"}


class SetClient(Client):
    """Shared in-memory set. lossy=p drops each acked add with
    probability p AFTER acknowledging it."""

    def __init__(self, lossy: float = 0.0, rng=None, _shared=None):
        self.lossy = lossy
        self.rng = rng or random.Random()
        if _shared is not None:
            self._lock, self._set = _shared
        else:
            self._lock = threading.Lock()
            self._set: Set = set()

    def open(self, test, node):
        return SetClient(
            self.lossy, self.rng, (self._lock, self._set)
        )

    def invoke(self, test, op: Op) -> Op:
        with self._lock:
            if op.f == "add":
                if not (self.lossy and self.rng.random() < self.lossy):
                    self._set.add(op.value)
                return op.with_(type="ok")  # acked either way
            if op.f == "read":
                return op.with_(type="ok", value=sorted(self._set))
        raise ValueError(f"unknown op f={op.f!r}")


def workload(
    n_adds: int = 200,
    read_every: int = 20,
    rng: Optional[random.Random] = None,
    lossy: float = 0.0,
    full: bool = True,
) -> dict:
    """Adds interleaved with periodic reads, checked by set-full (or
    the simpler final-read set checker with full=False)."""
    rng = rng or random.Random(0)
    counter = itertools.count()
    mix = gen.mix(
        [adds(counter)] * (read_every - 1) + [reads], rng=rng
    )
    return {
        "client": SetClient(lossy=lossy, rng=rng),
        "generator": gen.clients(gen.limit(n_adds, mix)),
        # final read so every element is judged — runs after the main
        # phase, outside any time limit (runtime final_generator slot)
        "final_generator": gen.clients(gen.once(reads())),
        "checker": SetFullChecker() if full else set_checker(),
    }
