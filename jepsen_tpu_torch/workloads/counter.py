"""Counter workload: concurrent increments + reads, checked by the
interval-bound counter checker.

Reference: the counter workloads in yugabyte/aerospike suites feeding
jepsen.checker/counter (checker.clj:679-734): every read must fall
within [sum of acked adds so far, sum of possibly-applied adds].

weak=True drops ~5% of acked increments — reads eventually fall below
the acknowledged lower bound."""

from __future__ import annotations

import random
import threading
from typing import Optional

from jepsen_tpu_torch.checker import reductions
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client


class _Counter:
    def __init__(self, weak: bool, rng):
        self.value = 0
        self.lock = threading.Lock()
        self.weak = weak
        self.rng = rng or random.Random(0)


class CounterClient(Client):
    def __init__(self, state: Optional[_Counter] = None,
                 weak: bool = False, rng=None):
        self.state = state or _Counter(weak, rng)

    def open(self, test, node):
        return CounterClient(self.state)

    def invoke(self, test, op: Op) -> Op:
        st = self.state
        with st.lock:
            if op.f == "add":
                if not (st.weak and st.rng.random() < 0.05):
                    st.value += op.value
                return op.with_(type="ok")
            if op.f == "read":
                return op.with_(type="ok", value=st.value)
        raise ValueError(f"unknown op f={op.f!r}")


def generator(n_ops: int = 300, rng: Optional[random.Random] = None):
    rng = rng or random.Random(0)

    def add():
        return {"f": "add", "value": 1 + rng.randrange(3)}

    return gen.clients(gen.limit(
        n_ops, gen.mix([add, add, {"f": "read"}], rng=rng)
    ))


def workload(
    n_ops: int = 300,
    weak: bool = False,
    rng: Optional[random.Random] = None,
    device=None,
) -> dict:
    """Test-map slots; ``device`` is the checker's (None: the CUDA
    card)."""
    return {
        "client": CounterClient(weak=weak, rng=rng),
        "generator": generator(n_ops, rng),
        "checker": reductions.counter(device=device),
    }
