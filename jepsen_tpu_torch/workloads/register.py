"""Linearizable CAS-register workload — the canonical etcd shape.

Reference: jepsen/src/jepsen/tests/linearizable_register.clj:22-53
(independent keyed CAS registers checked by the linearizability engine)
and the etcd suite's r/w/cas mix (etcd/src/jepsen/etcd.clj:145-173).
"""

from __future__ import annotations

import random
from typing import Any, Optional

from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.runtime.client import AtomClient


def r(*_):
    return {"f": "read"}


def w(rng: random.Random, n_values: int = 5):
    return lambda: {"f": "write", "value": rng.randrange(n_values)}


def cas(rng: random.Random, n_values: int = 5):
    return lambda: {
        "f": "cas",
        "value": [rng.randrange(n_values), rng.randrange(n_values)],
    }


def op_mix(rng: Optional[random.Random] = None, n_values: int = 5):
    """The etcd r/w/cas mix (etcd.clj:145-147)."""
    rng = rng or random.Random()
    return gen.mix([r(), w(rng, n_values), cas(rng, n_values)], rng=rng)


def workload(
    n_ops: int = 500,
    rng: Optional[random.Random] = None,
    stagger_s: float = 1 / 5000,
    device=None,
) -> dict:
    """Single-key register test slots: generator + client + checker
    (``device``: the checker's; None is the CUDA card)."""
    rng = rng or random.Random(0)
    return {
        "client": AtomClient(),
        "generator": gen.clients(
            gen.limit(n_ops, gen.stagger(stagger_s, op_mix(rng), rng=rng))
        ),
        "checker": LinearizableChecker(device=device),
    }


class MultiRegisterClient(AtomClient):
    """AtomClient over a map of independent keyed registers, consuming
    independent.KV values (linearizable_register.clj's client role)."""

    def __init__(self, registers=None):
        super().__init__()
        self.registers = registers if registers is not None else {}
        self._lock = __import__("threading").Lock()

    def open(self, test, node):
        return MultiRegisterClient(self.registers)

    def _register(self, k):
        from jepsen_tpu_torch.runtime.client import AtomRegister

        with self._lock:
            if k not in self.registers:
                self.registers[k] = AtomRegister()
            return self.registers[k]

    def invoke(self, test, op):
        kv = op.value
        if not isinstance(kv, independent.KV):
            raise ValueError(f"expected KV value, got {op.value!r}")
        # Delegate to an AtomClient over the keyed register, rewrapping
        # the result value.
        inner = op.with_(value=kv.value)
        out = AtomClient(self._register(kv.key)).invoke(test, inner)
        return out.with_(value=independent.KV(kv.key, out.value))


def keyed_workload(
    keys=range(8),
    per_key_ops: int = 100,
    threads_per_key: int = 2,
    rng: Optional[random.Random] = None,
    device=None,
) -> dict:
    """Independent keyed registers: concurrent groups over keys, the
    linearizable_register.clj shape. The check takes one kernel-A
    launch a key on the card (``device``; None is the CUDA card)."""
    rng = rng or random.Random(0)
    return {
        "client": MultiRegisterClient(),
        "generator": independent.concurrent_generator(
            threads_per_key,
            list(keys),
            lambda k: gen.limit(per_key_ops, op_mix(rng)),
        ),
        "checker": independent.independent_checker(
            LinearizableChecker(device=device)
        ),
    }


class ReplicatedRegisterClient(AtomClient):
    """A deliberately partition-sensitive register: one replica per
    node; writes apply locally and replicate only to nodes the test's
    MemNet currently allows; reads are local. Under a partition,
    stale reads surface as linearizability violations — the in-process
    analog of testing a real replicated store under a partitioner
    nemesis (the role of the reference's Docker harness + etcd)."""

    def __init__(self, replicas=None, node=None, latency_s=0.0):
        self.replicas = replicas if replicas is not None else {}
        self.node = node
        self.latency_s = latency_s
        self._lock = __import__("threading").Lock()

    def open(self, test, node):
        with self._lock:
            for n in test["nodes"]:
                self.replicas.setdefault(n, [0, None])  # [version, value]
        return ReplicatedRegisterClient(self.replicas, node, self.latency_s)

    def invoke(self, test, op):
        net = test.get("net")
        if self.latency_s:
            __import__("time").sleep(self.latency_s)
        with self._lock:
            local = self.replicas[self.node]
            if op.f == "read":
                return op.with_(type="ok", value=local[1])
            if op.f == "write":
                ver = local[0] + 1
                for n, rep in self.replicas.items():
                    if n == self.node or net is None or net.allows(
                        self.node, n
                    ):
                        if ver > rep[0]:
                            rep[0] = ver
                            rep[1] = op.value
                local[0] = max(local[0], ver)
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                if local[1] != old:
                    return op.with_(type="fail")
                ver = local[0] + 1
                for n, rep in self.replicas.items():
                    if n == self.node or net is None or net.allows(
                        self.node, n
                    ):
                        if ver > rep[0]:
                            rep[0] = ver
                            rep[1] = new
                return op.with_(type="ok")
        raise ValueError(f"unknown op f={op.f!r}")
