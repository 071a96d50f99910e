"""Fault injection: the nemesis protocol and fault library.

Reference: jepsen/src/jepsen/nemesis.clj — protocol (:9-14), grudge
builders bisect/split-one/complete-grudge/bridge/majorities-ring
(:72-109,151-166), partitioner + canned partitioners (:111-172),
f-routing compose (:174-212), clock-scrambler (:219-234),
node-start-stopper targeting harness (:236-279), hammer-time
SIGSTOP/CONT (:281-295), truncate-file corruption (:297-323), timeout
wrapper (:56-70).

The grudge algebra is pure data (unit-tested without any cluster); the
side-effecting nemeses act through the test's Net / control sessions,
so they run identically against iptables-over-SSH, a local shell, a
recording dummy, or the in-process MemNet.

The port's copy of jepsen_tpu.nemesis; tests/test_torch_nemesis.py holds
the two against each other.
"""

from __future__ import annotations

import math
import random as _random
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from jepsen_tpu_torch import net as netlib
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.utils.util import majority


class Nemesis:
    """Protocol (nemesis.clj:9-14)."""

    def setup(self, test) -> "Nemesis":
        return self

    def invoke(self, test, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test) -> None:
        pass


class Noop(Nemesis):
    def invoke(self, test, op: Op) -> Op:
        return op.with_(type="info")


noop = Noop


# -- grudge algebra (pure; nemesis.clj:72-109,151-166) -----------------------


def bisect(coll: Sequence) -> List[List]:
    """Cut a sequence in half, smaller half first."""
    coll = list(coll)
    mid = len(coll) // 2
    return [coll[:mid], coll[mid:]]


def split_one(coll: Sequence, loner=None,
              rng: Optional[_random.Random] = None) -> List[List]:
    """Split one node off from the rest."""
    coll = list(coll)
    if loner is None:
        loner = (rng or _random).choice(coll)
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components: Iterable[Iterable]) -> Dict[Any, set]:
    """No node may talk to any node outside its component."""
    comps = [set(c) for c in components]
    universe = set().union(*comps) if comps else set()
    grudge: Dict[Any, set] = {}
    for comp in comps:
        for node in comp:
            grudge[node] = universe - comp
    return grudge


def bridge(nodes: Sequence) -> Dict[Any, set]:
    """Cut the network in half but leave one node connected to both
    sides."""
    components = bisect(nodes)
    b = components[1][0]
    grudge = complete_grudge(components)
    grudge.pop(b, None)
    return {node: (snubbed - {b}) for node, snubbed in grudge.items()}


def majorities_ring(
    nodes: Sequence, rng: Optional[_random.Random] = None
) -> Dict[Any, set]:
    """Every node sees a majority, but no two nodes see the SAME
    majority: majorities are windows of a shuffled ring, and each
    window's middle node snubs everything outside its window."""
    nodes = list(nodes)
    rng = rng or _random
    shuffled = list(nodes)
    rng.shuffle(shuffled)
    U = set(nodes)
    n = len(nodes)
    m = majority(n)
    grudge: Dict[Any, set] = {}
    for i in range(n):
        window = [shuffled[(i + j) % n] for j in range(m)]
        center = window[len(window) // 2]
        grudge[center] = U - set(window)
    return grudge


# -- partitioner (nemesis.clj:111-172) ---------------------------------------


class Partitioner(Nemesis):
    """:start cuts links per the grudge function; :stop heals."""

    def __init__(self, grudge_fn: Optional[Callable] = None):
        self.grudge_fn = grudge_fn

    def setup(self, test) -> "Partitioner":
        netlib.heal(test)
        return self

    def invoke(self, test, op: Op) -> Op:
        if op.f == "start":
            grudge = op.value
            if grudge is None:
                if self.grudge_fn is None:
                    raise ValueError("no grudge in op and no grudge fn")
                grudge = self.grudge_fn(test["nodes"])
            netlib.drop_all(test, grudge)
            return op.with_(
                type="info",
                value=["isolated",
                       {k: sorted(v) for k, v in grudge.items()}],
            )
        if op.f == "stop":
            netlib.heal(test)
            return op.with_(type="info", value="network-healed")
        raise ValueError(f"partitioner can't handle f={op.f!r}")

    def teardown(self, test) -> None:
        netlib.heal(test)


def partitioner(grudge_fn=None) -> Partitioner:
    return Partitioner(grudge_fn)


def partition_halves() -> Partitioner:
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves(rng=None) -> Partitioner:
    r = rng or _random

    def grudge(nodes):
        sh = list(nodes)
        r.shuffle(sh)
        return complete_grudge(bisect(sh))

    return Partitioner(grudge)


def partition_random_node(rng=None) -> Partitioner:
    return Partitioner(
        lambda nodes: complete_grudge(split_one(nodes, rng=rng))
    )


def partition_majorities_ring(rng=None) -> Partitioner:
    return Partitioner(lambda nodes: majorities_ring(nodes, rng=rng))


# -- compose (nemesis.clj:174-212) -------------------------------------------


class Compose(Nemesis):
    """Routes ops to child nemeses by f. Routing specs are either
    collections of fs (routed unchanged) or {outer-f: inner-f} mappings
    (translated). Accepts a dict (hashable keys) or an iterable of
    (routing, nemesis) pairs — plain sets/dicts work as routings in
    pair form, where hashability doesn't matter."""

    def __init__(self, nemeses):
        if isinstance(nemeses, dict):
            pairs = list(nemeses.items())
        else:
            pairs = [tuple(p) for p in nemeses]
        self.routes = [
            (dict(fs) if isinstance(fs, dict) else set(fs), nem)
            for fs, nem in pairs
        ]

    def _route(self, f):
        for fs, nem in self.routes:
            if isinstance(fs, dict):
                if f in fs:
                    return fs[f], nem
            elif f in fs:
                return f, nem
        return None

    def setup(self, test) -> "Compose":
        self.routes = [
            (fs, nem.setup(test)) for fs, nem in self.routes
        ]
        return self

    def invoke(self, test, op: Op) -> Op:
        hit = self._route(op.f)
        if hit is None:
            raise ValueError(f"no nemesis can handle f={op.f!r}")
        inner_f, nem = hit
        out = nem.invoke(test, op.with_(f=inner_f))
        return out.with_(f=op.f)

    def teardown(self, test) -> None:
        for _, nem in self.routes:
            nem.teardown(test)


def compose(nemeses) -> Compose:
    return Compose(nemeses)


# -- timeout wrapper (nemesis.clj:56-70) -------------------------------------


class Timeout(Nemesis):
    """Bounds a child nemesis's invoke; on timeout the op completes
    with value "timeout" (the child may still be running — exactly the
    reference's caveat)."""

    def __init__(self, timeout_s: float, nemesis: Nemesis):
        self.timeout_s = timeout_s
        self.nemesis = nemesis

    def setup(self, test) -> "Timeout":
        self.nemesis = self.nemesis.setup(test)
        return self

    def invoke(self, test, op: Op) -> Op:
        result: List[Op] = []
        err: List[BaseException] = []

        def work():
            try:
                result.append(self.nemesis.invoke(test, op))
            except BaseException as e:
                err.append(e)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(self.timeout_s)
        if result:
            return result[0]
        if err:
            raise err[0]
        return op.with_(type="info", value="timeout")

    def teardown(self, test) -> None:
        self.nemesis.teardown(test)


def timeout(timeout_s: float, nemesis: Nemesis) -> Timeout:
    return Timeout(timeout_s, nemesis)


# -- node targeting harness + process faults (nemesis.clj:236-295) -----------


class NodeStartStopper(Nemesis):
    """:start picks targets via targeter(nodes) and runs
    start_fn(test, node, session); :stop undoes via stop_fn on the
    remembered targets."""

    def __init__(self, targeter, start_fn, stop_fn):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self._nodes: Optional[List[str]] = None
        self._lock = threading.Lock()

    def invoke(self, test, op: Op) -> Op:
        from jepsen_tpu_torch.control.core import sessions_for

        with self._lock:
            if op.f == "start":
                targets = self.targeter(list(test["nodes"]))
                if targets is None:
                    return op.with_(type="info", value="no-target")
                if isinstance(targets, str):
                    targets = [targets]
                targets = list(targets)
                if self._nodes is not None:
                    return op.with_(
                        type="info",
                        value=f"nemesis already disrupting {self._nodes}",
                    )
                self._nodes = targets
                sess = sessions_for(test)
                value = {
                    n: self.start_fn(test, n, sess[n]) for n in targets
                }
                return op.with_(type="info", value=value)
            if op.f == "stop":
                if self._nodes is None:
                    return op.with_(type="info", value="not-started")
                sess = sessions_for(test)
                value = {
                    n: self.stop_fn(test, n, sess[n]) for n in self._nodes
                }
                self._nodes = None
                return op.with_(type="info", value=value)
        raise ValueError(f"can't handle f={op.f!r}")


def node_start_stopper(targeter, start_fn, stop_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def hammer_time(process: str, targeter=None,
                rng: Optional[_random.Random] = None) -> NodeStartStopper:
    """SIGSTOP a process on targeted nodes; SIGCONT on :stop
    (nemesis.clj:281-295)."""
    from jepsen_tpu_torch.control.util import signal_proc

    r = rng or _random
    targeter = targeter or (lambda nodes: r.choice(nodes))

    def start(test, node, sess):
        signal_proc(sess, process, "STOP")
        return ["paused", process]

    def stop(test, node, sess):
        signal_proc(sess, process, "CONT")
        return ["resumed", process]

    return NodeStartStopper(targeter, start, stop)


class TruncateFile(Nemesis):
    """Drop trailing bytes from files: op value is
    {node: {"file": path, "drop": n_bytes}} (nemesis.clj:297-323)."""

    def invoke(self, test, op: Op) -> Op:
        from jepsen_tpu_torch.control.core import sessions_for

        assert op.f == "truncate", op.f
        plan = op.value
        sess = sessions_for(test)
        for node, spec in plan.items():
            sess[node].exec(
                "truncate", "-c", "-s", f"-{int(spec['drop'])}",
                spec["file"], sudo=True,
            )
        return op.with_(type="info")


def truncate_file() -> TruncateFile:
    return TruncateFile()


class ClockScrambler(Nemesis):
    """Sets each node's clock to now +/- dt seconds
    (nemesis.clj:219-234); the C clock toolkit (resources/) gives finer
    bump/strobe control."""

    def __init__(self, dt_s: int, rng: Optional[_random.Random] = None):
        self.dt_s = dt_s
        self.rng = rng or _random

    def invoke(self, test, op: Op) -> Op:
        import time as _time

        from jepsen_tpu_torch.control.core import on_nodes

        def fn(node, sess):
            t = int(_time.time()) + self.rng.randint(-self.dt_s, self.dt_s)
            sess.exec("date", "+%s", "-s", f"@{t}", sudo=True)
            return t

        return op.with_(type="info", value=on_nodes(test, fn))

    def teardown(self, test) -> None:
        import time as _time

        from jepsen_tpu_torch.control.core import on_nodes

        def fn(node, sess):
            sess.exec(
                "date", "+%s", "-s", f"@{int(_time.time())}", sudo=True
            )

        on_nodes(test, fn)


def clock_scrambler(dt_s: int, rng=None) -> ClockScrambler:
    return ClockScrambler(dt_s, rng)
