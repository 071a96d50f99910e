"""Hazelcast suite: coordination-primitive workloads in one file.

Reference: hazelcast/src/jepsen/hazelcast.clj (821 LoC, single file) —
a java daemon DB (install jar + start, :57-97), and a workload registry
(:652-712) over coordination primitives: lock (mutex model), queue
(total-queue conservation with a final drain), id-gen (unique-ids),
cas-long / map (cas register), plus CRDT map merges. BASELINE config 5
(long-fork at 256 keys x 500k ops) also belongs to this family.

Real mode: map-register and counter workloads speak the cluster's
memcache-compatible text endpoint (protocols/memcache.py — enabled on
the daemon line below), so their verdicts measure the actual cluster.
The CP-structure workloads (lock, queue, id-gen, cas) remain in-memory
models — the reference's clients for those are JVM-embedded handles
with no wire protocol a Python control host can speak
(hazelcast.clj:120-139), and the memcache endpoint cannot reach them;
each model has a `weak=True` mode reproducing the real system's
documented failure, so the checkers' catches are tested, not just the
happy paths.
"""

from __future__ import annotations

import itertools
import random
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from jepsen_tpu_torch import nemesis as nemlib, net as netlib
from jepsen_tpu_torch.checker import reductions
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.control.util import start_daemon, stop_daemon
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client

DIR = "/opt/hazelcast"
JAR = f"{DIR}/hazelcast-server.jar"
PIDFILE = f"{DIR}/server.pid"
LOGFILE = f"{DIR}/server.log"


class HazelcastDB(DB):
    """Install + run the server jar (hazelcast.clj:57-97)."""

    def setup(self, test, node, session):
        url = test.get(
            "server_url",
            "https://repo1.maven.org/maven2/com/hazelcast/"
            "hazelcast/3.12/hazelcast-3.12.jar",
        )
        session.exec("mkdir", "-p", DIR, sudo=True)
        session.exec("chmod", "777", DIR, sudo=True)
        session.exec("wget", "-nv", "-O", JAR, url)
        others = [n for n in test["nodes"] if n != node]
        start_daemon(
            session,
            "java",
            # Expose the memcache-compatible text endpoint on the
            # member port: the real-wire path for map-register and
            # counter workloads (protocols/memcache.py docstring).
            "-Dhazelcast.memcache.enabled=true",
            "-jar", JAR,
            "--members", ",".join(others),
            pidfile=PIDFILE,
            logfile=LOGFILE,
            chdir=DIR,
        )

    def teardown(self, test, node, session):
        stop_daemon(session, PIDFILE)
        session.exec("rm", "-rf", DIR, sudo=True, check=False)

    def log_files(self, test, node):
        return [LOGFILE]


# -- in-memory coordination primitives ---------------------------------------


class LockClient(Client):
    """Mutex over a shared lock (hazelcast.clj:412-448 lock-client).
    weak=True models two real failure modes of the no-quorum lock:

    - split-brain double-acquire: ~5% of contended acquires succeed
      anyway, and from that moment the partitioned cluster drops every
      release (sessions lost), so the double-hold can never be
      explained away by a concurrent release;
    - lost response: one release (the 7th) takes effect but is
      reported failed — the next acquire then double-grants a lock the
      history says was never released. This one fires independent of
      thread interleaving, so the checker's catch is deterministic
      even under a starved scheduler."""

    LOST_RELEASE_AT = 7

    def __init__(self, state=None, weak: bool = False, rng=None):
        self.state = state if state is not None else {
            "holder": None, "poisoned": False, "rel_count": 0,
            "lock": threading.Lock(),
        }
        self.weak = weak
        self.rng = rng or random.Random(0)

    def open(self, test, node):
        return LockClient(self.state, self.weak, self.rng)

    def invoke(self, test, op: Op) -> Op:
        st = self.state
        with st["lock"]:
            if op.f == "acquire":
                if st["holder"] is None and not st["poisoned"]:
                    st["holder"] = op.process
                    return op.with_(type="ok")
                if (
                    self.weak
                    and not st["poisoned"]
                    and self.rng.random() < 0.05
                ):
                    st["poisoned"] = True
                    return op.with_(type="ok")  # split-brain holder
                return op.with_(type="fail")
            if op.f == "release":
                if st["poisoned"]:
                    return op.with_(type="fail")  # lost session
                if st["holder"] == op.process:
                    st["holder"] = None
                    st["rel_count"] += 1
                    if self.weak and st["rel_count"] == \
                            self.LOST_RELEASE_AT:
                        return op.with_(type="fail")  # lost response
                    return op.with_(type="ok")
                return op.with_(type="fail")
        raise ValueError(f"unknown op f={op.f!r}")


class QueueClient(Client):
    """Shared queue (hazelcast.clj:270-296): enqueue/dequeue/drain.
    weak=True drops ~5% of acked enqueues — the lost-message anomaly
    total-queue exists to catch."""

    def __init__(self, q=None, weak: bool = False, rng=None):
        self.q = q if q is not None else deque()
        self.lock = threading.Lock()
        self.weak = weak
        self.rng = rng or random.Random(0)

    def open(self, test, node):
        c = QueueClient(self.q, self.weak, self.rng)
        c.lock = self.lock
        return c

    def invoke(self, test, op: Op) -> Op:
        with self.lock:
            if op.f == "enqueue":
                if not (self.weak and self.rng.random() < 0.05):
                    self.q.append(op.value)
                return op.with_(type="ok")
            if op.f == "dequeue":
                if self.q:
                    return op.with_(type="ok", value=self.q.popleft())
                return op.with_(type="fail")
            if op.f == "drain":
                out: List[Any] = []
                while self.q:
                    out.append(self.q.popleft())
                return op.with_(type="ok", value=out)
        raise ValueError(f"unknown op f={op.f!r}")


class IdGenClient(Client):
    """Cluster-wide id generator (hazelcast.clj:251-264): each
    generate returns a fresh id. weak=True re-issues ~2% of ids after
    a 'partition' — the duplicate unique-ids catches."""

    def __init__(self, state=None, weak: bool = False, rng=None):
        self.state = state if state is not None else {
            "n": 0, "lock": threading.Lock(),
        }
        self.weak = weak
        self.rng = rng or random.Random(0)

    def open(self, test, node):
        return IdGenClient(self.state, self.weak, self.rng)

    def invoke(self, test, op: Op) -> Op:
        st = self.state
        if op.f != "generate":
            raise ValueError(f"unknown op f={op.f!r}")
        with st["lock"]:
            if self.weak and st["n"] > 0 and self.rng.random() < 0.02:
                return op.with_(type="ok", value=st["n"])  # reissued
            st["n"] += 1
            return op.with_(type="ok", value=st["n"])


# -- workloads (hazelcast.clj:652-712) ---------------------------------------


def _lock_workload(opts):
    weak = opts.get("weak", False)
    ops = opts.get("ops", 200)
    return {
        "client": LockClient(weak=weak, rng=opts.get("rng")),
        "generator": gen.clients(gen.limit(
            ops,
            gen.each_thread(gen.repeat(lambda: [
                gen.once({"f": "acquire"}),
                gen.once({"f": "release"}),
            ])),
        )),
        "checker": LinearizableChecker(model="mutex",
                                       device=opts.get("device")),
    }


def _queue_workload(opts):
    weak = opts.get("weak", False)
    ops = opts.get("ops", 200)
    counter = itertools.count()
    rng = opts.get("rng") or random.Random(0)

    def enq():
        return {"f": "enqueue", "value": next(counter)}

    from jepsen_tpu_torch.checker.core import compose

    return {
        "client": QueueClient(weak=weak, rng=rng),
        "generator": gen.clients(gen.limit(
            ops, gen.mix([enq, {"f": "dequeue"}], rng=rng)
        )),
        # final drain on every thread (queue-client-and-gens) — outside
        # any time limit via the runtime's final_generator slot
        "final_generator": gen.clients(
            gen.each_thread(gen.once({"f": "drain"}))
        ),
        # conservation (checker.clj:570-629) AND full queue
        # linearizability — the latter decomposes by value onto the
        # device kernels (linearizable.split_queue_history_by_value)
        "checker": compose({
            "total-queue": reductions.total_queue(),
            "linearizable": LinearizableChecker(
                model="unordered-queue", device=opts.get("device")
            ),
        }),
    }


def _id_gen_workload(opts):
    weak = opts.get("weak", False)
    ops = opts.get("ops", 200)
    return {
        "client": IdGenClient(weak=weak, rng=opts.get("rng")),
        "generator": gen.clients(
            gen.limit(ops, {"f": "generate"})
        ),
        "checker": reductions.unique_ids(),
    }


def _cas_workload(opts):
    """The cas-long / map family: a linearizable cas register."""
    from jepsen_tpu_torch.workloads import register

    return register.workload(
        n_ops=opts.get("ops", 300), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _long_fork_workload(opts):
    from jepsen_tpu_torch.workloads import long_fork

    return long_fork.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _map_register_workload(opts):
    """Read-write register over an IMap entry. Real mode speaks the
    memcache text endpoint (no cas there — the cas workload keeps the
    in-memory model); dummy mode uses the in-memory register client
    with the same read/write-only mix."""
    from jepsen_tpu_torch.protocols.memcache import MemcacheRegisterClient
    from jepsen_tpu_torch.runtime import AtomClient

    ops = opts.get("ops", 300)
    rng = opts.get("rng") or random.Random(0)

    def write():
        return {"f": "write", "value": rng.randrange(5)}

    return {
        "client": AtomClient(),
        "real_client": MemcacheRegisterClient(),
        "generator": gen.clients(gen.limit(
            ops, gen.mix([write, {"f": "read"}], rng=rng)
        )),
        "checker": LinearizableChecker(model="register",
                                       device=opts.get("device")),
    }


def _counter_workload(opts):
    """Atomic counter (the reference's atomic-long role): in-memory in
    dummy mode, memcache incr/decr on the real wire."""
    from jepsen_tpu_torch.protocols.memcache import MemcacheCounterClient
    from jepsen_tpu_torch.workloads import counter

    wl = counter.workload(
        n_ops=opts.get("ops", 300),
        weak=opts.get("weak", False),
        rng=opts.get("rng"),
        device=opts.get("device"),
    )
    wl["real_client"] = MemcacheCounterClient()
    return wl


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "lock": _lock_workload,
    "queue": _queue_workload,
    "id-gen": _id_gen_workload,
    "cas": _cas_workload,
    "long-fork": _long_fork_workload,
    "map-register": _map_register_workload,
    "counter": _counter_workload,
}


def hazelcast_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "lock")
    time_limit_s = opts.pop("time_limit", None)
    use_nemesis = opts.pop("with_nemesis", False)
    interval = opts.pop("nemesis_interval", 5)

    spec = WORKLOADS[workload_name](opts)
    generator = spec["generator"]
    if use_nemesis:
        nemesis_gen = gen.nemesis(gen.repeat(lambda: [
            gen.sleep(interval),
            gen.once({"f": "start"}),
            gen.sleep(interval),
            gen.once({"f": "stop"}),
        ]))
        generator = gen.any_gen(generator, nemesis_gen)
    if time_limit_s:
        generator = gen.time_limit(time_limit_s, generator)

    test: Dict[str, Any] = {
        "name": f"hazelcast-{workload_name}",
        "os": Debian(),
        "db": HazelcastDB(),
        "client": spec["client"],
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_majorities_ring(rng=rng),
        "generator": generator,
        "checker": spec["checker"],
    }
    if spec.get("final_generator") is not None:
        test["final_generator"] = spec["final_generator"]
    if dummy:
        test.pop("os")
        test.pop("db")
        test["net"] = netlib.MemNet()
    elif spec.get("real_client") is not None:
        # Real wire: the memcache-compatible text endpoint
        # (protocols/memcache.py) carries map-register and counter
        # traffic to the actual cluster.
        test["client"] = spec["real_client"]
    else:
        # Real mode installs and cycles the actual Hazelcast cluster,
        # but THIS workload's client traffic is simulated: the
        # reference's lock/queue/id-gen/cas structures are JVM-embedded
        # handles with no wire protocol a Python control host can speak
        # (hazelcast.clj:120-139), and the memcache endpoint does not
        # reach them. Say so loudly — a run here exercises DB
        # automation + nemesis, not Hazelcast's own consistency.
        # map-register and counter DO run on the real wire.
        import logging

        logging.getLogger(__name__).warning(
            "hazelcast real mode: DB install/cycle and nemesis are "
            "real, but the %r workload's ops run against in-memory "
            "models (the memcache endpoint cannot reach embedded CP "
            "structures) — use map-register/counter for real-wire "
            "verdicts", workload_name,
        )
    opts.pop("rng", None)
    opts.pop("device", None)
    test.update(opts)
    return test


def main(argv=None) -> int:
    import argparse

    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.suites._backend import (
        EXIT_CRASH, add_backend_arg, backend_device, no_card,
    )

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.hazelcast")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="lock",
                   choices=sorted(WORKLOADS))
    p.add_argument("--time-limit", type=float, default=30.0)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = hazelcast_test({
        "device": device,
        "dummy": args.dummy,
        "workload": args.workload,
        "nodes": [n for n in args.nodes.split(",") if n],
        "time_limit": args.time_limit,
    })
    test["concurrency"] = args.concurrency
    test["store"] = args.store
    test = run(test)
    valid = test["results"].get("valid?")
    print(f"valid?={valid}")
    return 0 if valid is True else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
