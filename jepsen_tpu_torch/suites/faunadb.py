"""FaunaDB suite: topology-changing nemesis.

Reference: faunadb/ (3,678 LoC) — register / bank / g2 / set workloads
plus the reference's distinctive fault: a TOPOLOGY nemesis that grows
and shrinks the cluster mid-test
(faunadb/src/jepsen/faunadb/topology.clj): remove-node drains a member
out of the replica set, add-node joins it back. Here the nemesis
tracks active membership in the test map, drives the db's join/leave
commands in real mode, and in dummy mode journals the transitions —
either way clients keep running through the resize, which is the
point of the test."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

from jepsen_tpu_torch import nemesis as nemlib, net as netlib
from jepsen_tpu_torch.control.util import start_daemon, stop_daemon
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian

DIR = "/opt/faunadb"


class FaunaDB(DB):
    def setup(self, test, node, session):
        session.exec(
            "apt-get", "install", "-y", "faunadb", sudo=True,
            check=False,
        )
        conf = (
            f"auth_root_key: secret\\n"
            f"network_broadcast_address: {node}\\n"
            f"network_host_id: {node}\\n"
        )
        session.exec(
            "sh", "-c", f"printf '{conf}' > /etc/faunadb.yml",
            sudo=True,
        )
        start_daemon(
            session,
            "faunadb", "-c", "/etc/faunadb.yml",
            pidfile=f"{DIR}/faunadb.pid",
            logfile=f"{DIR}/faunadb.log",
        )
        if node != test["nodes"][0]:
            session.exec(
                "faunadb-admin", "join", test["nodes"][0],
                check=False,
            )

    def teardown(self, test, node, session):
        stop_daemon(session, f"{DIR}/faunadb.pid")

    def log_files(self, test, node):
        return [f"{DIR}/faunadb.log"]


class TopologyNemesis(nemlib.Nemesis):
    """Grow/shrink the cluster (topology.clj's role): remove-node
    drains a random non-primary member (faunadb-admin remove), add-node
    rejoins the most recently removed one. Membership is journaled in
    test["active_nodes"]; a majority is always preserved."""

    def __init__(self, rng=None):
        self.rng = rng or random.Random()
        self.removed: List[str] = []

    def setup(self, test):
        test.setdefault("active_nodes", list(test["nodes"]))
        return self

    def invoke(self, test, op: Op) -> Op:
        from jepsen_tpu_torch.control.core import sessions_for

        active = test.setdefault("active_nodes", list(test["nodes"]))
        if op.f == "remove-node":
            majority = len(test["nodes"]) // 2 + 1
            candidates = [
                n for n in active[1:]  # never the seed node
            ]
            if len(active) - 1 < majority or not candidates:
                return op.with_(type="info", value="at-minimum")
            node = self.rng.choice(candidates)
            active.remove(node)
            self.removed.append(node)
            if not test.get("dummy"):
                sess = sessions_for(test)[active[0]]
                sess.exec(
                    "faunadb-admin", "remove", node, check=False
                )
            return op.with_(type="info", value=["removed", node])
        if op.f == "add-node":
            if not self.removed:
                return op.with_(type="info", value="nothing-to-add")
            node = self.removed.pop()
            active.append(node)
            if not test.get("dummy"):
                sess = sessions_for(test)[node]
                sess.exec(
                    "faunadb-admin", "join", active[0], check=False
                )
            return op.with_(type="info", value=["added", node])
        raise ValueError(f"topology nemesis can't route {op.f!r}")

    def teardown(self, test):
        # rejoin everything so the next run starts whole
        while self.removed:
            test.setdefault(
                "active_nodes", list(test["nodes"])
            ).append(self.removed.pop())


def topology_generator(interval: float = 5.0):
    return gen.nemesis(gen.repeat(lambda: [
        gen.sleep(interval),
        gen.once({"f": "remove-node"}),
        gen.sleep(interval),
        gen.once({"f": "add-node"}),
    ]))


def _register_wl(opts):
    from jepsen_tpu_torch.workloads import register

    return register.keyed_workload(
        keys=range(opts.get("keys", 5)),
        per_key_ops=opts.get("per_key_ops", 40),
        rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _bank_wl(opts):
    from jepsen_tpu_torch.workloads import bank

    return bank.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _g2_wl(opts):
    from jepsen_tpu_torch.workloads import adya

    return adya.workload(
        n_keys=opts.get("keys", 20),
        serializable=not opts.get("weak", False),
        device=opts.get("device"),
    )


def _set_wl(opts):
    from jepsen_tpu_torch.workloads import set as set_wl

    return set_wl.workload(
        n_adds=opts.get("ops", 300), rng=opts.get("rng")
    )


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "register": _register_wl,
    "bank": _bank_wl,
    "g2": _g2_wl,
    "set": _set_wl,
}


def faunadb_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "register")
    topology = opts.pop("topology", True)
    interval = opts.pop("nemesis_interval", 5.0)
    time_limit_s = opts.pop("time_limit", None)

    spec = WORKLOADS[workload_name](opts)
    test: Dict[str, Any] = {
        "name": f"faunadb-{workload_name}",
        "os": Debian(),
        "db": FaunaDB(),
        "net": netlib.IptablesNet(),
        "nemesis": TopologyNemesis(rng=rng),
        "dummy": dummy,
        **spec,
    }
    if topology:
        test["generator"] = gen.any_gen(
            test["generator"], topology_generator(interval)
        )
    if time_limit_s:
        test["generator"] = gen.time_limit(
            time_limit_s, test["generator"]
        )
    if dummy:
        test.pop("os")
        test.pop("db")
        test["net"] = netlib.MemNet()
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.faunadb")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="register",
                   choices=sorted(WORKLOADS))
    p.add_argument("--ops", type=int, default=400)
    p.add_argument("--time-limit", type=float, default=30.0)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = faunadb_test({
        "device": device,
        "dummy": args.dummy,
        "workload": args.workload,
        "ops": args.ops,
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
