"""Aerospike suite: cas-register / counter / set with a pause nemesis.

Reference: aerospike/ (1,286 LoC) — asd daemon automation, cas-register
/ counter / set workloads, and the SIGSTOP pause nemesis
(aerospike.clj's hammer-time usage). The reference also ships a TLA+
spec of cluster membership (aerospike/spec/aerospike.tla:1-28) — a
design artifact with no runtime role; its analog here is the WGL
engine's machine-checked-by-differential-testing models
(checker/models.py + the oracle parity suites)."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional

from jepsen_tpu_torch import nemesis as nemlib, net as netlib
from jepsen_tpu_torch.control.util import start_daemon, stop_daemon
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.os import Debian

DIR = "/opt/aerospike"


class AerospikeDB(DB):
    def setup(self, test, node, session):
        session.exec(
            "apt-get", "install", "-y", "aerospike-server-community",
            "aerospike-tools", sudo=True, check=False,
        )
        mesh = "\\n".join(
            f"mesh-seed-address-port {n} 3002" for n in test["nodes"]
        )
        conf = (
            "service { paxos-single-replica-limit 1 }\\n"
            "network { heartbeat { mode mesh\\n"
            f"{mesh}\\n"
            "} }\\n"
            "namespace jepsen { replication-factor 3\\n"
            "storage-engine memory }\\n"
        )
        session.exec(
            "sh", "-c",
            f"printf '{conf}' > /etc/aerospike/aerospike.conf",
            sudo=True,
        )
        start_daemon(
            session,
            "asd", "--config-file", "/etc/aerospike/aerospike.conf",
            "--foreground",
            pidfile=f"{DIR}/asd.pid",
            logfile=f"{DIR}/asd.log",
        )

    def teardown(self, test, node, session):
        stop_daemon(session, f"{DIR}/asd.pid")

    def log_files(self, test, node):
        return [f"{DIR}/asd.log"]


def _cas_wl(opts):
    from jepsen_tpu_torch.workloads import register

    return register.workload(
        n_ops=opts.get("ops", 300), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _counter_wl(opts):
    from jepsen_tpu_torch.workloads import counter

    return counter.workload(
        n_ops=opts.get("ops", 300),
        weak=opts.get("weak", False),
        rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _set_wl(opts):
    from jepsen_tpu_torch.workloads import set as set_wl

    return set_wl.workload(
        n_adds=opts.get("ops", 300), rng=opts.get("rng")
    )


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "cas-register": _cas_wl,
    "counter": _counter_wl,
    "set": _set_wl,
}


def aerospike_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "cas-register")
    with_pause = opts.pop("pause_nemesis", False)
    interval = opts.pop("nemesis_interval", 5)
    time_limit_s = opts.pop("time_limit", None)

    spec = WORKLOADS[workload_name](opts)
    test: Dict[str, Any] = {
        "name": f"aerospike-{workload_name}",
        "os": Debian(),
        "db": AerospikeDB(),
        "net": netlib.IptablesNet(),
        # the suite's signature fault: SIGSTOP the server
        # (aerospike.clj's pause nemesis over hammer-time)
        "nemesis": nemlib.hammer_time("asd"),
        **spec,
    }
    if with_pause:
        test["generator"] = gen.any_gen(
            test["generator"],
            gen.nemesis(gen.repeat(lambda: [
                gen.sleep(interval),
                gen.once({"f": "start"}),
                gen.sleep(interval),
                gen.once({"f": "stop"}),
            ])),
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.aerospike")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="cas-register",
                   choices=sorted(WORKLOADS))
    p.add_argument("--ops", type=int, default=300)
    p.add_argument("--time-limit", type=float, default=30.0)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = aerospike_test({
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
