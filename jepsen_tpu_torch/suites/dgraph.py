"""Dgraph suite: alpha/zero components with per-op tracing.

Reference: dgraph/ (2,444 LoC) — a zero (cluster coordinator) + alpha
(data) component cluster and the reference's one distinctive aux
plane: OpenCensus spans around every client op exported to Jaeger
(dgraph/src/jepsen/dgraph/trace.clj:26-73). Here the span plane is
utils/tracing.TraceClient — one span per op into
<run_dir>/trace.jsonl (browsable from the web dashboard).

Workloads: bank / set / long-fork / linearizable register (the
reference's delete/upsert/types workloads reduce to these checker
families)."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional

from jepsen_tpu_torch import nemesis as nemlib, net as netlib
from jepsen_tpu_torch.control.util import (
    install_archive,
    start_daemon,
    stop_daemon,
)
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.core import synchronize
from jepsen_tpu_torch.utils.tracing import traced

DIR = "/opt/dgraph"
TARBALL = (
    "https://github.com/dgraph-io/dgraph/releases/download/"
    "v1.0.11/dgraph-linux-amd64.tar.gz"
)


class DgraphDB(DB):
    """zero quorum first, barrier, then alphas (dgraph's db role)."""

    def setup(self, test, node, session):
        install_archive(session, test.get("tarball", TARBALL), DIR)
        nodes = test["nodes"]
        idx = nodes.index(node) + 1
        start_daemon(
            session,
            f"{DIR}/dgraph", "zero",
            f"--my={node}:5080",
            f"--idx={idx}",
            f"--replicas={len(nodes)}",
            *(
                [f"--peer={nodes[0]}:5080"]
                if node != nodes[0]
                else []
            ),
            pidfile=f"{DIR}/zero.pid",
            logfile=f"{DIR}/zero.log",
            chdir=DIR,
        )
        synchronize(test)  # zero group up before alphas join
        start_daemon(
            session,
            f"{DIR}/dgraph", "alpha",
            f"--my={node}:7080",
            f"--zero={nodes[0]}:5080",
            pidfile=f"{DIR}/alpha.pid",
            logfile=f"{DIR}/alpha.log",
            chdir=DIR,
        )

    def teardown(self, test, node, session):
        stop_daemon(session, f"{DIR}/alpha.pid")
        stop_daemon(session, f"{DIR}/zero.pid")
        session.exec("rm", "-rf", f"{DIR}/p", f"{DIR}/w", f"{DIR}/zw",
                     sudo=True, check=False)

    def log_files(self, test, node):
        return [f"{DIR}/zero.log", f"{DIR}/alpha.log"]


def _bank_wl(opts):
    from jepsen_tpu_torch.workloads import bank

    return bank.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _set_wl(opts):
    from jepsen_tpu_torch.workloads import set as set_wl

    return set_wl.workload(
        n_adds=opts.get("ops", 300), rng=opts.get("rng")
    )


def _long_fork_wl(opts):
    from jepsen_tpu_torch.workloads import long_fork

    return long_fork.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _register_wl(opts):
    from jepsen_tpu_torch.workloads import register

    return register.keyed_workload(
        keys=range(opts.get("keys", 5)),
        per_key_ops=opts.get("per_key_ops", 50),
        rng=opts.get("rng"),
        device=opts.get("device"),
    )


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "bank": _bank_wl,
    "set": _set_wl,
    "long-fork": _long_fork_wl,
    "register": _register_wl,
}


def dgraph_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "bank")
    trace = opts.pop("trace", True)

    spec = WORKLOADS[workload_name](opts)
    test: Dict[str, Any] = {
        "name": f"dgraph-{workload_name}",
        "os": Debian(),
        "db": DgraphDB(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        **spec,
    }
    if trace:
        # the suite's signature aux plane (trace.clj): spans per op
        test["client"] = traced(test["client"], f"dgraph-{workload_name}")
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.dgraph")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="bank",
                   choices=sorted(WORKLOADS))
    p.add_argument("--ops", type=int, default=400)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = dgraph_test({
        "device": device,
        "dummy": args.dummy,
        "workload": args.workload,
        "ops": args.ops,
        "nodes": [n for n in args.nodes.split(",") if n],
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
