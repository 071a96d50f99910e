"""Percona XtraDB Cluster suite: bank + dirty-reads over MySQL.

Reference: percona/ (509 LoC) — the galera-family sibling: the same
wsrep synchronous-replication stack under Percona packaging, tested
with the bank workload (snapshot-isolation total conservation) and
the dirty-reads workload (galera/src/jepsen/galera/dirty_reads.clj's
shape, shared here via workloads/dirty_reads.py).

Real mode reuses the galera SQL client (Percona speaks the same
protocol on :3306); dummy mode uses the in-memory clients."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.suites.galera import PASSWORD, GaleraBankClient

DIR = "/var/lib/mysql"


class PerconaDB(DB):
    """percona-xtradb-cluster install + wsrep bootstrap (the galera
    recipe under Percona packaging)."""

    def setup(self, test, node, session):
        for line in (
            f"percona-xtradb-cluster-server mysql-server/root_password "
            f"password {PASSWORD}",
            f"percona-xtradb-cluster-server "
            f"mysql-server/root_password_again password {PASSWORD}",
        ):
            session.exec(
                "sh", "-c", f"echo '{line}' | debconf-set-selections",
                sudo=True,
            )
        session.exec(
            "apt-get", "install", "-y",
            "percona-xtradb-cluster-server", sudo=True,
        )
        primary = test["nodes"][0]
        peers = "" if node == primary else ",".join(test["nodes"])
        conf = (
            "[mysqld]\\n"
            "wsrep_on=ON\\n"
            "wsrep_provider=/usr/lib/galera3/libgalera_smm.so\\n"
            f"wsrep_cluster_address=gcomm://{peers}\\n"
            "binlog_format=ROW\\n"
            "pxc_strict_mode=ENFORCING\\n"
        )
        session.exec(
            "sh", "-c",
            f"printf '{conf}' > /etc/mysql/conf.d/wsrep.cnf",
            sudo=True,
        )
        if node == primary:
            session.exec(
                "service", "mysql", "bootstrap-pxc", sudo=True
            )
        else:
            session.exec("service", "mysql", "restart", sudo=True)

    def teardown(self, test, node, session):
        session.exec("service", "mysql", "stop", sudo=True, check=False)

    def log_files(self, test, node):
        return ["/var/log/mysql.err", "/var/log/mysql.log"]


def _bank_workload(opts):
    from jepsen_tpu_torch.workloads import bank

    return bank.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _dirty_reads_workload(opts):
    from jepsen_tpu_torch.workloads import dirty_reads

    return dirty_reads.workload(
        n_ops=opts.get("ops", 200),
        weak=opts.get("weak", False),
        rng=opts.get("rng"),
    )


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "bank": _bank_workload,
    "dirty-reads": _dirty_reads_workload,
}


def percona_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "bank")

    spec = WORKLOADS[workload_name](opts)
    test: Dict[str, Any] = {
        "name": f"percona-{workload_name}",
        "os": Debian(),
        "db": PerconaDB(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        **spec,
    }
    if not dummy:
        # Percona speaks the same SQL on :3306 — reuse the galera
        # clients for both workloads (the suite docstring's promise)
        from jepsen_tpu_torch.suites.galera import GaleraDirtyReadsClient

        test["client"] = (
            GaleraBankClient()
            if workload_name == "bank"
            else GaleraDirtyReadsClient()
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.percona")
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
    test = percona_test({
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
