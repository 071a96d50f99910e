"""Galera (MariaDB) suite: bank over synchronous replication.

Reference: galera/src/jepsen/galera.clj (529 LoC with dirty_reads) —
mariadb-galera apt install with debconf-seeded root password
(:35-60), a wsrep cluster-address bootstrap (first node
gcomm://, the rest join), and the bank workload over SQL
transactions; the companion dirty-reads workload reads mid-transaction
state.

Real mode drives mysqld through the mysql CLI on the nodes; dummy mode
uses the in-memory bank client. Checker: the columnar bank reduction.
"""

from __future__ import annotations

import random
import re
from typing import Any, Dict, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.control.core import sessions_for
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

PASSWORD = "jepsen"


class GaleraDB(DB):
    """mariadb-galera install + wsrep bootstrap (galera.clj:35-90)."""

    def setup(self, test, node, session):
        for line in (
            f"mariadb-galera-server-10.0 mysql-server/root_password "
            f"password {PASSWORD}",
            f"mariadb-galera-server-10.0 mysql-server/root_password_again "
            f"password {PASSWORD}",
        ):
            session.exec(
                "sh", "-c", f"echo '{line}' | debconf-set-selections",
                sudo=True,
            )
        session.exec(
            "apt-get", "install", "-y", "mariadb-galera-server",
            sudo=True,
        )
        primary = test["nodes"][0]
        peers = "" if node == primary else ",".join(test["nodes"])
        conf = (
            "[mysqld]\\n"
            "wsrep_on=ON\\n"
            "wsrep_provider=/usr/lib/galera/libgalera_smm.so\\n"
            f"wsrep_cluster_address=gcomm://{peers}\\n"
            "binlog_format=ROW\\n"
        )
        session.exec(
            "sh", "-c",
            f"printf '{conf}' > /etc/mysql/conf.d/galera.cnf",
            sudo=True,
        )
        if node == primary:
            session.exec(
                "service", "mysql", "restart", "--wsrep-new-cluster",
                sudo=True,
            )
        else:
            session.exec("service", "mysql", "restart", sudo=True)

    def teardown(self, test, node, session):
        session.exec("service", "mysql", "stop", sudo=True, check=False)

    def log_files(self, test, node):
        return ["/var/log/mysql.err", "/var/log/mysql.log"]


class GaleraBankClient(Client):
    """Bank over the mysql CLI (galera.clj's bank client role)."""

    def __init__(self, node=None, accounts=range(8), total: int = 100):
        self.node = node
        self.accounts = list(accounts)
        self.total = total

    def open(self, test, node):
        return GaleraBankClient(node, self.accounts, self.total)

    def _sql(self, test, stmt: str) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec(
            "mysql", "-h", self.node, "-u", "root",
            f"-p{PASSWORD}", "--batch", "--raw", "-e", stmt, "jepsen",
        )

    def setup(self, test):
        per = self.total // len(self.accounts)
        rows = ",".join(f"({a},{per})" for a in self.accounts)
        try:
            self._sql(
                test,
                "CREATE TABLE IF NOT EXISTS accounts "
                "(id INT PRIMARY KEY, balance BIGINT); "
                f"INSERT IGNORE INTO accounts VALUES {rows};",
            )
        except Exception:
            pass  # another worker's setup won the race

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                out = self._sql(
                    test, "SELECT id, balance FROM accounts;"
                )
                balances = {}
                for line in out.splitlines()[1:]:
                    parts = line.split("\t")
                    if len(parts) == 2:
                        balances[int(parts[0])] = int(parts[1])
                return op.with_(type="ok", value=balances)
            if op.f == "transfer":
                v = op.value
                amt, frm, to = (
                    int(v["amount"]), int(v["from"]), int(v["to"])
                )
                # SELECT ROW_COUNT() after the guarded credit reports
                # whether the second UPDATE applied; an insufficient
                # balance leaves both rows untouched and must return
                # :fail rather than record a phantom acked transfer.
                # Tag the applied-count row so detection keys on the
                # tag, not on "last non-empty line is a bare digit" —
                # CLI headers/decorations then can't silently turn an
                # applied transfer into :fail.
                out = self._sql(
                    test,
                    "BEGIN; "
                    f"UPDATE accounts SET balance = balance - {amt} "
                    f"WHERE id = {frm} AND balance >= {amt}; "
                    f"UPDATE accounts SET balance = balance + {amt} "
                    f"WHERE id = {to} AND ROW_COUNT() > 0; "
                    "SELECT CONCAT('applied=', ROW_COUNT()); COMMIT;",
                )
                m = re.search(r"applied=(-?\d+)", out)
                if m is None:
                    # No tagged row at all: the statement batch did
                    # not reach the SELECT — indeterminate (the debit
                    # may have committed), so a plain exception lets
                    # the worker record :info, NOT ClientFailed's
                    # definitely-did-not-happen :fail.
                    raise RuntimeError(
                        f"transfer result row missing in {out!r}"
                    )
                applied = int(m.group(1)) > 0
                return op.with_(type="ok" if applied else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


class GaleraDirtyReadsClient(Client):
    """Real-mode dirty-reads client (dirty_reads.clj:28-67): writers
    set every row in one serializable transaction via the mysql CLI;
    readers select all rows."""

    def __init__(self, node=None, n_rows: int = 8):
        self.node = node
        self.n_rows = n_rows

    def open(self, test, node):
        return GaleraDirtyReadsClient(node, self.n_rows)

    def _sql(self, test, stmt: str) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec(
            "mysql", "-h", self.node, "-u", "root",
            f"-p{PASSWORD}", "--batch", "--raw", "-e", stmt, "jepsen",
        )

    def setup(self, test):
        rows = ",".join(f"({i},-1)" for i in range(self.n_rows))
        try:
            self._sql(
                test,
                "CREATE TABLE IF NOT EXISTS dirty "
                "(id INT PRIMARY KEY, x BIGINT NOT NULL); "
                f"INSERT IGNORE INTO dirty VALUES {rows};",
            )
        except Exception:
            pass  # another worker's setup won the race

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                out = self._sql(test, "SELECT x FROM dirty ORDER BY id;")
                vals = [
                    int(line) for line in out.splitlines()[1:]
                    if line.strip()
                ]
                return op.with_(type="ok", value=vals)
            if op.f == "write":
                self._sql(
                    test,
                    "SET SESSION TRANSACTION ISOLATION LEVEL "
                    "SERIALIZABLE; BEGIN; "
                    f"UPDATE dirty SET x = {int(op.value)}; COMMIT;",
                )
                return op.with_(type="ok")
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


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


WORKLOADS = {
    "bank": _bank_workload,
    "dirty-reads": _dirty_reads_workload,
}

#: real-mode SQL clients per workload (dummy mode keeps the workload's
#: in-memory client)
REAL_CLIENTS = {
    "bank": GaleraBankClient,
    "dirty-reads": GaleraDirtyReadsClient,
}


def galera_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    time_limit_s = opts.pop("time_limit", None)
    workload_name = opts.pop("workload", "bank")

    spec = WORKLOADS[workload_name](opts)
    generator = spec["generator"]
    if time_limit_s:
        generator = gen.time_limit(time_limit_s, generator)
    test: Dict[str, Any] = {
        "name": f"galera-{workload_name}",
        "os": Debian(),
        "db": GaleraDB(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        **spec,
        "generator": generator,
    }
    if not dummy:
        test["client"] = REAL_CLIENTS[workload_name]()
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.galera")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="bank",
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
    test = galera_test({
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
