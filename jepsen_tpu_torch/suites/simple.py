"""The remaining single-file reference suites, as a declarative
registry.

Reference pattern (SURVEY.md §2.5): raftis (158 LoC), disque (339),
logcabin (300), robustirc (239), rethinkdb (572), ignite (514),
mysql-cluster (241), postgres-rds (317), mongodb-smartos (824) are all
variations of one shape — install/start commands + a register/queue/
bank client + `cli/run!`. This module keeps that shape honest while
collapsing the boilerplate: each entry carries its database's REAL
install/start/stop command recipe (cited to the reference file), its
workload, and its os/net flavor; `make_test` assembles the canonical
test map, and every suite still gets a first-class
`python -m jepsen_tpu_torch.suites.simple --suite <name>` entry point.

Every suite's real mode now speaks the database's ACTUAL protocol via
`protocols/` (the reference's own discipline — each of its suites
drives a real driver): RESP for raftis/disque, TreeOps-over-session
for logcabin, the V0_4/JSON wire protocol for rethinkdb, the binary
thin-client protocol for ignite, robustsession HTTP/JSON for
robustirc, mysql/psql CLI batches for mysql-cluster/postgres-rds, and
OP_QUERY+BSON for mongodb-smartos. Dummy mode plugs the in-memory
clients in, as everywhere else.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.control.util import (
    install_archive,
    start_daemon,
    stop_daemon,
)
from jepsen_tpu_torch.protocols.clients import (
    DisqueQueueClient,
    RespRegisterClient,
)
from jepsen_tpu_torch.protocols.ignite import IgniteRegisterClient
from jepsen_tpu_torch.protocols.logcabin import LogCabinRegisterClient
from jepsen_tpu_torch.protocols.mongo import MongoRegisterClient
from jepsen_tpu_torch.protocols.robustirc import RobustIrcLogClient
from jepsen_tpu_torch.protocols.rethinkdb import RethinkRegisterClient
from jepsen_tpu_torch.protocols.sqlcli import (
    MysqlCliBankClient,
    PsqlBankClient,
)
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.os import OS, Debian, SmartOS
from jepsen_tpu_torch.runtime.client import Client


class RecipeDB(DB):
    """DB automation from a declarative recipe: setup/teardown are
    lists of argv lists (strings interpolate {node}, {nodes},
    {primary}, {quorum}); daemons are (argv, pidfile, logfile)."""

    def __init__(self, setup_cmds=(), daemons=(), teardown_cmds=(),
                 logs=()):
        self.setup_cmds = setup_cmds
        self.daemons = daemons
        self.teardown_cmds = teardown_cmds
        self.logs = list(logs)

    @staticmethod
    def _fmt(arg: str, test, node: str) -> str:
        nodes = test["nodes"]
        return arg.format(
            node=node,
            nodes=",".join(nodes),
            primary=nodes[0],
            quorum=len(nodes) // 2 + 1,
        )

    def setup(self, test, node, session):
        for cmd in self.setup_cmds:
            session.exec(
                *[self._fmt(a, test, node) for a in cmd],
                sudo=True, check=False,
            )
        for argv, pidfile, logfile in self.daemons:
            start_daemon(
                session,
                *[self._fmt(a, test, node) for a in argv],
                pidfile=pidfile,
                logfile=logfile,
            )

    def teardown(self, test, node, session):
        for _, pidfile, _ in reversed(self.daemons):
            stop_daemon(session, pidfile)
        for cmd in self.teardown_cmds:
            session.exec(
                *[self._fmt(a, test, node) for a in cmd],
                sudo=True, check=False,
            )

    def log_files(self, test, node):
        return list(self.logs)


def _register_wl(opts):
    from jepsen_tpu_torch.workloads import register

    return register.workload(
        n_ops=opts.get("ops", 300), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _bank_wl(opts):
    from jepsen_tpu_torch.workloads import bank

    return bank.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _queue_wl(opts):
    from jepsen_tpu_torch.suites.hazelcast import _queue_workload

    return _queue_workload(opts)


def _set_wl(opts):
    from jepsen_tpu_torch.workloads import set as set_wl

    return set_wl.workload(
        n_adds=opts.get("ops", 300), rng=opts.get("rng")
    )


#: suite registry: name -> {db: RecipeDB, workloads: {name: factory},
#: os/net overrides, ref: reference citation}
SUITES: Dict[str, Dict[str, Any]] = {
    # redis + raft: register over redis-cli (raftis.clj:1-158)
    "raftis": {
        "ref": "raftis/src/jepsen/raftis.clj",
        # Real mode speaks RESP to redis directly (protocols/clients).
        "clients": {
            "register": lambda opts: RespRegisterClient(port=6379),
        },
        "db": RecipeDB(
            setup_cmds=[
                ["apt-get", "install", "-y", "redis-server"],
            ],
            daemons=[
                (["redis-server", "--port", "6379",
                  "--appendonly", "yes"],
                 "/opt/raftis/redis.pid", "/opt/raftis/redis.log"),
            ],
            logs=["/opt/raftis/redis.log"],
        ),
        "workloads": {"register": _register_wl},
    },
    # disque: build from source, queue semantics (disque.clj:40-90)
    "disque": {
        "ref": "disque/src/jepsen/disque.clj",
        # Real mode speaks disque's RESP commands (ADDJOB/GETJOB/ACKJOB).
        "clients": {
            "queue": lambda opts: DisqueQueueClient(port=7711),
        },
        "db": RecipeDB(
            setup_cmds=[
                ["apt-get", "install", "-y", "git", "build-essential"],
                ["sh", "-c",
                 "test -d /opt/disque || git clone "
                 "https://github.com/antirez/disque.git /opt/disque"],
                ["make", "-C", "/opt/disque"],
            ],
            daemons=[
                (["/opt/disque/src/disque-server", "--port", "7711"],
                 "/opt/disque/disque.pid", "/opt/disque/disque.log"),
            ],
            logs=["/opt/disque/disque.log"],
        ),
        "workloads": {"queue": _queue_wl},
    },
    # logcabin: raft consensus store built with scons
    # (logcabin.clj:23-60)
    "logcabin": {
        "ref": "logcabin/src/jepsen/logcabin.clj",
        # Real mode drives the TreeOps CLI on the node — the
        # reference's client IS that binary (logcabin.clj:163-244).
        "clients": {
            "register": lambda opts: LogCabinRegisterClient(),
        },
        "db": RecipeDB(
            setup_cmds=[
                ["apt-get", "install", "-y", "git-core", "scons",
                 "g++", "protobuf-compiler"],
                ["sh", "-c",
                 "test -d /opt/logcabin || git clone --depth 1 "
                 "https://github.com/logcabin/logcabin.git "
                 "/opt/logcabin"],
                ["sh", "-c", "cd /opt/logcabin && scons"],
            ],
            daemons=[
                (["/opt/logcabin/build/LogCabin",
                  "--config", "/opt/logcabin/logcabin.conf"],
                 "/opt/logcabin/logcabin.pid",
                 "/opt/logcabin/logcabin.log"),
            ],
            logs=["/opt/logcabin/logcabin.log"],
        ),
        "workloads": {"register": _register_wl},
    },
    # robustirc: go IRC network with raft (robustirc.clj)
    "robustirc": {
        "ref": "robustirc/src/jepsen/robustirc.clj",
        # Real mode speaks the robustsession HTTP/JSON API
        # (protocols/robustirc.py; robustirc.clj:102-135). Set
        # semantics: an IRC channel is a pub/sub log, so acked posts
        # must all appear in the final read.
        "clients": {
            "set": lambda opts: RobustIrcLogClient(),
        },
        "db": RecipeDB(
            setup_cmds=[
                ["sh", "-c",
                 "test -f /opt/robustirc/robustirc || (mkdir -p "
                 "/opt/robustirc && wget -nv -O "
                 "/opt/robustirc/robustirc https://robustirc.net/"
                 "robustirc && chmod +x /opt/robustirc/robustirc)"],
            ],
            daemons=[
                (["/opt/robustirc/robustirc",
                  "-network_name", "jepsen",
                  "-peer_addr", "{node}:13001",
                  "-join", "{primary}:13001"],
                 "/opt/robustirc/robustirc.pid",
                 "/opt/robustirc/robustirc.log"),
            ],
            logs=["/opt/robustirc/robustirc.log"],
        ),
        "workloads": {"set": _set_wl},
    },
    # rethinkdb: apt repo + document-cas (rethinkdb.clj:52-80)
    "rethinkdb": {
        "ref": "rethinkdb/src/jepsen/rethinkdb.clj",
        # Real mode speaks the V0_4/JSON wire protocol directly
        # (protocols/rethinkdb.py; document_cas.clj:72-105 semantics).
        "clients": {
            "register": lambda opts: RethinkRegisterClient(),
        },
        "db": RecipeDB(
            setup_cmds=[
                ["sh", "-c",
                 "wget -qO - https://download.rethinkdb.com/apt/"
                 "pubkey.gpg | apt-key add -"],
                ["apt-get", "install", "-y", "rethinkdb"],
            ],
            daemons=[
                (["rethinkdb", "--bind", "all",
                  "--server-name", "{node}",
                  "--join", "{primary}:29015"],
                 "/opt/rethinkdb/rethinkdb.pid",
                 "/opt/rethinkdb/rethinkdb.log"),
            ],
            logs=["/opt/rethinkdb/rethinkdb.log"],
        ),
        "workloads": {"register": _register_wl},
    },
    # ignite: in-memory data grid, register + bank (ignite/*.clj)
    "ignite": {
        "ref": "ignite/src/jepsen/ignite.clj",
        # Real mode speaks the binary thin-client protocol on :10800
        # (protocols/ignite.py) — register only; the bank workload
        # still borrows the generic client (no SQL front end here).
        "clients": {
            "register": lambda opts: IgniteRegisterClient(),
        },
        "db": RecipeDB(
            setup_cmds=[
                ["sh", "-c",
                 "test -d /opt/ignite || (mkdir -p /opt/ignite && "
                 "wget -nv -O /tmp/ignite.zip https://archive.apache"
                 ".org/dist/ignite/2.7.0/apache-ignite-2.7.0-bin.zip "
                 "&& unzip -q /tmp/ignite.zip -d /opt/ignite)"],
            ],
            daemons=[
                (["sh", "-c",
                  "IGNITE_HOME=/opt/ignite /opt/ignite/bin/ignite.sh"],
                 "/opt/ignite/ignite.pid", "/opt/ignite/ignite.log"),
            ],
            logs=["/opt/ignite/ignite.log"],
        ),
        "workloads": {"register": _register_wl, "bank": _bank_wl},
    },
    # mysql-cluster: ndb management + data + sql nodes
    # (mysql_cluster.clj)
    "mysql-cluster": {
        "ref": "mysql-cluster/src/jepsen/mysql_cluster.clj",
        # Real mode runs the bank as atomic mysql-CLI batches against
        # the NDB SQL front end (protocols/sqlcli.py).
        "clients": {
            "bank": lambda opts: MysqlCliBankClient(),
        },
        "db": RecipeDB(
            setup_cmds=[
                ["apt-get", "install", "-y", "mysql-cluster-community-"
                 "management-server", "mysql-cluster-community-data-"
                 "node", "mysql-cluster-community-server"],
            ],
            daemons=[
                (["ndb_mgmd", "-f", "/var/lib/mysql-cluster/"
                  "config.ini", "--nodaemon"],
                 "/opt/mysql-cluster/ndb_mgmd.pid",
                 "/opt/mysql-cluster/ndb_mgmd.log"),
                (["ndbd", "--nodaemon"],
                 "/opt/mysql-cluster/ndbd.pid",
                 "/opt/mysql-cluster/ndbd.log"),
                (["mysqld"],
                 "/opt/mysql-cluster/mysqld.pid",
                 "/opt/mysql-cluster/mysqld.log"),
            ],
            logs=["/opt/mysql-cluster/mysqld.log"],
        ),
        "workloads": {"bank": _bank_wl},
    },
    # postgres-rds: managed AWS instance — NO node automation; the
    # suite tests an endpoint (postgres_rds.clj: os/db are noops)
    "postgres-rds": {
        "ref": "postgres-rds/src/jepsen/postgres_rds.clj",
        "db": None,
        "os": None,
        # Real mode dials the managed endpoint from the control host
        # via psql (the reference's conn-spec role) — pass
        # rds_endpoint in opts.
        "clients": {
            "bank": lambda opts: PsqlBankClient(
                endpoint=opts.get("rds_endpoint")
            ),
        },
        "workloads": {"bank": _bank_wl},
    },
    # mongodb-smartos: the SmartOS/ipfilter port of the mongo suite
    # (mongodb_smartos/core.clj; net.clj:111-143)
    "mongodb-smartos": {
        "ref": "mongodb-smartos/src/jepsen/mongodb_smartos/core.clj",
        "db": RecipeDB(
            setup_cmds=[
                ["pkgin", "-y", "install", "mongodb"],
            ],
            daemons=[
                (["mongod", "--replSet", "jepsen",
                  "--bind_ip_all"],
                 "/opt/mongo/mongod.pid", "/opt/mongo/mongod.log"),
            ],
            logs=["/opt/mongo/mongod.log"],
        ),
        "os": SmartOS(),
        "net": netlib.IpfilterNet(),
        # Real mode speaks the mongo wire protocol (OP_QUERY command
        # path + BSON, protocols/mongo.py) for document-cas.
        "clients": {
            "document-cas": lambda opts: MongoRegisterClient(),
        },
        "workloads": {
            "document-cas": _register_wl,
            "transfer": _bank_wl,
        },
    },
}


def make_test(
    suite: str, opts: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    opts = dict(opts or {})
    entry = SUITES[suite]
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    names = sorted(entry["workloads"])
    workload_name = opts.pop("workload", names[0])
    spec = entry["workloads"][workload_name](opts)

    test: Dict[str, Any] = {
        "name": f"{suite}-{workload_name}",
        "net": entry.get("net", netlib.IptablesNet()),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        **spec,
    }
    os_impl = entry.get("os", Debian())
    if os_impl is not None:
        test["os"] = os_impl
    if entry.get("db") is not None:
        test["db"] = entry["db"]
    if dummy:
        test.pop("os", None)
        test.pop("db", None)
        test["net"] = netlib.MemNet()
    else:
        # Real mode: suites that declare a wire-protocol client for
        # this workload use it instead of the generic in-memory one
        # (the rethinkdb/disque discipline — their reference clients
        # speak the actual protocol from the control node).
        factory = entry.get("clients", {}).get(workload_name)
        if factory is not None:
            test["client"] = factory(opts)
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.simple")
    p.add_argument("--suite", required=True, choices=sorted(SUITES))
    p.add_argument("--workload", default=None)
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--ops", type=int, default=300)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    opts = {
        "device": device,
        "dummy": args.dummy,
        "ops": args.ops,
        "nodes": [n for n in args.nodes.split(",") if n],
    }
    if args.workload:
        opts["workload"] = args.workload
    test = make_test(args.suite, opts)
    test["concurrency"] = args.concurrency
    test["store"] = args.store
    test = run(test)
    valid = test["results"].get("valid?")
    print(f"valid?={valid}")
    return 0 if valid is True else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
