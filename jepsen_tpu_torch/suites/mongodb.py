"""MongoDB suite: document CAS against a replica set.

Reference: mongodb-rocks/src/jepsen/mongodb_rocks.clj (187 LoC) and the
mongodb-smartos document-cas workload — a replica-set DB (install,
rs.initiate with member list, wait for primary), and a document-cas
client doing findAndModify conditioned on the current value, with reads
allowed at configurable read concern.

Real mode drives mongod through the `mongo` shell's --eval on the
nodes; dummy mode uses the in-memory register. Checker: the
linearizability engine over the cas-register model.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.control.core import sessions_for
from jepsen_tpu_torch.control.util import start_daemon, stop_daemon
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed
from jepsen_tpu_torch.runtime.core import synchronize

DIR = "/opt/mongo"
PIDFILE = f"{DIR}/mongod.pid"
LOGFILE = f"{DIR}/mongod.log"


class MongoDB(DB):
    """mongod + replica-set init (mongodb_rocks.clj's db role)."""

    def setup(self, test, node, session):
        session.exec("mkdir", "-p", f"{DIR}/data", sudo=True)
        session.exec("chmod", "-R", "777", DIR, sudo=True)
        start_daemon(
            session,
            "mongod",
            "--replSet", "jepsen",
            "--dbpath", f"{DIR}/data",
            "--bind_ip_all",
            pidfile=PIDFILE,
            logfile=LOGFILE,
        )
        synchronize(test)  # all mongods up before rs.initiate
        if node == test["nodes"][0]:
            members = [
                {"_id": i, "host": f"{n}:27017"}
                for i, n in enumerate(test["nodes"])
            ]
            session.exec(
                "mongo", "--quiet", "--eval",
                f"rs.initiate({json.dumps({'_id': 'jepsen', 'members': members})})",
            )

    def teardown(self, test, node, session):
        stop_daemon(session, PIDFILE)
        session.exec("rm", "-rf", f"{DIR}/data", sudo=True, check=False)

    def log_files(self, test, node):
        return [LOGFILE]


class DocumentCasClient(Client):
    """Document CAS via the mongo shell (document-cas workload role):
    read = findOne, write = unconditional update, cas = findAndModify
    gated on the old value. Reads crash to :fail, writes/cas to :info
    unless the shell reports a definite no-match (-> :fail)."""

    def __init__(self, node: Optional[str] = None, doc_id: int = 0):
        self.node = node
        self.doc_id = doc_id

    def open(self, test, node):
        return DocumentCasClient(node, self.doc_id)

    def _eval(self, test, js: str) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec(
            "mongo", "--quiet", "jepsen", "--eval", js
        ).strip()

    def invoke(self, test, op: Op) -> Op:
        q = f'{{_id: {self.doc_id}}}'
        try:
            if op.f == "read":
                out = self._eval(
                    test,
                    f"var d = db.cas.findOne({q}); "
                    "print(d === null ? 'null' : d.value)",
                )
                val = None if out in ("null", "") else int(out)
                return op.with_(type="ok", value=val)
            if op.f == "write":
                self._eval(
                    test,
                    f"db.cas.update({q}, {{_id: {self.doc_id}, "
                    f"value: {int(op.value)}}}, {{upsert: true}})",
                )
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                out = self._eval(
                    test,
                    "var r = db.cas.findAndModify({query: "
                    f"{{_id: {self.doc_id}, value: {int(old)}}}, "
                    f"update: {{$set: {{value: {int(new)}}}}}}}); "
                    "print(r === null ? 'miss' : 'hit')",
                )
                return op.with_(type="ok" if out == "hit" else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


def mongodb_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    dummy = opts.pop("dummy", False)
    device = opts.pop("device", None)
    n_ops = opts.pop("ops", 300)
    time_limit_s = opts.pop("time_limit", None)

    from jepsen_tpu_torch.workloads.register import op_mix

    generator = gen.clients(gen.limit(n_ops, op_mix(rng)))
    if time_limit_s:
        generator = gen.time_limit(time_limit_s, generator)
    test: Dict[str, Any] = {
        "name": "mongodb",
        "os": Debian(),
        "db": MongoDB(),
        "client": DocumentCasClient(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        "generator": generator,
        "checker": LinearizableChecker(device=device),
    }
    if dummy:
        from jepsen_tpu_torch.runtime.client import AtomClient

        test.pop("os")
        test.pop("db")
        test["client"] = AtomClient()
        test["net"] = netlib.MemNet()
    test.update(opts)
    return test


def main(argv=None) -> int:
    import argparse

    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.suites._backend import (
        EXIT_CRASH, add_backend_arg, backend_device, no_card,
    )

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.mongodb")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
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
    test = mongodb_test({
        "device": device,
        "dummy": args.dummy,
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
