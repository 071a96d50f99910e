"""Elasticsearch suite: sets and dirty-read.

Reference: elasticsearch/src/jepsen/elasticsearch/ (929 LoC) — the
sets workload (acked index operations must all appear in a final
refreshed search — the set checker's lost accounting) and a dirty-read
workload with per-worker strong reads (same accounting family as
crate's, checker/divergence.StrongDirtyReadChecker). Historically the
suite that demonstrated ES losing acked writes during partitions.

Real mode drives the REST API via curl on the nodes; dummy mode uses
the in-memory set / dirty-read clients."""

from __future__ import annotations

import json
import random
from typing import Any, Callable, Dict, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.control.core import sessions_for
from jepsen_tpu_torch.control.util import start_daemon, stop_daemon
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

DIR = "/opt/elasticsearch"


class ElasticsearchDB(DB):
    def setup(self, test, node, session):
        session.exec(
            "apt-get", "install", "-y", "elasticsearch",
            sudo=True, check=False,
        )
        hosts = json.dumps([f"{n}:9300" for n in test["nodes"]])
        conf = (
            f"cluster.name: jepsen\\n"
            f"node.name: {node}\\n"
            f"network.host: {node}\\n"
            f"discovery.zen.ping.unicast.hosts: {hosts}\\n"
            "discovery.zen.minimum_master_nodes: "
            + str(len(test["nodes"]) // 2 + 1) + "\\n"
        )
        session.exec(
            "sh", "-c",
            f"printf '{conf}' > /etc/elasticsearch/elasticsearch.yml",
            sudo=True,
        )
        session.exec("service", "elasticsearch", "restart", sudo=True)

    def teardown(self, test, node, session):
        session.exec(
            "service", "elasticsearch", "stop", sudo=True, check=False
        )
        session.exec(
            "rm", "-rf", "/var/lib/elasticsearch", sudo=True,
            check=False,
        )

    def log_files(self, test, node):
        return ["/var/log/elasticsearch/jepsen.log"]


class EsSetClient(Client):
    """Index docs / search-all over the REST API via curl."""

    def __init__(self, node: Optional[str] = None):
        self.node = node

    def open(self, test, node):
        return EsSetClient(node)

    def _curl(self, test, *args) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec("curl", "-sf", *args)

    def invoke(self, test, op: Op) -> Op:
        base = f"http://{self.node}:9200/jepsen/set"
        try:
            if op.f == "add":
                self._curl(
                    test, "-X", "POST",
                    "-H", "Content-Type: application/json",
                    "-d", json.dumps({"value": op.value}),
                    f"{base}?refresh=wait_for",
                )
                return op.with_(type="ok")
            if op.f == "read":
                self._curl(
                    test, "-X", "POST",
                    f"http://{self.node}:9200/jepsen/_refresh",
                )
                out = self._curl(
                    test,
                    f"{base}/_search?size=10000&q=*:*",
                )
                hits = json.loads(out or "{}").get("hits", {})
                vals = [
                    h["_source"]["value"]
                    for h in hits.get("hits", [])
                ]
                return op.with_(type="ok", value=vals)
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


class EsDirtyReadClient(EsSetClient):
    """Real-mode dirty-read client (elasticsearch/dirty_read.clj's
    role): writes index docs, reads fetch the newest, strong reads
    refresh then search everything."""

    def open(self, test, node):
        return EsDirtyReadClient(node)

    def invoke(self, test, op: Op) -> Op:
        base = f"http://{self.node}:9200/jepsen/dirty"
        try:
            if op.f == "write":
                self._curl(
                    test, "-X", "POST",
                    "-H", "Content-Type: application/json",
                    "-d", json.dumps({"value": op.value}),
                    f"{base}?refresh=wait_for",
                )
                return op.with_(type="ok")
            if op.f == "read":
                out = self._curl(
                    test,
                    f"{base}/_search?size=1&sort=value:desc&q=*:*",
                )
                hits = json.loads(out or "{}").get("hits", {}).get(
                    "hits", []
                )
                if not hits:
                    return op.with_(type="fail")
                return op.with_(
                    type="ok", value=hits[0]["_source"]["value"]
                )
            if op.f == "strong-read":
                self._curl(
                    test, "-X", "POST",
                    f"http://{self.node}:9200/jepsen/_refresh",
                )
                out = self._curl(
                    test, f"{base}/_search?size=10000&q=*:*"
                )
                hits = json.loads(out or "{}").get("hits", {}).get(
                    "hits", []
                )
                return op.with_(
                    type="ok",
                    value=[h["_source"]["value"] for h in hits],
                )
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f in ("read", "strong-read"):
                raise ClientFailed(str(e))
            raise


def _sets_workload(opts):
    from jepsen_tpu_torch.workloads import set as set_wl

    return set_wl.workload(
        n_adds=opts.get("ops", 300),
        rng=opts.get("rng"),
        lossy=0.3 if opts.get("weak") else 0.0,
        full=False,  # final-read lost accounting (sets.clj's checker)
    )


def _dirty_read_workload(opts):
    from jepsen_tpu_torch.suites.crate import _dirty_read_workload as w

    return w(opts)


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "sets": _sets_workload,
    "dirty-read": _dirty_read_workload,
}


def elasticsearch_test(
    opts: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "sets")
    opts.pop("device", None)  # every workload's checker is host code

    spec = WORKLOADS[workload_name](opts)
    test: Dict[str, Any] = {
        "name": f"elasticsearch-{workload_name}",
        "os": Debian(),
        "db": ElasticsearchDB(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        **spec,
    }
    if not dummy:
        if workload_name == "sets":
            test["client"] = EsSetClient()
        else:  # dirty-read: the crate _sql family doesn't apply; ES
            # speaks the same REST shapes as its own set client
            test["client"] = EsDirtyReadClient()
    if dummy:
        test.pop("os")
        test.pop("db")
        test["net"] = netlib.MemNet()
    opts.pop("rng", None)
    test.update(opts)
    return test


def main(argv=None) -> int:
    import argparse

    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.suites._backend import (
        EXIT_CRASH, add_backend_arg, backend_device, no_card,
    )

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.elasticsearch")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="sets",
                   choices=sorted(WORKLOADS))
    p.add_argument("--ops", type=int, default=300)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = elasticsearch_test({
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
