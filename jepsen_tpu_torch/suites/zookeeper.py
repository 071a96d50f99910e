"""ZooKeeper suite: the second single-file shape.

Reference: zookeeper/src/jepsen/zookeeper.clj (146 lines) — Debian
package install with myid/zoo.cfg config rendering, a keyed
linearizable register workload, and a partitioner. Same skeleton as
the etcd suite; the client here drives the four-letter-word admin
protocol for health and a keyed register via the control plane's
zkCli (real mode), or the in-memory register (dummy mode).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from jepsen_tpu_torch import independent, nemesis as nemlib, net as netlib
from jepsen_tpu_torch.checker import core as checker_core
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.checker.timeline import html_timeline
from jepsen_tpu_torch.control.core import RemoteError, sessions_for
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

ZKCLI = "/usr/share/zookeeper/bin/zkCli.sh"


class ZkCliClient(Client):
    """Keyed register client over zkCli on the node itself: znodes
    /jepsen/r<k>, reads via `get -s` (data + dataVersion), writes via
    `create`/`set`, cas via version-checked `set` (BadVersion -> fail).
    Transport errors crash reads to :fail and mutations to :info, like
    the reference's client error taxonomy."""

    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        return ZkCliClient(node)

    def _zk(self, test, *args):
        sess = sessions_for(test)[self.node]
        out = sess.exec(
            ZKCLI, "-server", f"{self.node}:2181", *args
        )
        # Many zkCli builds exit 0 on command errors and only print the
        # failure; surface those as RemoteError so callers' error
        # taxonomy applies uniformly.
        for marker in ("Node already exists", "Node does not exist",
                       "version No is not valid", "BadVersion",
                       "KeeperErrorCode"):
            if marker in out:
                raise RemoteError(args, 0, out, marker)
        return out

    def _get(self, test, path):
        """-> (value or None, version or None)"""
        try:
            out = self._zk(test, "get", "-s", path)
        except RemoteError as e:
            if "does not exist" in (e.out + str(e.err) + str(e)):
                return None, None
            raise
        lines = [ln for ln in out.splitlines() if ln.strip()]
        data = None
        version = None
        for i, ln in enumerate(lines):
            if ln.startswith("cZxid"):
                data = lines[i - 1] if i > 0 else None
            if ln.startswith("dataVersion"):
                version = int(ln.split("=")[-1].strip())
        try:
            data = int(data) if data is not None else None
        except ValueError:
            data = None
        return data, version

    def invoke(self, test, op):
        kv = op.value
        if not isinstance(kv, independent.KV):
            raise ValueError(f"expected KV value, got {kv!r}")
        k, v = kv.key, kv.value
        path = f"/jepsen-r{k}"
        try:
            if op.f == "read":
                data, _ = self._get(test, path)
                return op.with_(
                    type="ok", value=independent.KV(k, data)
                )
            if op.f == "write":
                try:
                    self._zk(test, "create", path, str(v))
                except RemoteError as e:
                    if "already exists" not in (e.out + e.err + str(e)):
                        raise
                    self._zk(test, "set", path, str(v))
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = v
                data, version = self._get(test, path)
                if data != old or version is None:
                    return op.with_(type="fail")
                try:
                    self._zk(test, "set", path, str(new), str(version))
                    return op.with_(type="ok")
                except RemoteError as e:
                    blob = e.out + str(e.err) + str(e)
                    if "BadVersion" in blob or \
                            "version No is not valid" in blob:
                        return op.with_(type="fail")
                    raise
            raise ValueError(f"unknown op f={op.f!r}")
        except RemoteError as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise  # runtime records :info (indeterminate)


class ZookeeperDB(DB):
    """apt-install zookeeper, render myid + zoo.cfg, restart
    (zookeeper.clj:23-68)."""

    def setup(self, test, node, session):
        session.exec(
            "env", "DEBIAN_FRONTEND=noninteractive",
            "apt-get", "install", "-y", "zookeeper", "zookeeperd",
            sudo=True,
        )
        myid = test["nodes"].index(node) + 1
        session.exec(
            "sh", "-c", "cat > /etc/zookeeper/conf/myid",
            sudo=True, stdin=f"{myid}\n",
        )
        servers = "\n".join(
            f"server.{i + 1}={n}:2888:3888"
            for i, n in enumerate(test["nodes"])
        )
        cfg = (
            "tickTime=2000\ninitLimit=10\nsyncLimit=5\n"
            "dataDir=/var/lib/zookeeper\nclientPort=2181\n" + servers + "\n"
        )
        session.exec(
            "sh", "-c", "cat > /etc/zookeeper/conf/zoo.cfg",
            sudo=True, stdin=cfg,
        )
        session.exec("service", "zookeeper", "restart", sudo=True)

    def teardown(self, test, node, session):
        session.exec("service", "zookeeper", "stop", sudo=True,
                     check=False)
        session.exec(
            "rm", "-rf", "/var/lib/zookeeper/version-2", sudo=True,
            check=False,
        )

    def log_files(self, test, node):
        return ["/var/log/zookeeper/zookeeper.log"]


def zookeeper_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    dummy = opts.pop("dummy", False)
    device = opts.pop("device", None)

    from jepsen_tpu_torch.workloads.register import op_mix

    per_key_limit = opts.pop("per_key_limit", 200)
    client_gen = independent.concurrent_generator(
        opts.pop("threads_per_key", 2),
        list(range(opts.pop("keys", 16))),
        lambda k: gen.limit(
            per_key_limit,
            gen.stagger(1 / 50, op_mix(rng), rng=rng),
        ),
    )
    test: Dict[str, Any] = {
        "name": "zookeeper",
        "os": Debian(),
        "db": ZookeeperDB(),
        "client": ZkCliClient(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        "generator": gen.clients(client_gen),
        "checker": checker_core.compose({
            "timeline": html_timeline(),
            "indep": independent.independent_checker(
                LinearizableChecker(device=device)
            ),
        }),
    }
    if dummy:
        from jepsen_tpu_torch.workloads.register import MultiRegisterClient

        test.pop("os")
        test.pop("db")
        test["client"] = MultiRegisterClient()
        test["net"] = netlib.MemNet()
    test.update(opts)
    return test
