"""etcd suite: the canonical test shape.

Reference: etcd/src/jepsen/etcd.clj (197 lines) — DB install via
cached tarball + daemon start (:52-86), a CAS-register client over the
etcd HTTP API (:94-141), independent keyed r/w/cas workload with 10
threads/key, stagger 1/30, 300 ops/key (:145-173), a random-halves
partitioner on a sleep/start/sleep/stop cycle (:170-176), and a
composed checker (timeline + linearizable per key) (:157-166).

The suite runs in two modes:
- real: EtcdDB + EtcdClient against live nodes over the control plane
  (HTTP via urllib; etcd v2 keys API, as the reference's client).
- dummy (opts["dummy"]): the in-memory MultiRegisterClient + MemNet —
  the atom-db trick (jepsen/src/jepsen/tests.clj:26-57) scaled to a
  whole suite, so the complete test map runs in CI with zero
  infrastructure.
"""

from __future__ import annotations

import json
import random
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

from jepsen_tpu_torch import independent, nemesis as nemlib, net as netlib
from jepsen_tpu_torch.checker import core as checker_core
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.checker.timeline import html_timeline
from jepsen_tpu_torch.control.util import (
    install_archive,
    start_daemon,
    stop_daemon,
)
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

DIR = "/opt/etcd"
BINARY = f"{DIR}/etcd"
LOGFILE = f"{DIR}/etcd.log"
PIDFILE = f"{DIR}/etcd.pid"
VERSION = "v3.1.5"


def peer_url(node: str) -> str:
    return f"http://{node}:2380"


def client_url(node: str) -> str:
    return f"http://{node}:2379"


def initial_cluster(test) -> str:
    return ",".join(f"{n}={peer_url(n)}" for n in test["nodes"])


class EtcdDB(DB):
    """Install + run etcd per node (etcd.clj:52-86).

    disk_faults=True mounts the FUSE fault filesystem over the data
    dir BEFORE etcd starts (etcd is a statically-linked Go binary —
    only a mount-level interposer can afflict it, and it must open
    its data dir through the mount from the first write), and points
    etcd's --data-dir at the mountpoint. Pair with
    faultfs.fuse_faultfs_nemesis(..., install=False)."""

    DATA_BACKING = f"{DIR}/data-backing"
    DATA_MOUNT = f"{DIR}/data"

    def __init__(self, version: str = VERSION,
                 disk_faults: bool = False):
        self.version = version
        self.disk_faults = disk_faults

    def setup(self, test, node, session):
        url = (
            "https://storage.googleapis.com/etcd/"
            f"{self.version}/etcd-{self.version}-linux-amd64.tar.gz"
        )
        install_archive(session, url, DIR)
        extra = []
        if self.disk_faults:
            from jepsen_tpu_torch.faultfs import install_fuse

            install_fuse(session, self.DATA_BACKING, self.DATA_MOUNT)
            extra = ["--data-dir", self.DATA_MOUNT]
        start_daemon(
            session,
            BINARY,
            "--name", node,
            "--listen-peer-urls", peer_url(node),
            "--listen-client-urls", client_url(node),
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", "new",
            "--initial-advertise-peer-urls", peer_url(node),
            "--initial-cluster", initial_cluster(test),
            *extra,
            pidfile=PIDFILE,
            logfile=LOGFILE,
            chdir=DIR,
        )
        import time

        time.sleep(test.get("db_start_wait", 5))

    def teardown(self, test, node, session):
        stop_daemon(session, PIDFILE)
        if self.disk_faults:
            from jepsen_tpu_torch.faultfs import fuse_unmount

            fuse_unmount(session, self.DATA_MOUNT)
        session.exec("rm", "-rf", DIR, sudo=True)

    def log_files(self, test, node):
        return [LOGFILE]


class EtcdClient(Client):
    """Keyed CAS-register client over the etcd v2 keys HTTP API
    (etcd.clj:94-141): reads are non-quorum gets, writes are PUTs, cas
    uses prevValue; timeouts crash reads to :fail and writes to :info.
    """

    def __init__(self, node: Optional[str] = None, timeout_s: float = 5.0):
        self.node = node
        self.timeout_s = timeout_s

    def open(self, test, node):
        return EtcdClient(node, self.timeout_s)

    def _url(self, k) -> str:
        return f"{client_url(self.node)}/v2/keys/r{k}"

    def _request(self, url, data=None, method="GET"):
        body = urllib.parse.urlencode(data).encode() if data else None
        req = urllib.request.Request(url, data=body, method=method)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def invoke(self, test, op: Op) -> Op:
        kv = op.value
        if not isinstance(kv, independent.KV):
            raise ValueError(f"expected KV value, got {kv!r}")
        k, v = kv.key, kv.value
        crash_type = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                try:
                    out = self._request(self._url(k))
                    val = int(out["node"]["value"])
                except urllib.error.HTTPError as e:
                    if e.code == 404:
                        val = None
                    else:
                        raise
                return op.with_(
                    type="ok", value=independent.KV(k, val)
                )
            if op.f == "write":
                self._request(
                    self._url(k), data={"value": v}, method="PUT"
                )
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = v
                try:
                    self._request(
                        self._url(k) + f"?prevValue={old}",
                        data={"value": new},
                        method="PUT",
                    )
                    return op.with_(type="ok")
                except urllib.error.HTTPError as e:
                    if e.code in (404, 412):  # not found / compare failed
                        return op.with_(type="fail")
                    raise
            raise ValueError(f"unknown op f={op.f!r}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            if crash_type == "fail":
                raise ClientFailed(str(e))
            raise  # runtime converts to :info (core.clj:199-232)


def etcd_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the canonical test map (etcd.clj:149-180)."""
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    dummy = opts.pop("dummy", False)
    time_limit_s = opts.pop("time_limit", None)
    threads_per_key = opts.pop("threads_per_key", 10)
    per_key_limit = opts.pop("per_key_limit", 300)
    stagger_s = opts.pop("stagger", 1 / 30)
    nemesis_interval = opts.pop("nemesis_interval", 10)
    nemesis_kind = opts.pop("nemesis", "partition")
    device = opts.pop("device", None)

    from jepsen_tpu_torch.workloads.register import op_mix

    client_gen = independent.concurrent_generator(
        threads_per_key,
        list(range(opts.pop("keys", 50))),
        lambda k: gen.limit(
            per_key_limit, gen.stagger(stagger_s, op_mix(rng), rng=rng)
        ),
    )
    if nemesis_kind == "disk":
        # Mount-level disk faults (charybdefs.clj's role): the DB
        # mounts the fault fs before etcd starts; the nemesis only
        # flips faults (1%-flaky on start — the reference's
        # break-one-percent — clear on stop).
        from jepsen_tpu_torch.faultfs import FuseFaultFSNemesis

        db = EtcdDB(disk_faults=True)
        nemesis = FuseFaultFSNemesis(
            EtcdDB.DATA_BACKING, EtcdDB.DATA_MOUNT, install=False
        )
        nemesis_ops = [
            gen.sleep(nemesis_interval),
            gen.once({"f": "flaky", "value": 1}),
            gen.sleep(nemesis_interval),
            gen.once({"f": "clear"}),
        ]
    elif nemesis_kind == "partition":
        db = EtcdDB()
        nemesis = nemlib.partition_random_halves(rng=rng)
        nemesis_ops = [
            gen.sleep(nemesis_interval),
            gen.once({"f": "start"}),
            gen.sleep(nemesis_interval),
            gen.once({"f": "stop"}),
        ]
    else:
        raise ValueError(
            f"unknown nemesis kind {nemesis_kind!r}; "
            "have: partition, disk"
        )

    nemesis_gen = gen.nemesis(gen.repeat(lambda: list(nemesis_ops)))
    test: Dict[str, Any] = {
        "name": "etcd",
        "os": Debian(),
        "db": db,
        "client": EtcdClient(),
        "net": netlib.IptablesNet(),
        "nemesis": nemesis,
        # The nemesis cycle is infinite, so the whole generator is
        # bounded by the time limit (etcd.clj:170-176).
        "generator": gen.time_limit(
            time_limit_s, gen.any_gen(client_gen, nemesis_gen)
        ) if time_limit_s else gen.any_gen(client_gen, nemesis_gen),
        "checker": checker_core.compose({
            "timeline": html_timeline(),
            "indep": independent.independent_checker(
                LinearizableChecker(device=device)
            ),
        }),
    }
    if dummy:
        from jepsen_tpu_torch.workloads.register import MultiRegisterClient

        test["os"] = None
        test["db"] = None
        test["client"] = MultiRegisterClient()
        test["net"] = netlib.MemNet()
    test.update(opts)
    if test.get("os") is None:
        test.pop("os")
    if test.get("db") is None:
        test.pop("db")
    return test


def main(argv=None) -> int:
    """Suite entry point: test + analyze + serve over the shared CLI
    (etcd.clj:182-188)."""
    import sys

    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.store import save_run
    from jepsen_tpu_torch.suites._backend import (
        EXIT_CRASH, add_backend_arg, backend_device, no_card,
    )

    import argparse

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.etcd")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--concurrency", default=None)
    p.add_argument("--time-limit", type=float, default=30.0)
    p.add_argument("--keys", type=int, default=50)
    p.add_argument("--threads-per-key", type=int, default=10)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    nodes = [n for n in args.nodes.split(",") if n]
    test = etcd_test({
        "device": device,
        "dummy": args.dummy,
        "keys": args.keys,
        "threads_per_key": args.threads_per_key,
        "nodes": nodes,
    })
    concurrency = (
        int(args.concurrency) if args.concurrency else 2 * len(nodes)
    )
    # the keyed generator needs whole thread groups
    concurrency += (-concurrency) % args.threads_per_key
    test["concurrency"] = concurrency
    test["generator"] = gen.time_limit(
        args.time_limit, test["generator"]
    )
    test["store"] = args.store
    test = run(test)
    valid = test["results"].get("valid?")
    print(f"valid?={valid}")
    return 0 if valid is True else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
