"""YugabyteDB suite: the structured master/tserver shape.

Reference: yugabyte/ (2,051 LoC) — a two-component cluster (yb-master
consensus group + yb-tserver data nodes), workloads bank / counter /
set / long-fork, and the composed-nemesis pattern
(yugabyte/src/yugabyte/nemesis.clj:12-218): partitions x component
kill/pause x clock, f-routed through one nemesis."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional

from jepsen_tpu_torch import nemesis as nemlib, net as netlib
from jepsen_tpu_torch import nemesis_time
from jepsen_tpu_torch.control.util import (
    install_archive,
    signal_proc,
    start_daemon,
    stop_daemon,
)
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.core import synchronize

DIR = "/opt/yugabyte"
TARBALL = (
    "https://downloads.yugabyte.com/yugabyte-1.1.10.0-linux.tar.gz"
)
COMPONENTS = ("master", "tserver")
BIN = {"master": "yb-master", "tserver": "yb-tserver"}


class YugabyteDB(DB):
    """Master quorum first, barrier, then tservers (yugabyte's
    db/auto pattern)."""

    def _pid(self, c):
        return f"{DIR}/{c}.pid"

    def _log(self, c):
        return f"{DIR}/{c}.log"

    def start_master(self, test, node, session):
        masters = ",".join(f"{n}:7100" for n in test["nodes"])
        start_daemon(
            session,
            f"{DIR}/bin/{BIN['master']}",
            f"--master_addresses={masters}",
            f"--rpc_bind_addresses={node}:7100",
            f"--fs_data_dirs={DIR}/data/master",
            pidfile=self._pid("master"),
            logfile=self._log("master"),
        )

    def start_tserver(self, test, node, session):
        masters = ",".join(f"{n}:7100" for n in test["nodes"])
        start_daemon(
            session,
            f"{DIR}/bin/{BIN['tserver']}",
            f"--tserver_master_addrs={masters}",
            f"--rpc_bind_addresses={node}:9100",
            f"--fs_data_dirs={DIR}/data/tserver",
            pidfile=self._pid("tserver"),
            logfile=self._log("tserver"),
        )

    def stop_component(self, session, component):
        stop_daemon(session, self._pid(component), signal="KILL")

    def setup(self, test, node, session):
        install_archive(session, test.get("tarball", TARBALL), DIR)
        session.exec("mkdir", "-p", f"{DIR}/data")
        self.start_master(test, node, session)
        synchronize(test)  # master quorum before tservers join
        self.start_tserver(test, node, session)

    def teardown(self, test, node, session):
        for c in reversed(COMPONENTS):
            self.stop_component(session, c)
        session.exec("rm", "-rf", f"{DIR}/data", sudo=True, check=False)

    def log_files(self, test, node):
        return [self._log(c) for c in COMPONENTS]


class ComponentNemesis(nemlib.Nemesis):
    """kill/pause/resume/start per component over random subsets
    (yugabyte/nemesis.clj:12-120's shape)."""

    def __init__(self, db: Optional[YugabyteDB] = None, rng=None):
        self.db = db or YugabyteDB()
        self.rng = rng or random.Random()

    def invoke(self, test, op: Op) -> Op:
        from jepsen_tpu_torch.control.core import on_nodes

        action, _, component = op.f.partition("-")
        if component not in COMPONENTS or action not in (
            "start", "kill", "pause", "resume"
        ):
            raise ValueError(f"component nemesis can't route {op.f!r}")
        if action in ("start", "resume"):
            nodes = list(test["nodes"])
        else:
            nodes = [
                n for n in test["nodes"] if self.rng.random() < 0.5
            ] or [self.rng.choice(test["nodes"])]

        def fn(node, sess):
            if action == "start":
                getattr(self.db, f"start_{component}")(test, node, sess)
                return "started"
            if action == "kill":
                self.db.stop_component(sess, component)
                return "killed"
            if action == "pause":
                signal_proc(sess, BIN[component], "STOP")
                return "paused"
            signal_proc(sess, BIN[component], "CONT")
            return "resumed"

        return op.with_(type="info", value=on_nodes(test, fn, nodes))


def full_nemesis(db=None, rng=None) -> nemlib.Compose:
    """partitions x component faults x clock, f-routed
    (yugabyte/nemesis.clj:122-218)."""
    component_fs = {
        f"{a}-{c}"
        for a in ("start", "kill", "pause", "resume")
        for c in COMPONENTS
    }
    return nemlib.compose([
        (component_fs, ComponentNemesis(db, rng)),
        ({"start-partition": "start", "stop-partition": "stop"},
         nemlib.partition_random_halves(rng=rng)),
        ({"bump-clock": "bump", "reset-clock": "reset"},
         nemesis_time.clock_nemesis()),
    ])


def _bank_wl(opts):
    from jepsen_tpu_torch.workloads import bank

    return bank.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
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


def _long_fork_wl(opts):
    from jepsen_tpu_torch.workloads import long_fork

    return long_fork.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "bank": _bank_wl,
    "counter": _counter_wl,
    "set": _set_wl,
    "long-fork": _long_fork_wl,
}


def yugabyte_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "bank")
    nemesis_ops = opts.pop("nemesis_ops", None)
    interval = opts.pop("nemesis_interval", 5)
    time_limit_s = opts.pop("time_limit", None)

    spec = WORKLOADS[workload_name](opts)
    db = YugabyteDB()
    test: Dict[str, Any] = {
        "name": f"yugabyte-{workload_name}",
        "os": Debian(),
        "db": db,
        "net": netlib.IptablesNet(),
        "nemesis": full_nemesis(db, rng),
        **spec,
    }
    if nemesis_ops:
        cycle = []
        for o in nemesis_ops:
            cycle.extend([gen.sleep(interval), gen.once(dict(o))])
        test["generator"] = gen.any_gen(
            test["generator"],
            gen.nemesis(gen.repeat(lambda c=cycle: list(c))),
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.yugabyte")
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
    test = yugabyte_test({
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
