"""TiDB suite: the structured-suite pattern.

Reference: tidb/src/tidb/ (1,443 LoC) — the richest suite shape the
reference has: a three-component cluster (pd / tikv / tidb) with
daemon automation per component (db.clj:88-120), an f-routed process
nemesis (kill/pause/resume per component over random node subsets,
nemesis.clj:18-47), a FULL composed nemesis merging process + partition
+ clock faults (nemesis.clj:52-64), a workload registry, and a
workload-option matrix expanded into test sweeps for CI
(core.clj:29-87). This module proves the framework's suite API scales
to that shape.

Real mode drives TiDB through the MySQL wire protocol via the `mysql`
client binary on the nodes (the control plane executes statements);
dummy mode plugs the workloads' in-memory clients in, as everywhere
else.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional

from jepsen_tpu_torch import independent, nemesis as nemlib, net as netlib
from jepsen_tpu_torch import nemesis_time
from jepsen_tpu_torch.control.core import on_nodes, sessions_for
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
from jepsen_tpu_torch.runtime.client import Client, ClientFailed
from jepsen_tpu_torch.runtime.core import synchronize

DIR = "/opt/tidb"
TARBALL = (
    "https://download.pingcap.org/tidb-latest-linux-amd64.tar.gz"
)
COMPONENTS = ("pd", "kv", "db")
BIN = {"pd": "pd-server", "kv": "tikv-server", "db": "tidb-server"}


def _pidfile(c: str) -> str:
    return f"{DIR}/{c}.pid"


def _logfile(c: str) -> str:
    return f"{DIR}/{c}.log"


class TidbDB(DB):
    """Three-component daemon automation (tidb/src/tidb/db.clj:88-120):
    pd first on every node, barrier, then tikv, barrier, then tidb —
    the multi-phase bring-up the synchronize barrier exists for."""

    def start_pd(self, test, node, session):
        nodes = test["nodes"]
        initial = ",".join(
            f"pd{i + 1}=http://{n}:2380" for i, n in enumerate(nodes)
        )
        name = f"pd{nodes.index(node) + 1}"
        start_daemon(
            session,
            f"{DIR}/bin/{BIN['pd']}",
            f"--name={name}",
            f"--client-urls=http://{node}:2379",
            f"--peer-urls=http://{node}:2380",
            f"--initial-cluster={initial}",
            f"--data-dir={DIR}/data/pd",
            pidfile=_pidfile("pd"),
            logfile=_logfile("pd"),
        )

    def start_kv(self, test, node, session):
        pds = ",".join(f"{n}:2379" for n in test["nodes"])
        start_daemon(
            session,
            f"{DIR}/bin/{BIN['kv']}",
            f"--pd={pds}",
            f"--addr={node}:20160",
            f"--data-dir={DIR}/data/kv",
            pidfile=_pidfile("kv"),
            logfile=_logfile("kv"),
        )

    def start_db(self, test, node, session):
        pds = ",".join(f"{n}:2379" for n in test["nodes"])
        start_daemon(
            session,
            f"{DIR}/bin/{BIN['db']}",
            "--store=tikv",
            f"--path={pds}",
            "-P", "4000",
            pidfile=_pidfile("db"),
            logfile=_logfile("db"),
        )

    def stop_component(self, session, component: str):
        stop_daemon(session, _pidfile(component), signal="KILL")

    def setup(self, test, node, session):
        install_archive(session, test.get("tarball", TARBALL), DIR)
        session.exec("mkdir", "-p", f"{DIR}/data")
        self.start_pd(test, node, session)
        synchronize(test)  # all pds up before tikv joins
        self.start_kv(test, node, session)
        synchronize(test)  # all tikvs up before tidb serves
        self.start_db(test, node, session)

    def teardown(self, test, node, session):
        for c in reversed(COMPONENTS):
            self.stop_component(session, c)
        session.exec("rm", "-rf", f"{DIR}/data", sudo=True, check=False)

    def log_files(self, test, node):
        return [_logfile(c) for c in COMPONENTS]


class ProcessNemesis(nemlib.Nemesis):
    """f-routed component faults over random node subsets
    (tidb/nemesis.clj:18-47): f is "<action>-<component>" with action in
    start/kill/pause/resume and component in pd/kv/db. Resumes and
    starts hit every node; kills and pauses pick a random nonempty
    subset."""

    def __init__(self, db: Optional[TidbDB] = None,
                 rng: Optional[random.Random] = None):
        self.db = db or TidbDB()
        self.rng = rng or random.Random()

    def invoke(self, test, op: Op) -> Op:
        action, _, component = op.f.partition("-")
        if component not in COMPONENTS or action not in (
            "start", "kill", "pause", "resume"
        ):
            raise ValueError(f"process nemesis can't handle f={op.f!r}")
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


def full_nemesis(db: Optional[TidbDB] = None, rng=None) -> nemlib.Compose:
    """Process + partition + clock faults merged under one f-routed
    nemesis (tidb/nemesis.clj:52-64) — the reference's canonical compose
    example, verbatim in shape."""
    process_fs = {
        f"{a}-{c}"
        for a in ("start", "kill", "pause", "resume")
        for c in COMPONENTS
    }
    return nemlib.compose([
        (process_fs, ProcessNemesis(db, rng)),
        ({"start-partition": "start", "stop-partition": "stop"},
         nemlib.partition_random_halves(rng=rng)),
        ({"reset-clock": "reset", "bump-clock": "bump",
          "strobe-clock": "strobe",
          "check-clock-offsets": "check-offsets"},
         nemesis_time.clock_nemesis()),
    ])


class MysqlCliClient(Client):
    """Bank client over the mysql binary on the node (TiDB speaks the
    MySQL protocol on :4000): transfers are single BEGIN..COMMIT
    batches, reads one SELECT — statement errors crash mutations to
    :info and reads to :fail."""

    def __init__(self, node=None, accounts=range(8), total: int = 100):
        self.node = node
        self.accounts = list(accounts)
        self.total = total

    def open(self, test, node):
        return MysqlCliClient(node, self.accounts, self.total)

    def _sql(self, test, stmt: str) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec(
            "mysql", "-h", self.node, "-P", "4000", "-u", "root",
            "--batch", "--raw", "-e", stmt, "test",
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
                out = self._sql(test, "SELECT id, balance FROM accounts;")
                balances = {}
                for line in out.splitlines()[1:]:
                    parts = line.split("\t")
                    if len(parts) == 2:
                        balances[int(parts[0])] = int(parts[1])
                return op.with_(type="ok", value=balances)
            if op.f == "transfer":
                v = op.value
                self._sql(
                    test,
                    "BEGIN; "
                    f"UPDATE accounts SET balance = balance - "
                    f"{int(v['amount'])} WHERE id = {int(v['from'])} "
                    f"AND balance >= {int(v['amount'])}; "
                    f"UPDATE accounts SET balance = balance + "
                    f"{int(v['amount'])} WHERE id = {int(v['to'])} "
                    "AND ROW_COUNT() > 0; COMMIT;",
                )
                return op.with_(type="ok")
            raise ValueError(f"unknown op f={op.f!r}")
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


# -- workload registry + option matrix (tidb/core.clj:29-87) -----------------


def _bank_workload(opts):
    from jepsen_tpu_torch.workloads import bank

    return bank.workload(
        n_ops=opts.get("ops", 400),
        rng=opts.get("rng"),
        snapshot_reads=not opts.get("broken_reads", False),
        device=opts.get("device"),
    )


def _register_workload(opts):
    from jepsen_tpu_torch.workloads import register

    return register.keyed_workload(
        keys=range(opts.get("keys", 8)),
        per_key_ops=opts.get("per_key_ops", 50),
        rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _long_fork_workload(opts):
    from jepsen_tpu_torch.workloads import long_fork

    return long_fork.workload(
        n_ops=opts.get("ops", 400), rng=opts.get("rng"),
        device=opts.get("device"),
    )


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "bank": _bank_workload,
    "register": _register_workload,
    "long-fork": _long_fork_workload,
}

#: per-workload option axes for CI sweeps (tidb/core.clj:38-60)
WORKLOAD_OPTIONS: Dict[str, Dict[str, List[Any]]] = {
    "bank": {"broken_reads": [False], "ops": [400]},
    "register": {"keys": [4, 8], "per_key_ops": [50]},
    "long-fork": {"ops": [300]},
}

#: named nemesis specs (tidb/core.clj:89-115's shorthand sets)
NEMESIS_SPECS: Dict[str, List[dict]] = {
    "none": [],
    "partitions": [{"f": "start-partition"}, {"f": "stop-partition"}],
    "kill-kv": [{"f": "kill-kv"}, {"f": "start-kv"}],
    "pause-db": [{"f": "pause-db"}, {"f": "resume-db"}],
    "clock": [{"f": "bump-clock"}, {"f": "reset-clock"}],
}


def all_test_options(workload_names=None) -> List[dict]:
    """Expand the cross-product of each workload's option axes into
    flat test-option dicts (tidb/core.clj:61-87) — the CI sweep."""
    out = []
    for name in workload_names or sorted(WORKLOADS):
        axes = WORKLOAD_OPTIONS.get(name, {})
        keys = sorted(axes)
        for combo in itertools.product(*(axes[k] for k in keys)):
            out.append({"workload": name, **dict(zip(keys, combo))})
    return out


def tidb_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble the structured test map: workload by name, full
    composed nemesis, component DB."""
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "bank")
    nemesis_spec = opts.pop("nemesis", "none")
    interval = opts.pop("nemesis_interval", 10)
    time_limit_s = opts.pop("time_limit", None)

    spec = WORKLOADS[workload_name](opts)
    db = TidbDB()
    test: Dict[str, Any] = {
        "name": f"tidb-{workload_name}",
        "os": Debian(),
        "db": db,
        "net": netlib.IptablesNet(),
        "nemesis": full_nemesis(db, rng),
        **spec,
    }
    if workload_name == "bank" and not dummy:
        test["client"] = MysqlCliClient()

    ops = NEMESIS_SPECS[nemesis_spec]
    if ops:
        cycle = []
        for o in ops:
            cycle.extend([gen.sleep(interval), gen.once(dict(o))])
        nemesis_gen = gen.nemesis(gen.repeat(lambda c=cycle: list(c)))
        test["generator"] = gen.any_gen(
            gen.clients(test["generator"]), nemesis_gen
        )
    else:
        test["generator"] = gen.clients(test["generator"])
    if time_limit_s:
        test["generator"] = gen.time_limit(
            time_limit_s, test["generator"]
        )
    if dummy:
        test.pop("os", None)
        test.pop("db", None)
        test["net"] = netlib.MemNet()
    for k in ("rng", "device"):
        opts.pop(k, None)
    test.update(opts)
    return test
