"""Crate suite: dirty-read, lost-updates, version-divergence.

Reference: crate/src/jepsen/crate/ (1,157 LoC) — three workloads over
an elasticsearch-backed SQL store:

- dirty-read (dirty_read.clj): single-row reads during chaos + one
  final strong read per worker; dirty/lost/node-divergence accounting
  (checker/divergence.StrongDirtyReadChecker);
- lost-updates (lost_updates.clj): concurrent updates, final read,
  acked updates must survive (the set checker's lost accounting);
- version-divergence (version_divergence.clj): reads return
  (value, _version); one version must never carry two values
  (checker/divergence.MultiVersionChecker).

Real mode drives crate over its HTTP _sql endpoint via curl; dummy
mode uses in-memory clients whose weak modes plant each anomaly
deterministically."""

from __future__ import annotations

import itertools
import json
import random
import threading
from typing import Any, Callable, Dict, List, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.checker import reductions
from jepsen_tpu_torch.checker.divergence import (
    MultiVersionChecker,
    StrongDirtyReadChecker,
)
from jepsen_tpu_torch.control.core import sessions_for
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

DIR = "/opt/crate"
TARBALL = "https://cdn.crate.io/downloads/releases/crate-0.54.9.tar.gz"


class CrateDB(DB):
    def setup(self, test, node, session):
        install_archive(session, test.get("tarball", TARBALL), DIR)
        peers = ",".join(f"{n}:4300" for n in test["nodes"])
        start_daemon(
            session,
            f"{DIR}/bin/crate",
            f"-Des.network.host={node}",
            f"-Des.discovery.zen.ping.unicast.hosts={peers}",
            "-Des.discovery.zen.minimum_master_nodes="
            + str(len(test["nodes"]) // 2 + 1),
            pidfile=f"{DIR}/crate.pid",
            logfile=f"{DIR}/crate.log",
        )

    def teardown(self, test, node, session):
        stop_daemon(session, f"{DIR}/crate.pid")
        session.exec("rm", "-rf", f"{DIR}/data", sudo=True, check=False)

    def log_files(self, test, node):
        return [f"{DIR}/crate.log"]


class CrateSqlClient(Client):
    """SQL over crate's HTTP _sql endpoint via curl on the node."""

    def __init__(self, node: Optional[str] = None):
        self.node = node

    def _sql(self, test, stmt: str, args: list = ()) -> dict:
        sess = sessions_for(test)[self.node]
        body = json.dumps({"stmt": stmt, "args": list(args)})
        out = sess.exec(
            "curl", "-sf", "-X", "POST",
            "-H", "Content-Type: application/json",
            "-d", body,
            f"http://{self.node}:4200/_sql",
        )
        return json.loads(out or "{}")

    def _rows(self, test, stmt: str, args: list = ()) -> list:
        return self._sql(test, stmt, args).get("rows", [])


class SqlDirtyReadClient(CrateSqlClient):
    """Real-mode dirty-read client (dirty_read.clj's role): writes
    insert rows, reads fetch the latest, strong reads refresh then
    scan everything."""

    def open(self, test, node):
        return SqlDirtyReadClient(node)

    def setup(self, test):
        try:
            self._sql(
                test,
                "CREATE TABLE IF NOT EXISTS dirty "
                "(id INT PRIMARY KEY) WITH (number_of_replicas = 2)",
            )
        except Exception:
            pass

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "write":
                self._sql(
                    test, "INSERT INTO dirty (id) VALUES (?)",
                    [int(op.value)],
                )
                return op.with_(type="ok")
            if op.f == "read":
                rows = self._rows(
                    test,
                    "SELECT id FROM dirty ORDER BY id DESC LIMIT 1",
                )
                if not rows:
                    return op.with_(type="fail")
                return op.with_(type="ok", value=int(rows[0][0]))
            if op.f == "strong-read":
                self._sql(test, "REFRESH TABLE dirty")
                rows = self._rows(test, "SELECT id FROM dirty")
                return op.with_(
                    type="ok", value=[int(r[0]) for r in rows]
                )
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f in ("read", "strong-read"):
                raise ClientFailed(str(e))
            raise


class SqlVersionClient(CrateSqlClient):
    """Real-mode version-divergence client
    (version_divergence.clj:58-72): upserts one register row, reads
    (value, _version)."""

    def open(self, test, node):
        return SqlVersionClient(node)

    def setup(self, test):
        try:
            self._sql(
                test,
                "CREATE TABLE IF NOT EXISTS registers "
                "(id INT PRIMARY KEY, value INT)",
            )
        except Exception:
            pass

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "write":
                self._sql(
                    test,
                    "INSERT INTO registers (id, value) VALUES (0, ?) "
                    "ON DUPLICATE KEY UPDATE value = VALUES(value)",
                    [int(op.value)],
                )
                return op.with_(type="ok")
            if op.f == "read":
                rows = self._rows(
                    test,
                    'SELECT value, "_version" FROM registers '
                    "WHERE id = 0",
                )
                if not rows:
                    return op.with_(type="fail")
                return op.with_(type="ok", value={
                    "value": rows[0][0], "_version": rows[0][1],
                })
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


class SqlLostUpdatesClient(CrateSqlClient):
    """Real-mode lost-updates client (lost_updates.clj's role)."""

    def open(self, test, node):
        return SqlLostUpdatesClient(node)

    def setup(self, test):
        try:
            self._sql(
                test,
                "CREATE TABLE IF NOT EXISTS updates "
                "(id INT PRIMARY KEY)",
            )
        except Exception:
            pass

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                self._sql(
                    test, "INSERT INTO updates (id) VALUES (?)",
                    [int(op.value)],
                )
                return op.with_(type="ok")
            if op.f == "read":
                self._sql(test, "REFRESH TABLE updates")
                rows = self._rows(test, "SELECT id FROM updates")
                return op.with_(
                    type="ok", value=[int(r[0]) for r in rows]
                )
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


# -- in-memory clients -------------------------------------------------------


class _DirtyState:
    def __init__(self, weak: bool):
        self.committed: List[int] = []
        self.lock = threading.Lock()
        self.weak = weak
        self.write_count = 0


class MemDirtyReadClient(Client):
    """Single-register writes/reads + per-worker strong reads.
    weak=True acks the 6th write without committing it (lost — and any
    read that served it becomes dirty)."""

    LOSE_AT = 6

    def __init__(self, state: Optional[_DirtyState] = None,
                 weak: bool = False):
        self.state = state or _DirtyState(weak)

    def open(self, test, node):
        return MemDirtyReadClient(self.state)

    def invoke(self, test, op: Op) -> Op:
        st = self.state
        with st.lock:
            if op.f == "write":
                st.write_count += 1
                if st.weak and st.write_count == self.LOSE_AT:
                    return op.with_(type="ok")  # acked, not committed
                st.committed.append(op.value)
                return op.with_(type="ok")
            if op.f == "read":
                if not st.committed:
                    return op.with_(type="fail")
                return op.with_(type="ok", value=st.committed[-1])
            if op.f == "strong-read":
                return op.with_(type="ok", value=list(st.committed))
        raise ValueError(f"unknown op f={op.f!r}")


class _VersionState:
    def __init__(self, weak: bool):
        self.log: List[tuple] = [(None, 0)]  # (value, version)
        self.version = 0
        self.lock = threading.Lock()
        self.weak = weak
        self.write_count = 0
        self.read_i = 0


class MemVersionClient(Client):
    """Versioned register: writes bump _version; reads round-robin the
    observed (value, version) log. weak=True reuses the previous
    version for the 4th write — two values share one version."""

    COLLIDE_AT = 4

    def __init__(self, state: Optional[_VersionState] = None,
                 weak: bool = False):
        self.state = state or _VersionState(weak)

    def open(self, test, node):
        return MemVersionClient(self.state)

    def invoke(self, test, op: Op) -> Op:
        st = self.state
        with st.lock:
            if op.f == "write":
                st.write_count += 1
                if not (st.weak and st.write_count == self.COLLIDE_AT):
                    st.version += 1
                st.log.append((op.value, st.version))
                return op.with_(type="ok")
            if op.f == "read":
                st.read_i += 1
                v, ver = st.log[st.read_i % len(st.log)]
                return op.with_(
                    type="ok", value={"value": v, "_version": ver}
                )
        raise ValueError(f"unknown op f={op.f!r}")


class _LostState:
    def __init__(self, weak: bool):
        self.rows: List[int] = []
        self.lock = threading.Lock()
        self.weak = weak
        self.write_count = 0


class MemLostUpdatesClient(Client):
    """Acked inserts must appear in the final read (lost_updates.clj);
    weak=True drops the 9th acked insert."""

    LOSE_AT = 9

    def __init__(self, state: Optional[_LostState] = None,
                 weak: bool = False):
        self.state = state or _LostState(weak)

    def open(self, test, node):
        return MemLostUpdatesClient(self.state)

    def invoke(self, test, op: Op) -> Op:
        st = self.state
        with st.lock:
            if op.f == "add":
                st.write_count += 1
                if st.weak and st.write_count == self.LOSE_AT:
                    return op.with_(type="ok")  # acked, dropped
                st.rows.append(op.value)
                return op.with_(type="ok")
            if op.f == "read":
                return op.with_(type="ok", value=list(st.rows))
        raise ValueError(f"unknown op f={op.f!r}")


# -- workloads ---------------------------------------------------------------


def _dirty_read_workload(opts):
    counter = itertools.count(1)
    rng = opts.get("rng") or random.Random(0)

    def w():
        return {"f": "write", "value": next(counter)}

    return {
        "client": MemDirtyReadClient(weak=opts.get("weak", False)),
        "generator": gen.clients(gen.limit(
            opts.get("ops", 200),
            gen.mix([w, {"f": "read"}], rng=rng),
        )),
        # one strong read per worker after the chaos (dirty_read.clj)
        "final_generator": gen.clients(
            gen.each_thread(gen.once({"f": "strong-read"}))
        ),
        "checker": StrongDirtyReadChecker(),
    }


def _version_divergence_workload(opts):
    counter = itertools.count(1)
    rng = opts.get("rng") or random.Random(0)

    def w():
        return {"f": "write", "value": next(counter)}

    return {
        "client": MemVersionClient(weak=opts.get("weak", False)),
        "generator": gen.clients(gen.limit(
            opts.get("ops", 200),
            gen.mix([w, {"f": "read"}], rng=rng),
        )),
        "checker": MultiVersionChecker(),
    }


def _lost_updates_workload(opts):
    counter = itertools.count(1)

    def add():
        return {"f": "add", "value": next(counter)}

    return {
        "client": MemLostUpdatesClient(weak=opts.get("weak", False)),
        "generator": gen.clients(gen.limit(opts.get("ops", 200), add)),
        "final_generator": gen.clients(gen.once({"f": "read"})),
        "checker": reductions.set_checker(),
    }


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "dirty-read": _dirty_read_workload,
    "version-divergence": _version_divergence_workload,
    "lost-updates": _lost_updates_workload,
}

#: real-mode SQL clients per workload (dummy mode keeps the in-memory
#: clients with their plantable anomalies)
REAL_CLIENTS: Dict[str, Callable[[], Client]] = {
    "dirty-read": SqlDirtyReadClient,
    "version-divergence": SqlVersionClient,
    "lost-updates": SqlLostUpdatesClient,
}


def crate_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "dirty-read")
    opts.pop("device", None)  # every workload's checker is host code

    spec = WORKLOADS[workload_name](opts)
    test: Dict[str, Any] = {
        "name": f"crate-{workload_name}",
        "os": Debian(),
        "db": CrateDB(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        **{k: v for k, v in spec.items()},
    }
    if not dummy:
        test["client"] = REAL_CLIENTS[workload_name]()
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

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.crate")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="dirty-read",
                   choices=sorted(WORKLOADS))
    p.add_argument("--ops", type=int, default=200)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = crate_test({
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
