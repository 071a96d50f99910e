"""Chronos suite: job-scheduler completeness testing.

Reference: chronos/ (847 LoC) — the one reference suite whose checker
verifies SCHEDULED-RUN completeness instead of kv consistency: jobs are
added with {name, start, interval, count, epsilon, duration}, each
scheduled run appends a row, and the final read collects every run for
the checker (jepsen_tpu_torch/checker/schedule.py) to match against targets.

The real DB stack is zookeeper + mesos master/slave + chronos
(chronos/src/jepsen/chronos.clj's db); the client adds jobs over the
Chronos REST API (POST /scheduler/iso8601) and reads the run table.
Dummy mode uses an in-memory scheduler that materializes runs on read;
weak=True drops every 7th run — the missed-execution anomaly the
checker exists to catch.
"""

from __future__ import annotations

import json
import random
import time
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.checker.schedule import ScheduleChecker
from jepsen_tpu_torch.control.core import sessions_for
from jepsen_tpu_torch.control.util import start_daemon, stop_daemon
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

DIR = "/opt/chronos"


class ChronosDB(DB):
    """zookeeper + mesos + chronos daemon stack (chronos.clj's db)."""

    def setup(self, test, node, session):
        session.exec(
            "apt-get", "install", "-y",
            "zookeeper", "mesos", "chronos", sudo=True, check=False,
        )
        session.exec("service", "zookeeper", "restart", sudo=True)
        zk = ",".join(f"{n}:2181" for n in test["nodes"])
        start_daemon(
            session, "mesos-master",
            "--zk", f"zk://{zk}/mesos",
            "--quorum", str(len(test["nodes"]) // 2 + 1),
            pidfile=f"{DIR}/mesos-master.pid",
            logfile=f"{DIR}/mesos-master.log",
        )
        start_daemon(
            session, "mesos-slave",
            "--master", f"zk://{zk}/mesos",
            pidfile=f"{DIR}/mesos-slave.pid",
            logfile=f"{DIR}/mesos-slave.log",
        )
        start_daemon(
            session, "chronos",
            "--zk_hosts", zk,
            "--master", f"zk://{zk}/mesos",
            pidfile=f"{DIR}/chronos.pid",
            logfile=f"{DIR}/chronos.log",
        )

    def teardown(self, test, node, session):
        for svc in ("chronos", "mesos-slave", "mesos-master"):
            stop_daemon(session, f"{DIR}/{svc}.pid")
        session.exec(
            "service", "zookeeper", "stop", sudo=True, check=False
        )

    def log_files(self, test, node):
        return [
            f"{DIR}/chronos.log",
            f"{DIR}/mesos-master.log",
            f"{DIR}/mesos-slave.log",
        ]


class ChronosRestClient(Client):
    """Adds jobs over the Chronos REST API via curl on the node; runs
    are read back from the shared run log the scheduled command
    appends to (chronos.clj's client role)."""

    def __init__(self, node: Optional[str] = None):
        self.node = node

    def open(self, test, node):
        return ChronosRestClient(node)

    def invoke(self, test, op: Op) -> Op:
        sess = sessions_for(test)[self.node]
        try:
            if op.f == "add-job":
                # The generator emits starts as offsets on a simulated
                # grid; against a real cluster the logged runs are
                # wall-clock epoch seconds, so anchor the job's start
                # to the control host's clock here and emit it in the
                # ISO8601 schedule. The anchored job rides the ok op
                # back into the history, so the checker's target grid
                # and the run log share one time base.
                job = dict(op.value)
                name = str(job["name"])
                # Floor to whole seconds: the ISO8601 schedule below
                # and the run log's `date +%s` are both second-grained,
                # and a fractional anchor would skew the checker's
                # bucket grid by up to ~1s against the actual runs.
                job["start"] = float(int(
                    time.time() + float(job.get("start", 0.0))
                ))
                iso_start = datetime.fromtimestamp(
                    job["start"], timezone.utc
                ).strftime("%Y-%m-%dT%H:%M:%SZ")
                # Each run logs "<name> <start>" when it begins and
                # "<name> <start> <end>" when it completes — the shape
                # the read parser and the checker's incomplete-run
                # accounting consume.
                cmd = (
                    f"s=$(date +%s); echo {name} $s >> "
                    f"{DIR}/runs.log && sleep {job['duration']} && "
                    f"echo {name} $s $(date +%s) >> {DIR}/runs.log"
                )
                spec = {
                    "name": name,
                    "schedule": (
                        f"R{job['count']}/{iso_start}/"
                        f"PT{job['interval']:g}S"
                    ),
                    "epsilon": f"PT{job['epsilon']:g}S",
                    "command": cmd,
                }
                sess.exec(
                    "curl", "-f", "-X", "POST",
                    "-H", "Content-Type: application/json",
                    "-d", json.dumps(spec),
                    f"http://{self.node}:4400/scheduler/iso8601",
                )
                return op.with_(type="ok", value=job)
            if op.f == "advance-clock":
                return op.with_(type="ok")  # real time advances itself
            if op.f == "read":
                out = sess.exec(
                    "sh", "-c",
                    f"cat {DIR}/runs.log 2>/dev/null || true",
                )
                begun = {}
                done = {}
                for line in out.splitlines():
                    parts = line.split()
                    if len(parts) == 2:
                        begun[(parts[0], float(parts[1]))] = None
                    elif len(parts) == 3:
                        done[(parts[0], float(parts[1]))] = float(
                            parts[2]
                        )
                runs = [
                    {"name": n, "start": s, "end": done.get((n, s))}
                    for (n, s) in begun
                ]
                return op.with_(
                    type="ok",
                    value={"time": time.time(), "runs": runs},
                )
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


class MemScheduler:
    """In-memory scheduler shared across clients: runs materialize at
    read time from each job's target grid; weak=True drops every 7th
    run (a missed execution)."""

    def __init__(self, weak: bool = False):
        self.jobs: Dict[Any, Dict[str, Any]] = {}
        self.weak = weak
        self.clock = 0.0

    def read(self):
        runs: List[dict] = []
        i = 0
        for name, job in sorted(self.jobs.items()):
            t = job["start"]
            for _ in range(int(job["count"])):
                if t + job["duration"] > self.clock:
                    break
                i += 1
                if self.weak and i % 7 == 0:
                    t += job["interval"]
                    continue  # missed execution
                runs.append({
                    "name": name,
                    "start": t + 1.0,  # within epsilon
                    "end": t + 1.0 + job["duration"],
                })
                t += job["interval"]
        return {"time": self.clock, "runs": runs}


class MemSchedulerClient(Client):
    def __init__(self, sched: Optional[MemScheduler] = None,
                 weak: bool = False):
        self.sched = sched or MemScheduler(weak=weak)

    def open(self, test, node):
        return MemSchedulerClient(self.sched)

    def invoke(self, test, op: Op) -> Op:
        if op.f == "add-job":
            self.sched.jobs[op.value["name"]] = op.value
            return op.with_(type="ok")
        if op.f == "advance-clock":
            self.sched.clock = max(self.sched.clock, op.value)
            return op.with_(type="ok")
        if op.f == "read":
            return op.with_(type="ok", value=self.sched.read())
        raise ValueError(f"unknown op f={op.f!r}")


def job_generator(
    n_jobs: int = 6,
    horizon_s: float = 600.0,
    simulated: bool = True,
):
    """Add n_jobs jobs with varied cadences, let the horizon pass
    (advance the simulated clock in dummy mode; sleep real time
    against a live cluster), then one final read."""
    jobs = [
        {
            "name": f"job-{i}",
            "start": 10.0 * i,
            "interval": 60.0 + 10 * (i % 3),
            "count": 8,
            "epsilon": 10.0,
            "duration": 1.0,
        }
        for i in range(n_jobs)
    ]
    adds = [gen.once({"f": "add-job", "value": j}) for j in jobs]
    wait = (
        gen.clients(gen.once({"f": "advance-clock", "value": horizon_s}))
        if simulated
        else gen.clients([gen.sleep(horizon_s)])
    )
    return gen.phases(
        gen.clients(adds),
        wait,
        gen.clients(gen.once({"f": "read"})),
    )


def chronos_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    dummy = opts.pop("dummy", False)
    n_jobs = opts.pop("jobs", 6)
    weak = opts.pop("weak", False)
    horizon = opts.pop("horizon", 600.0)
    opts.pop("device", None)  # ScheduleChecker is host code

    test: Dict[str, Any] = {
        "name": "chronos",
        "os": Debian(),
        "db": ChronosDB(),
        "client": ChronosRestClient(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        "generator": job_generator(
            n_jobs, horizon_s=horizon, simulated=dummy
        ),
        "checker": ScheduleChecker(),
    }
    if dummy:
        test.pop("os")
        test.pop("db")
        test["client"] = MemSchedulerClient(weak=weak)
        test["net"] = netlib.MemNet()
    test.update(opts)
    return test


def main(argv=None) -> int:
    import argparse

    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.suites._backend import (
        EXIT_CRASH, add_backend_arg, backend_device, no_card,
    )

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.chronos")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--jobs", type=int, default=6)
    p.add_argument("--concurrency", type=int, default=3)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = chronos_test({
        "device": device,
        "dummy": args.dummy,
        "jobs": args.jobs,
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
