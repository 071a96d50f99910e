"""RabbitMQ suite: mirrored queue conservation.

Reference: rabbitmq/src/jepsen/rabbitmq.clj (340 LoC) — deb install
with a shared erlang cookie, stop_app/join_cluster/start_app cluster
assembly gated on the synchronize barrier (:24-88), an ha-majority
mirroring policy (:83), a queue client publishing with confirms and
draining at the end, and a queue-lock mutex variant.

Real mode publishes/consumes through `rabbitmqadmin` on the nodes (the
management CLI speaks HTTP locally); dummy mode reuses the in-memory
queue primitive. Checker: total-queue conservation with final drain
(jepsen/src/jepsen/checker.clj:570-629's role).
"""

from __future__ import annotations

import itertools
import json
import random
from typing import Any, Callable, Dict, Optional

from jepsen_tpu_torch import net as netlib, nemesis as nemlib
from jepsen_tpu_torch.checker import core as checker_core, reductions
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.control.core import sessions_for
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed
from jepsen_tpu_torch.runtime.core import synchronize

VERSION = "3.5.6"
QUEUE = "jepsen.queue"


class RabbitDB(DB):
    """Deb install + erlang cookie + join_cluster (rabbitmq.clj:24-88).
    """

    def setup(self, test, node, session):
        deb = f"rabbitmq-server_{VERSION}-1_all.deb"
        session.exec(
            "wget", "-nv",
            f"http://www.rabbitmq.com/releases/rabbitmq-server/"
            f"v{VERSION}/{deb}",
            check=False,
        )
        session.exec("apt-get", "install", "-y", "erlang-nox", sudo=True)
        session.exec("dpkg", "-i", deb, sudo=True, check=False)
        session.exec(
            "sh", "-c",
            "echo jepsen-rabbitmq > /var/lib/rabbitmq/.erlang.cookie",
            sudo=True,
        )
        session.exec(
            "service", "rabbitmq-server", "restart", sudo=True
        )
        primary = test["nodes"][0]
        if node != primary:
            session.exec("rabbitmqctl", "stop_app", sudo=True)
        synchronize(test)  # everyone up before joins start
        if node != primary:
            session.exec(
                "rabbitmqctl", "join_cluster", f"rabbit@{primary}",
                sudo=True,
            )
            session.exec("rabbitmqctl", "start_app", sudo=True)
        # majority mirroring for jepsen.* queues (rabbitmq.clj:83)
        session.exec(
            "rabbitmqctl", "set_policy", "ha-maj", "jepsen.",
            '{"ha-mode": "exactly", "ha-params": 3, '
            '"ha-sync-mode": "automatic"}',
            sudo=True,
        )

    def teardown(self, test, node, session):
        session.exec(
            "rabbitmqctl", "force_reset", sudo=True, check=False
        )

    def log_files(self, test, node):
        return [f"/var/log/rabbitmq/rabbit@{node}.log"]


class RabbitQueueClient(Client):
    """Queue ops through rabbitmqadmin on the node: publish with
    confirm semantics (crash -> :info), get with ack (empty -> :fail).
    """

    def __init__(self, node: Optional[str] = None):
        self.node = node

    def open(self, test, node):
        return RabbitQueueClient(node)

    def _admin(self, test, *args) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec("rabbitmqadmin", "-f", "raw_json", *args)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "enqueue":
                self._admin(
                    test, "publish", "routing_key=" + QUEUE,
                    f"payload={json.dumps(op.value)}",
                )
                return op.with_(type="ok")
            if op.f in ("dequeue", "drain"):
                n = 1 if op.f == "dequeue" else 10_000
                out = self._admin(
                    test, "get", "queue=" + QUEUE, f"count={n}",
                    "ackmode=ack_requeue_false",
                )
                vals = [
                    json.loads(m["payload"])
                    for m in json.loads(out or "[]")
                ]
                if op.f == "drain":
                    return op.with_(type="ok", value=vals)
                if not vals:
                    return op.with_(type="fail")
                return op.with_(type="ok", value=vals[0])
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "dequeue":
                raise ClientFailed(str(e))
            raise  # enqueue/drain crash to :info


def rabbitmq_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    dummy = opts.pop("dummy", False)
    device = opts.pop("device", None)
    n_ops = opts.pop("ops", 200)
    time_limit_s = opts.pop("time_limit", None)
    counter = itertools.count()

    def enq():
        return {"f": "enqueue", "value": next(counter)}

    generator = gen.clients(gen.limit(
        n_ops, gen.mix([enq, {"f": "dequeue"}], rng=rng)
    ))
    if time_limit_s:
        generator = gen.time_limit(time_limit_s, generator)
    test: Dict[str, Any] = {
        "name": "rabbitmq",
        "os": Debian(),
        "db": RabbitDB(),
        "client": RabbitQueueClient(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        "generator": generator,
        # the drain must survive the time limit or surviving messages
        # read as lost (runtime composes final_generator after it)
        "final_generator": gen.clients(
            gen.each_thread(gen.once({"f": "drain"}))
        ),
        "checker": checker_core.compose({
            "total-queue": reductions.total_queue(),
            "linearizable": LinearizableChecker(
                model="unordered-queue", device=device
            ),
        }),
    }
    if dummy:
        from jepsen_tpu_torch.suites.hazelcast import QueueClient

        test.pop("os")
        test.pop("db")
        test["client"] = QueueClient()
        test["net"] = netlib.MemNet()
    test.update(opts)
    return test


def main(argv=None) -> int:
    import argparse

    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.suites._backend import (
        EXIT_CRASH, add_backend_arg, backend_device, no_card,
    )

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.rabbitmq")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--ops", type=int, default=200)
    p.add_argument("--time-limit", type=float, default=30.0)
    p.add_argument("--concurrency", type=int, default=5)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = rabbitmq_test({
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
