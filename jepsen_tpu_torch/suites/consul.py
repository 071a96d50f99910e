"""Consul suite: third single-file shape.

Reference: consul/src/jepsen/consul.clj (202 lines) — binary install +
agent daemons (one server bootstrap, the rest joining), a KV client
over the HTTP API with check-and-set via ModifyIndex, and the register
workload under a partitioner. Same skeleton as the etcd suite.
"""

from __future__ import annotations

import base64
import json
import random
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from jepsen_tpu_torch import independent, nemesis as nemlib, net as netlib
from jepsen_tpu_torch.checker import core as checker_core
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.checker.timeline import html_timeline
from jepsen_tpu_torch.control.util import start_daemon, stop_daemon
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

DIR = "/opt/consul"
BINARY = f"{DIR}/consul"
PIDFILE = f"{DIR}/consul.pid"
LOGFILE = f"{DIR}/consul.log"
VERSION = "1.17.0"


class ConsulDB(DB):
    """Install the consul binary; first node bootstraps as server, the
    rest join it (consul.clj's db setup shape)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node, session):
        url = (
            "https://releases.hashicorp.com/consul/"
            f"{self.version}/consul_{self.version}_linux_amd64.zip"
        )
        session.exec("mkdir", "-p", DIR, sudo=True)
        session.exec("chmod", "777", DIR, sudo=True)
        session.exec(
            "sh", "-c",
            f"test -f {BINARY} || (wget -q -O {DIR}/consul.zip {url} "
            f"&& unzip -o {DIR}/consul.zip -d {DIR})",
        )
        primary = test["nodes"][0]
        # -bind needs an IP (or go-sockaddr template), not a hostname;
        # -client binds the HTTP API on every interface.
        args = [
            "agent", "-server",
            "-bind", '{{ GetPrivateIP }}', "-client=0.0.0.0",
            f"-data-dir={DIR}/data", f"-node={node}",
            f"-bootstrap-expect={len(test['nodes'])}",
        ]
        if node != primary:
            args.append(f"-retry-join={primary}")
        start_daemon(
            session, BINARY, *args, pidfile=PIDFILE, logfile=LOGFILE,
        )
        import time

        # Leader election under bootstrap-expect takes a few seconds;
        # invoking before it completes just fills the history head with
        # indeterminate ops (same wait as EtcdDB.setup).
        time.sleep(test.get("db_start_wait", 5))

    def teardown(self, test, node, session):
        stop_daemon(session, PIDFILE)
        session.exec("rm", "-rf", f"{DIR}/data", sudo=True, check=False)

    def log_files(self, test, node):
        return [LOGFILE]


class ConsulClient(Client):
    """Keyed CAS register over the consul KV HTTP API: reads decode the
    base64 value + ModifyIndex; writes PUT; cas re-reads and PUTs with
    ?cas=<index> (false response body = lost the race)."""

    def __init__(self, node: Optional[str] = None, timeout_s: float = 5.0):
        self.node = node
        self.timeout_s = timeout_s

    def open(self, test, node):
        return ConsulClient(node, self.timeout_s)

    def _url(self, k, query: str = "") -> str:
        return (
            f"http://{self.node}:8500/v1/kv/jepsen/r{k}{query}"
        )

    def _request(self, url, data=None, method="GET"):
        req = urllib.request.Request(
            url,
            data=data.encode() if isinstance(data, str) else data,
            method=method,
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.read().decode()

    def _get(self, k):
        """-> (value or None, ModifyIndex or 0)"""
        try:
            body = json.loads(self._request(self._url(k)))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None, 0
            raise
        entry = body[0]
        raw = entry.get("Value")
        val = (
            int(base64.b64decode(raw).decode()) if raw is not None
            else None
        )
        return val, int(entry.get("ModifyIndex", 0))

    def invoke(self, test, op):
        kv = op.value
        if not isinstance(kv, independent.KV):
            raise ValueError(f"expected KV value, got {kv!r}")
        k, v = kv.key, kv.value
        try:
            if op.f == "read":
                val, _ = self._get(k)
                return op.with_(type="ok", value=independent.KV(k, val))
            if op.f == "write":
                self._request(self._url(k), data=str(v), method="PUT")
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = v
                try:
                    val, index = self._get(k)
                except (urllib.error.URLError, TimeoutError,
                        OSError) as e:
                    # The pre-read cannot mutate: a definite fail, not
                    # an indeterminate op.
                    return op.with_(type="fail", error=str(e))
                if val != old:
                    return op.with_(type="fail")
                out = self._request(
                    self._url(k, f"?cas={index}"), data=str(new),
                    method="PUT",
                )
                return op.with_(
                    type="ok" if out.strip() == "true" else "fail"
                )
            raise ValueError(f"unknown op f={op.f!r}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise  # indeterminate: the runtime records :info


def consul_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    dummy = opts.pop("dummy", False)
    device = opts.pop("device", None)
    time_limit_s = opts.pop("time_limit", None)

    from jepsen_tpu_torch.workloads.register import op_mix

    per_key_limit = opts.pop("per_key_limit", 100)
    nemesis_interval = opts.pop("nemesis_interval", 10)
    client_gen = independent.concurrent_generator(
        opts.pop("threads_per_key", 5),
        list(range(opts.pop("keys", 10))),
        lambda k: gen.limit(
            per_key_limit,
            gen.stagger(1 / 30, op_mix(rng), rng=rng),
        ),
    )
    nemesis_gen = gen.nemesis(gen.repeat(lambda: [
        gen.sleep(nemesis_interval), gen.once({"f": "start"}),
        gen.sleep(nemesis_interval), gen.once({"f": "stop"}),
    ]))
    g = gen.any_gen(gen.clients(client_gen), nemesis_gen)
    if time_limit_s:
        g = gen.time_limit(time_limit_s, g)
    test: Dict[str, Any] = {
        "name": "consul",
        "os": Debian(),
        "db": ConsulDB(),
        "client": ConsulClient(),
        "net": netlib.IptablesNet(),
        "nemesis": nemlib.partition_random_halves(rng=rng),
        "generator": g,
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
