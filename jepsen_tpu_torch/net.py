"""Network manipulation: the Net protocol and its backends.

Reference: jepsen/src/jepsen/net.clj — protocol drop!/heal!/slow!/
flaky!/fast! (:14-25), grudge application drop-all! with the bulk
PartitionAll fast path (:28-43,100-109), the iptables backend
(:57-109), and a noop.

Backends here:
- IptablesNet: emits the same iptables/tc command shapes over the
  control plane (works against SshRemote, LocalRemote, or DummyRemote
  — the latter makes the exact command lines unit-testable without a
  cluster).
- MemNet: an IN-PROCESS network: a connectivity matrix consulted by
  in-memory clients/DBs. This is the analog of the reference's Docker
  harness — partitions become data, so the whole
  nemesis->net->client->checker loop runs (and is tested) with zero
  infrastructure.
- NoopNet.

The port's copy of jepsen_tpu.net; tests/test_torch_nemesis.py holds the
two against each other.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Set, Tuple

from jepsen_tpu_torch.control.core import Session, on_nodes


class Net:
    """Protocol (net.clj:14-25)."""

    def drop(self, test, src, dest) -> None:
        raise NotImplementedError

    def heal(self, test) -> None:
        raise NotImplementedError

    def slow(self, test, mean_ms: float = 50, variance_ms: float = 10,
             distribution: str = "normal") -> None:
        raise NotImplementedError

    def flaky(self, test) -> None:
        raise NotImplementedError

    def fast(self, test) -> None:
        raise NotImplementedError

    # PartitionAll fast path (net/proto.clj:5-12); default expands the
    # grudge into pairwise drops (net.clj:28-43).
    def drop_all(self, test, grudge: Dict[str, Iterable[str]]) -> None:
        for dst, srcs in grudge.items():
            for src in srcs:
                self.drop(test, src, dst)


class NoopNet(Net):
    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, **kw):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass


class MemNet(Net):
    """In-process connectivity matrix. Clients for in-memory DBs call
    allows(src, dst) before 'sending'; partitions and healing are plain
    data mutations, which makes full partition tests runnable in-process
    (the role the reference delegates to Docker/LXC harnesses)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dropped: Set[Tuple[str, str]] = set()

    def allows(self, src: str, dst: str) -> bool:
        with self._lock:
            return (src, dst) not in self._dropped

    def drop(self, test, src, dest) -> None:
        with self._lock:
            self._dropped.add((src, dest))

    def heal(self, test) -> None:
        with self._lock:
            self._dropped.clear()

    def slow(self, test, **kw) -> None:
        pass

    def flaky(self, test) -> None:
        pass

    def fast(self, test) -> None:
        pass

    def dropped_pairs(self) -> Set[Tuple[str, str]]:
        with self._lock:
            return set(self._dropped)


class IptablesNet(Net):
    """iptables/tc command emission over the control plane
    (net.clj:57-109). Node IPs resolve via getent with a per-test memo
    (control/net.clj:7-34)."""

    def _ip(self, test, session: Session, node: str) -> str:
        cache = test.setdefault("_ip_cache", {})
        if node not in cache:
            out = session.exec("getent", "ahosts", node, check=False)
            first = out.split()
            cache[node] = first[0] if first else node
        return cache[node]

    def drop(self, test, src, dest) -> None:
        from jepsen_tpu_torch.control.core import sessions_for

        sess = sessions_for(test)[dest]
        ip = self._ip(test, sess, src)
        sess.exec(
            "iptables", "-A", "INPUT", "-s", ip, "-j", "DROP", "-w",
            sudo=True,
        )

    def heal(self, test) -> None:
        def fn(node, sess):
            sess.exec("iptables", "-F", "-w", sudo=True)
            sess.exec("iptables", "-X", "-w", sudo=True)

        on_nodes(test, fn)

    def slow(self, test, mean_ms=50, variance_ms=10,
             distribution="normal") -> None:
        def fn(node, sess):
            sess.exec(
                "/sbin/tc", "qdisc", "add", "dev", "eth0", "root",
                "netem", "delay", f"{mean_ms}ms", f"{variance_ms}ms",
                "distribution", distribution, sudo=True,
            )

        on_nodes(test, fn)

    def flaky(self, test) -> None:
        def fn(node, sess):
            sess.exec(
                "/sbin/tc", "qdisc", "add", "dev", "eth0", "root",
                "netem", "loss", "20%", "75%", sudo=True,
            )

        on_nodes(test, fn)

    def fast(self, test) -> None:
        def fn(node, sess):
            sess.exec(
                "/sbin/tc", "qdisc", "del", "dev", "eth0", "root",
                sudo=True, check=False,
            )

        on_nodes(test, fn)

    def drop_all(self, test, grudge) -> None:
        # Bulk fast path: one iptables rule per node with all snubbed
        # sources joined (net.clj:100-109).
        def fn(node, sess):
            srcs = list(grudge.get(node, ()))
            if not srcs:
                return
            ips = ",".join(self._ip(test, sess, s) for s in srcs)
            sess.exec(
                "iptables", "-A", "INPUT", "-s", ips, "-j", "DROP",
                "-w", sudo=True,
            )

        on_nodes(test, fn, [n for n in grudge])


class IpfilterNet(IptablesNet):
    """SmartOS/illumos backend (net.clj:111-143): partitions via ipf
    rules piped on stdin, sources resolved to IPs through the
    inherited getent memo. The tc/netem verbs are Linux-only, so
    slow/flaky raise rather than silently run a missing binary; fast
    is the heal-side no-op."""

    def drop(self, test, src, dest) -> None:
        from jepsen_tpu_torch.control.core import sessions_for

        sess = sessions_for(test)[dest]
        ip = self._ip(test, sess, src)
        sess.exec(
            "sh", "-c", "ipf -f -", sudo=True,
            stdin=f"block in from {ip} to any\n",
        )

    def heal(self, test) -> None:
        def fn(node, sess):
            sess.exec("ipf", "-Fa", sudo=True)

        on_nodes(test, fn)

    def drop_all(self, test, grudge) -> None:
        def fn(node, sess):
            srcs = list(grudge.get(node, ()))
            if not srcs:
                return
            rules = "".join(
                f"block in from {self._ip(test, sess, s)} to any\n"
                for s in srcs
            )
            sess.exec("sh", "-c", "ipf -f -", sudo=True, stdin=rules)

        on_nodes(test, fn, [n for n in grudge])

    def slow(self, test, **kw) -> None:
        raise NotImplementedError(
            "tc/netem is Linux-only; illumos has no slow! backend "
            "(the reference's ipfilter impl emits the same Linux tc "
            "commands there — net.clj:121-134 — which cannot work; "
            "this port surfaces the limitation instead)"
        )

    def flaky(self, test) -> None:
        raise NotImplementedError(
            "tc/netem is Linux-only; illumos has no flaky! backend"
        )

    def fast(self, test) -> None:
        pass  # nothing to undo: slow/flaky are unsupported


def drop_all(test, grudge) -> None:
    """Apply a grudge map {node: nodes-to-drop-traffic-from} through
    the test's net (net.clj:28-43)."""
    test.get("net", NoopNet()).drop_all(test, grudge)


def heal(test) -> None:
    test.get("net", NoopNet()).heal(test)
