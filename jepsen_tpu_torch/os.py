"""OS automation: prepare nodes before the DB installs.

Reference: jepsen/src/jepsen/os.clj (2-method protocol) and
os/debian.clj (package install, hostfile fix, base tooling
:13-174). The debian implementation here covers the base-setup subset
the fault plane needs (iptables/tc/ntp tooling present, hosts file
mapping test nodes); package installation is idempotent.

The port's copy of jepsen_tpu.os; tests/test_torch_db_control.py holds
the two against each other.
"""

from __future__ import annotations

from typing import Dict, Iterable

from jepsen_tpu_torch.control.core import RemoteError, Session


class OS:
    """Protocol (os.clj:4-8)."""

    def setup(self, test, node: str, session: Session) -> None:
        pass

    def teardown(self, test, node: str, session: Session) -> None:
        pass

    def setup_hostfile(self, test, node: str, session: Session) -> None:
        """Map every test node name in /etc/hosts (os/debian.clj's
        hostfile fix — OS-independent, so every flavor shares it)."""
        lines = ["127.0.0.1 localhost"]
        for n in test.get("nodes", []):
            ip = test.get("node_ips", {}).get(n)
            if ip:
                lines.append(f"{ip} {n}")
        content = "\n".join(lines) + "\n"
        session.exec(
            "sh", "-c", "cat > /etc/hosts", sudo=True, stdin=content
        )


noop = OS


class Debian(OS):
    """Debian-family setup (os/debian.clj:139-174): install the base
    packages the nemeses rely on and pin the hosts file so test node
    names resolve."""

    BASE_PACKAGES = (
        "curl", "faketime", "iptables", "psmisc", "tar", "unzip",
        "iputils-ping", "iproute2", "logrotate",
    )

    def __init__(self, extra_packages: Iterable[str] = ()):
        self.packages = list(self.BASE_PACKAGES) + list(extra_packages)

    def installed(self, session: Session, pkgs) -> Dict[str, bool]:
        out = session.exec(
            "dpkg-query", "-W", "-f", "${Package}\\n", *pkgs, check=False
        )
        have = set(out.split())
        return {p: p in have for p in pkgs}

    def setup(self, test, node: str, session: Session) -> None:
        missing = [
            p for p, ok in self.installed(session, self.packages).items()
            if not ok
        ]
        if missing:
            session.exec(
                "env", "DEBIAN_FRONTEND=noninteractive",
                "apt-get", "install", "-y", *missing, sudo=True,
            )
        self.setup_hostfile(test, node, session)


class Ubuntu(Debian):
    """Ubuntu setup (os/ubuntu.clj): the Debian recipe verbatim — the
    reference's ubuntu namespace delegates to debian with a different
    sources.list, which the image provides here."""


class Centos(OS):
    """RHEL-family setup (os/centos.clj): same base tooling over yum."""

    BASE_PACKAGES = (
        "curl", "iptables", "psmisc", "tar", "unzip", "iputils",
        "iproute", "logrotate",
    )

    def __init__(self, extra_packages: Iterable[str] = ()):
        self.packages = list(self.BASE_PACKAGES) + list(extra_packages)

    def setup(self, test, node: str, session: Session) -> None:
        session.exec(
            "yum", "install", "-y", *self.packages, sudo=True,
            check=False,
        )
        self.setup_hostfile(test, node, session)


class SmartOS(OS):
    """SmartOS/illumos setup (os/smartos.clj): pkgin tooling; the net
    plane pairs with IpfilterNet (net.clj:111-143) since there is no
    iptables."""

    BASE_PACKAGES = ("curl", "gtar", "unzip")

    def __init__(self, extra_packages: Iterable[str] = ()):
        self.packages = list(self.BASE_PACKAGES) + list(extra_packages)

    def setup(self, test, node: str, session: Session) -> None:
        session.exec(
            "pkgin", "-y", "install", *self.packages, sudo=True,
            check=False,
        )
        # ipfilter must be enabled for the partition nemesis
        session.exec(
            "svcadm", "enable", "network/ipfilter", sudo=True,
            check=False,
        )
        self.setup_hostfile(test, node, session)
