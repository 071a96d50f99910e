"""Disk-fault injection drivers: mount-level FUSE and LD_PRELOAD shim.

Reference: charybdefs/src/jepsen/charybdefs.clj — build the fault
filesystem on the node (:7-65) and flip faults at runtime: every op
EIO (:67-72), a percentage of ops (:74-79), clear (:81-85).

Two native backends, both built on-node from resources/:

1. **fusefaultfs.cc — the primary, charybdefs-parity backend.** A
   raw-protocol FUSE passthrough mounted over the data directory
   (install_fuse + FuseFaultFSNemesis). Because the interception is at
   the VFS mount, it afflicts ANY process — including statically-linked
   Go binaries (etcd, consul) that no userspace interposer can touch.
   Runtime control is the `.faultfs-ctl` file at the mount root (the
   Thrift-server role in charybdefs, with no RPC stack to install).
2. **faultfs.cc — LD_PRELOAD interposer fallback** for environments
   where FUSE mounts are unavailable (no /dev/fuse in the container,
   no CAP_SYS_ADMIN): libc-dynamic databases only; the DB starts with
   `env_for(...)` in its daemon environment and the nemesis mutates
   the per-node config file over the control plane.

The port's copy of jepsen_tpu.faultfs, but for the shim's build flags
(SHIM_FLAGS); tests/test_torch_faultfs.py holds the two against each
other and pins that departure.
"""

from __future__ import annotations

import errno
import os
from typing import Dict, Optional

from jepsen_tpu_torch.control.core import Session, on_nodes
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.nemesis import Nemesis

TOOL_DIR = "/opt/jepsen-tpu"
SO_PATH = f"{TOOL_DIR}/faultfs.so"
#: the shim's g++ flags. -U_FORTIFY_SOURCE departs from the reference:
#: where the compiler defines _FORTIFY_SOURCE by default (Ubuntu's g++
#: at -O2), glibc declares pread as an always-inline wrapper and the
#: shim's own pread64 -> pread call fails to build ("inlining failed in
#: call to always_inline"); the interposer must see the plain symbols
SHIM_FLAGS = ("-O2", "-shared", "-fPIC", "-U_FORTIFY_SOURCE")
_RES = os.path.join(os.path.dirname(__file__), "resources")


def conf_path(prefix: str) -> str:
    """Per-prefix config file, so two daemons afflicted on different
    directories stay independently controllable."""
    import hashlib

    tag = hashlib.sha256(prefix.encode()).hexdigest()[:12]
    return f"{TOOL_DIR}/faultfs-{tag}.conf"


def install(session: Session) -> None:
    """Upload + compile the shim on a node (the build-on-node discipline
    of charybdefs.clj:40-55, minus the Thrift toolchain)."""
    session.exec("mkdir", "-p", TOOL_DIR, sudo=True)
    session.exec("chmod", "777", TOOL_DIR, sudo=True)
    src = f"{TOOL_DIR}/faultfs.cc"
    session.upload(os.path.join(_RES, "faultfs.cc"), src)
    session.exec("g++", *SHIM_FLAGS, "-o", SO_PATH, src, "-ldl")


def env_for(prefix: str) -> Dict[str, str]:
    """Daemon environment enabling the shim for paths under prefix —
    pass to control.util.start_daemon(env=...)."""
    return {
        "LD_PRELOAD": SO_PATH,
        "JEPSEN_FAULTFS_CONF": conf_path(prefix),
    }


def write_config(
    session: Session,
    prefix: str,
    mode: str = "none",
    err: int = errno.EIO,
    probability: int = 0,
    delay_us: int = 0,
) -> None:
    conf = (
        f"prefix={prefix}\nmode={mode}\nerrno={err}\n"
        f"probability={probability}\ndelay_us={delay_us}\n"
    )
    session.exec(
        "sh", "-c", f"cat > {conf_path(prefix)}", stdin=conf
    )


def _dispatch_per_node(test, op: Op, fn) -> Op:
    """Shared nemesis dispatch: the op value is a scalar applied to
    all nodes, or {node: scalar} applying each node its own spec;
    ``fn(node, session, value)`` runs per targeted node and its
    results become the info op's value."""
    value = op.value
    if isinstance(value, dict) and value and all(
        n in test["nodes"] for n in value
    ):
        per_node = dict(value)
    else:
        per_node = {n: value for n in test["nodes"]}
    return op.with_(
        type="info",
        value=on_nodes(
            test,
            lambda node, sess: fn(node, sess, per_node[node]),
            list(per_node),
        ),
    )


class FaultFSNemesis(Nemesis):
    """f-routed disk faults (charybdefs.clj:67-85):

    - start: every file op under the prefix fails EIO
    - flaky: value = percent of ops failing (default 1, like the
      reference's 1%-failure mode)
    - delay: value = microseconds added per op
    - clear: faults off

    Op values may instead be {node: spec} dicts to target subsets.
    """

    def __init__(self, prefix: str):
        self.prefix = prefix

    def setup(self, test) -> "FaultFSNemesis":
        def fn(node, sess):
            install(sess)
            write_config(sess, self.prefix, mode="none")

        on_nodes(test, fn)
        return self

    def invoke(self, test, op: Op) -> Op:
        def kw_for(v) -> dict:
            if op.f == "start":
                return {"mode": "fail"}
            if op.f == "flaky":
                return {"mode": "flaky",
                        "probability": int(v) if v is not None else 1}
            if op.f == "delay":
                return {"mode": "delay",
                        "delay_us": int(v) if v is not None else 100_000}
            if op.f in ("clear", "stop"):
                return {"mode": "none"}
            raise ValueError(f"faultfs nemesis can't handle f={op.f!r}")

        def fn(node, sess, v):
            kw = kw_for(v)
            write_config(sess, self.prefix, **kw)
            return kw["mode"]

        return _dispatch_per_node(test, op, fn)

    def teardown(self, test) -> None:
        try:
            on_nodes(
                test,
                lambda node, sess: write_config(
                    sess, self.prefix, mode="none"
                ),
            )
        except Exception:
            pass


def faultfs_nemesis(prefix: str) -> FaultFSNemesis:
    return FaultFSNemesis(prefix)


# -- FUSE mount backend (charybdefs parity) ----------------------------------

FUSE_BIN = f"{TOOL_DIR}/fusefaultfs"
CTL_NAME = ".faultfs-ctl"


def install_fuse(
    session: Session,
    backing: str,
    mountpoint: str,
) -> None:
    """Upload + compile + mount the FUSE fault filesystem on a node
    (charybdefs.clj:40-65's install!: build on node, mount backing
    over mountpoint). The daemon self-daemonizes; re-running replaces
    any prior mount."""
    session.exec("mkdir", "-p", TOOL_DIR, backing, mountpoint,
                 sudo=True)
    session.exec("chmod", "777", TOOL_DIR, backing, mountpoint,
                 sudo=True)
    src = f"{TOOL_DIR}/fusefaultfs.cc"
    session.upload(os.path.join(_RES, "fusefaultfs.cc"), src)
    session.exec(
        "g++", "-O3", "-std=c++17", "-o", FUSE_BIN, src,
    )
    # Replace, don't stack: a prior daemon (and its mount) may still
    # be alive from an earlier setup; a busy mount needs the lazy
    # detach. pkill -x matches the binary's comm exactly — never this
    # wrapper shell.
    session.exec(
        "sh", "-c",
        "pkill -x fusefaultfs 2>/dev/null; "
        f"umount {mountpoint} 2>/dev/null || "
        f"umount -l {mountpoint} 2>/dev/null || true",
        sudo=True,
    )
    session.exec(FUSE_BIN, backing, mountpoint, sudo=True)


def fuse_ctl(session: Session, mountpoint: str, command: str) -> None:
    """Send a control command to a mounted fault filesystem:
    clear | break <class> [errno N] | flaky <class> <basis_points>
    [errno N] | delay <class> <us> | filter <substr|->  where class is
    all|read|write|meta (charybdefs.clj:67-85's fault API)."""
    session.exec(
        "sh", "-c", f"cat > {mountpoint}/{CTL_NAME}", stdin=command,
        sudo=True,
    )


def fuse_status(session: Session, mountpoint: str) -> str:
    return session.exec("cat", f"{mountpoint}/{CTL_NAME}", sudo=True)


def fuse_unmount(session: Session, mountpoint: str) -> None:
    session.exec(
        "sh", "-c",
        f"umount {mountpoint} 2>/dev/null || "
        f"umount -l {mountpoint} 2>/dev/null || true",
        sudo=True,
    )


class FuseFaultFSNemesis(Nemesis):
    """Mount-level disk faults (charybdefs.clj:67-85) — afflicts any
    process writing through the mount, statically-linked included:

    - start: every file op under the mount fails EIO (break-all)
    - flaky: value = percent of ops failing (default 1, the
      reference's break-one-percent)
    - delay: value = microseconds added per op
    - clear / stop: faults off

    Op values may instead be {node: spec} dicts to target subsets.
    """

    def __init__(self, backing: str, mountpoint: str,
                 install: bool = True):
        self.backing = backing
        self.mountpoint = mountpoint
        #: False when the DB's setup already mounted the filesystem
        #: (required when the daemon must open its data dir THROUGH
        #: the mount from the start — a later mount would hide the
        #: files its open fds still point at).
        self.install = install

    def setup(self, test) -> "FuseFaultFSNemesis":
        if self.install:
            on_nodes(
                test,
                lambda node, sess: install_fuse(
                    sess, self.backing, self.mountpoint
                ),
            )
        return self

    def invoke(self, test, op: Op) -> Op:
        def cmd_for(v) -> str:
            if op.f == "start":
                return "break all"
            if op.f == "flaky":
                pct = float(v) if v is not None else 1.0
                return f"flaky all {int(pct * 100)}"
            if op.f == "delay":
                us = int(v) if v is not None else 100_000
                return f"delay all {us}"
            if op.f in ("clear", "stop"):
                return "clear"
            raise ValueError(
                f"fuse faultfs nemesis can't handle f={op.f!r}"
            )

        def fn(node, sess, v):
            cmd = cmd_for(v)
            fuse_ctl(sess, self.mountpoint, cmd)
            return cmd

        return _dispatch_per_node(test, op, fn)

    def teardown(self, test) -> None:
        try:
            on_nodes(
                test,
                lambda node, sess: fuse_ctl(
                    sess, self.mountpoint, "clear"
                ),
            )
        except Exception:
            pass


def fuse_faultfs_nemesis(
    backing: str, mountpoint: str, install: bool = True
) -> FuseFaultFSNemesis:
    return FuseFaultFSNemesis(backing, mountpoint, install=install)
