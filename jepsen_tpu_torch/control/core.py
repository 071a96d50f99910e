"""Remote execution: the SSH control plane.

Reference semantics (jepsen/src/jepsen/control.clj):
- `exec` runs a command on the session's node, raising on nonzero exit
  with stdout/stderr attached (:122-135,173-179);
- shell escaping of each argument (:43-97);
- sudo/cd scoping wrap the command (:99-114);
- upload/download copy files (:196-230), with retries;
- a dummy mode stubs every call for cluster-less tests (:16,299-311);
- sessions transparently reconnect after transport errors, preserving
  the original exception (reconnect.clj:92-129).

Design departures: remotes are explicit objects (no dynamic-var
binding); transports are pluggable — SshRemote shells out to the
system ssh/scp binaries (connection-multiplexed via ControlMaster),
LocalRemote runs commands on this host (the single-machine/CI
backend), DummyRemote records commands and returns canned results
(the *dummy* analog, and the unit-test seam for nemeses/DBs).

The port's copy of jepsen_tpu.control.core, stdlib only; remote
command lines log through the jepsen_tpu_torch.control logger.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


import logging

_trace_log = logging.getLogger("jepsen_tpu_torch.control")


class RemoteError(RuntimeError):
    """Nonzero exit from a remote command (control.clj:122-135)."""

    def __init__(self, cmd, exit_code, out, err):
        super().__init__(
            f"command {cmd!r} exited {exit_code}: {err.strip() or out.strip()}"
        )
        self.cmd = cmd
        self.exit_code = exit_code
        self.out = out
        self.err = err


def escape(arg: Any) -> str:
    """Shell-escape one argument (the escape DSL, control.clj:43-97):
    keywords/numbers stringify; anything with shell metacharacters is
    quoted."""
    s = str(arg)
    return shlex.quote(s)


class Remote:
    """Transport interface: connect-per-node factories."""

    def connect(self, node: str) -> "Remote":
        return self

    def execute(self, cmd: Sequence[Any], sudo: bool = False,
                cd: Optional[str] = None,
                stdin: Optional[str] = None) -> Tuple[int, str, str]:
        raise NotImplementedError

    def upload(self, local: str, remote: str) -> None:
        raise NotImplementedError

    def download(self, remote: str, local: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _wrap(cmd: Sequence[Any], sudo: bool, cd: Optional[str]) -> str:
    """Render a command string with sudo/cd scoping
    (control.clj:99-114)."""
    s = " ".join(escape(c) for c in cmd)
    if cd:
        s = f"cd {escape(cd)} && {s}"
    if sudo:
        s = f"sudo -n sh -c {escape(s)}"
    return s


class LocalRemote(Remote):
    """Runs commands on this host — the single-machine backend and the
    integration-test seam for daemon/net helpers."""

    def __init__(self, node: str = "local"):
        self.node = node

    def connect(self, node: str) -> "LocalRemote":
        return LocalRemote(node)

    def execute(self, cmd, sudo=False, cd=None, stdin=None):
        # Already-root hosts (containers) often lack a sudo binary;
        # the escalation is a no-op there, so elide it.
        if sudo and os.geteuid() == 0:
            sudo = False
        p = subprocess.run(
            ["sh", "-c", _wrap(cmd, sudo, cd)],
            capture_output=True,
            text=True,
            input=stdin,
        )
        return p.returncode, p.stdout, p.stderr

    def upload(self, local: str, remote: str) -> None:
        subprocess.run(["cp", local, remote], check=True)

    def download(self, remote: str, local: str) -> None:
        subprocess.run(["cp", remote, local], check=True)


class SshRemote(Remote):
    """SSH/SCP via the system binaries, multiplexed with ControlMaster
    so each exec reuses one TCP connection (the persistent-session
    analog of control.clj:279-312)."""

    def __init__(
        self,
        node: str = "",
        username: Optional[str] = None,
        port: int = 22,
        private_key_path: Optional[str] = None,
        strict_host_key_checking: bool = False,
        control_path: Optional[str] = None,
    ):
        self.node = node
        self.username = username
        self.port = port
        self.private_key_path = private_key_path
        self.strict = strict_host_key_checking
        self.control_path = control_path or "/tmp/jepsen-ssh-%r@%h:%p"

    def connect(self, node: str) -> "SshRemote":
        return SshRemote(
            node,
            self.username,
            self.port,
            self.private_key_path,
            self.strict,
            self.control_path,
        )

    def _dest(self) -> str:
        return f"{self.username}@{self.node}" if self.username else self.node

    def _opts(self) -> List[str]:
        opts = [
            "-o", "ControlMaster=auto",
            "-o", f"ControlPath={self.control_path}",
            "-o", "ControlPersist=60",
            "-o", "BatchMode=yes",
            "-p", str(self.port),
        ]
        if not self.strict:
            opts += ["-o", "StrictHostKeyChecking=no"]
        if self.private_key_path:
            opts += ["-i", self.private_key_path]
        return opts

    def execute(self, cmd, sudo=False, cd=None, stdin=None):
        p = subprocess.run(
            ["ssh"] + self._opts() + [self._dest(), _wrap(cmd, sudo, cd)],
            capture_output=True,
            text=True,
            input=stdin,
        )
        return p.returncode, p.stdout, p.stderr

    def _scp_opts(self) -> List[str]:
        opts = [
            "-o", "ControlMaster=auto",
            "-o", f"ControlPath={self.control_path}",
            "-o", "BatchMode=yes",
            "-P", str(self.port),
        ]
        if not self.strict:
            opts += ["-o", "StrictHostKeyChecking=no"]
        if self.private_key_path:
            opts += ["-i", self.private_key_path]
        return opts

    def upload(self, local: str, remote: str) -> None:
        subprocess.run(
            ["scp"] + self._scp_opts() + [local, f"{self._dest()}:{remote}"],
            check=True,
            capture_output=True,
        )

    def download(self, remote: str, local: str) -> None:
        subprocess.run(
            ["scp"] + self._scp_opts() + [f"{self._dest()}:{remote}", local],
            check=True,
            capture_output=True,
        )


class DummyRemote(Remote):
    """Records every call; answers from a response table — the *dummy*
    mode (control.clj:16,299-311) plus a scriptable seam for tests."""

    def __init__(self, responses: Optional[Dict[str, Tuple]] = None,
                 _log=None, node: str = "dummy"):
        self.node = node
        #: substring -> (exit, out, err)
        self.responses = responses or {}
        self.log: List[dict] = _log if _log is not None else []
        self._lock = threading.Lock()

    def connect(self, node: str) -> "DummyRemote":
        return DummyRemote(self.responses, self.log, node)

    def execute(self, cmd, sudo=False, cd=None, stdin=None):
        line = _wrap(cmd, sudo, cd)
        with self._lock:
            self.log.append(
                {"node": self.node, "type": "exec", "cmd": line}
            )
        for pat, resp in self.responses.items():
            if pat in line:
                return resp
        return 0, "", ""

    def upload(self, local, remote):
        with self._lock:
            self.log.append(
                {"node": self.node, "type": "upload",
                 "local": local, "remote": remote}
            )

    def download(self, remote, local):
        with self._lock:
            self.log.append(
                {"node": self.node, "type": "download",
                 "remote": remote, "local": local}
            )

    def commands(self, node: Optional[str] = None) -> List[str]:
        with self._lock:
            return [
                e["cmd"] for e in self.log
                if e["type"] == "exec" and (node is None or e["node"] == node)
            ]


class Session:
    """A per-node session with retries and transparent reconnection.

    exec() raises RemoteError on nonzero exit (like control.clj's
    throw-on-nonzero-exit) and retries transport-level failures with
    backoff, reconnecting between attempts (reconnect.clj:92-129 +
    control.clj:137-158).
    """

    def __init__(self, remote: Remote, node: str, retries: int = 5,
                 backoff_s: float = 0.2):
        self._factory = remote
        self.node = node
        self.retries = retries
        self.backoff_s = backoff_s
        self._conn = remote.connect(node)
        self._lock = threading.Lock()

    def reconnect(self) -> None:
        with self._lock:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = self._factory.connect(self.node)

    def exec(self, *cmd, sudo: bool = False, cd: Optional[str] = None,
             stdin: Optional[str] = None, check: bool = True) -> str:
        # Command audit trace (control.clj:19,117-121's *trace*): every
        # remote command logs through jepsen_tpu_torch.control, which the run
        # directory's jepsen.log captures.
        _trace_log.debug("%s$ %s", self.node, _wrap(cmd, sudo, cd))
        last: Optional[BaseException] = None
        for attempt in range(self.retries):
            try:
                code, out, err = self._conn.execute(
                    cmd, sudo=sudo, cd=cd, stdin=stdin
                )
            except Exception as e:  # transport failure: reconnect+retry
                last = e
                self.reconnect()
                time.sleep(self.backoff_s * (attempt + 1))
                continue
            if code != 0 and check:
                raise RemoteError(cmd, code, out, err)
            return out
        raise last  # type: ignore[misc]

    def upload(self, local: str, remote_path: str) -> None:
        for attempt in range(self.retries):
            try:
                self._conn.upload(local, remote_path)
                return
            except Exception as e:
                if attempt == self.retries - 1:
                    raise
                self.reconnect()
                time.sleep(self.backoff_s * (attempt + 1))

    def download(self, remote_path: str, local: str) -> None:
        for attempt in range(self.retries):
            try:
                self._conn.download(remote_path, local)
                return
            except Exception as e:
                if attempt == self.retries - 1:
                    raise
                self.reconnect()
                time.sleep(self.backoff_s * (attempt + 1))

    def close(self) -> None:
        self._conn.close()


def sessions_for(test: dict) -> Dict[str, Session]:
    """One session per test node, from the test's remote factory
    (test["remote"], default DummyRemote)."""
    remote = test.get("remote") or DummyRemote()
    out = test.setdefault("_sessions", {})
    for node in test.get("nodes", []):
        if node not in out:
            out[node] = Session(remote, node)
    return out


def on_nodes(
    test: dict,
    fn: Callable[[str, Session], Any],
    nodes: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Run fn(node, session) on many nodes in parallel (the on-nodes
    fan-out, control.clj:357-393). Returns {node: result}; exceptions
    propagate after all complete."""
    sess = sessions_for(test)
    nodes = list(nodes if nodes is not None else test.get("nodes", []))
    results: Dict[str, Any] = {}
    errors: Dict[str, BaseException] = {}

    def run_one(n):
        try:
            results[n] = fn(n, sess[n])
        except BaseException as e:
            errors[n] = e

    threads = [
        threading.Thread(target=run_one, args=(n,), daemon=True)
        for n in nodes
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        node, err = sorted(errors.items())[0]
        raise RuntimeError(f"on_nodes failed on {node}: {err}") from err
    return results
