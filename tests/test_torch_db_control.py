"""The port's control plane and DB lifecycle (jepsen_tpu_torch.control,
jepsen_tpu_torch.db) against the JAX package's, on the CPU.

The control, OS and DB cases of tests/test_db_os.py run against both
packages, as one test parametrised by package: the cycle with its
retries and its give-up, the run's lifecycle around the workers (each
package's os.Debian in the OS slot), log snarfing, the Debian package
install and hosts file, and control/util.py's start_daemon with its env
riding through `env` (on the DummyRemote) and applying (through a real
shell). The Debian, Ubuntu, Centos and SmartOS setups and the daemon
helpers record equal command lists on both packages. Then
the control plane itself: DummyRemote's command log and response
table, sudo and cd scoping, Session's retries on a transport fault and
its RemoteError on a nonzero exit, on_nodes' fan-out and error, a real
LocalRemote on this host, and SshRemote's rendered options (never
run). Each case runs on both packages and the observable results must
be equal. Tolerance: exact."""

import logging
import threading
import time
from types import SimpleNamespace

import pytest

from jepsen_tpu import db as r_db
from jepsen_tpu import os as r_os
from jepsen_tpu.control import core as r_control
from jepsen_tpu.control import util as r_util
from jepsen_tpu.generator import pure as r_gen
from jepsen_tpu.runtime import client as r_client
from jepsen_tpu.runtime import core as r_core

from jepsen_tpu_torch import db as t_db
from jepsen_tpu_torch import os as t_os
from jepsen_tpu_torch.control import core as t_control
from jepsen_tpu_torch.control import util as t_util
from jepsen_tpu_torch.generator import pure as t_gen
from jepsen_tpu_torch.runtime import client as t_client
from jepsen_tpu_torch.runtime import core as t_core

from test_torch_generator import restored_run_logs

PKGS = {
    "ref": SimpleNamespace(db=r_db, control=r_control, gen=r_gen,
                           client=r_client, core=r_core, os=r_os,
                           util=r_util, logger="jepsen_tpu"),
    "port": SimpleNamespace(db=t_db, control=t_control, gen=t_gen,
                            client=t_client, core=t_core, os=t_os,
                            util=t_util, logger="jepsen_tpu_torch"),
}

NODES = ["n1", "n2", "n3"]


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def recording_db(pkg, fail_setups=0):
    class RecordingDB(pkg.db.DB):
        def __init__(self):
            self.calls = []
            self.fail_setups = fail_setups
            self._lock = threading.Lock()

        def setup(self, test, node, session):
            with self._lock:
                self.calls.append(("setup", node))
                if self.fail_setups > 0:
                    self.fail_setups -= 1
                    raise pkg.db.SetupFailed(f"flaky setup on {node}")
            session.exec("install-db", node)

        def teardown(self, test, node, session):
            with self._lock:
                self.calls.append(("teardown", node))

        def setup_primary(self, test, node, session):
            with self._lock:
                self.calls.append(("primary", node))

    return RecordingDB()


# -- the control and DB cases of tests/test_db_os.py ------------------------


def test_cycle_runs_teardown_setup_primary(pkg):
    db = recording_db(pkg)
    remote = pkg.control.DummyRemote()
    test = {"nodes": NODES, "remote": remote, "db": db}
    pkg.db.cycle(test)
    kinds = [k for k, _ in db.calls]
    assert kinds.count("teardown") == 3
    assert kinds.count("setup") == 3
    assert ("primary", "n1") in db.calls
    assert db.calls.index(("primary", "n1")) > kinds.index("setup")
    assert sorted(remote.commands()) == [
        f"install-db {n}" for n in NODES]


def test_cycle_retries_on_setup_failed(pkg):
    db = recording_db(pkg, fail_setups=2)
    test = {"nodes": NODES, "remote": pkg.control.DummyRemote(), "db": db}
    pkg.db.cycle(test)
    kinds = [k for k, _ in db.calls]
    assert kinds.count("teardown") >= 6


def test_cycle_gives_up_after_tries(pkg):
    db = recording_db(pkg, fail_setups=99)
    test = {"nodes": NODES, "remote": pkg.control.DummyRemote(), "db": db}
    with pytest.raises(RuntimeError, match="on_nodes failed"):
        pkg.db.cycle(test)
    assert [k for k, _ in db.calls].count("teardown") == 3 * 3


def test_run_engages_db_and_os_lifecycle(pkg):
    db = recording_db(pkg)
    os_calls = []

    class RecordingOS(pkg.os.Debian):
        def setup(self, test, node, session):
            os_calls.append(node)
            super().setup(test, node, session)

    remote = pkg.control.DummyRemote()
    test = pkg.core.run({
        "nodes": NODES,
        "remote": remote,
        "os": RecordingOS(),
        "db": db,
        "client": pkg.client.AtomClient(),
        "generator": pkg.gen.clients(pkg.gen.limit(5, {"f": "read"})),
        "concurrency": 2,
    })
    assert sorted(os_calls) == NODES
    for n in NODES:
        assert any("apt-get install -y" in c for c in remote.commands(n))
    kinds = [k for k, _ in db.calls]
    assert kinds.count("setup") == 3
    assert kinds[-1] == "teardown"
    assert test["results"]["valid?"] is True


def test_debian_os_emits_package_install(pkg):
    remote = pkg.control.DummyRemote(
        responses={"dpkg-query": (0, "curl\ntar\n", "")})
    test = {"nodes": ["n1"], "node_ips": {"n1": "10.0.0.1"},
            "remote": remote}
    deb = pkg.os.Debian()
    deb.setup(test, "n1", pkg.control.sessions_for(test)["n1"])
    cmds = remote.commands("n1")
    assert any("apt-get install -y" in c and "iptables" in c for c in cmds)
    assert any("/etc/hosts" in c for c in cmds)


def test_start_daemon_env_rides_through_env1(pkg):
    # env assignments must not follow setsid directly (setsid would
    # execvp the assignment string as the program).
    remote = pkg.control.DummyRemote()
    test = {"nodes": ["n1"], "remote": remote}
    pkg.util.start_daemon(
        pkg.control.sessions_for(test)["n1"], "/opt/db/bin/db", "--flag",
        pidfile="/opt/db.pid", logfile="/opt/db.log",
        env={"LD_PRELOAD": "/opt/shim.so"},
    )
    cmd = remote.commands("n1")[-1]
    assert "setsid env LD_PRELOAD=/opt/shim.so /opt/db/bin/db" in cmd


def test_start_daemon_env_actually_applies(pkg, tmp_path):
    # End-to-end through a real shell: the daemon sees the env var.
    s = pkg.control.Session(pkg.control.LocalRemote(), "local")
    out = tmp_path / "out.txt"
    pkg.util.start_daemon(
        s, "/bin/sh", "-c", f'echo "$MARKER" > {out}',
        pidfile=str(tmp_path / "p.pid"),
        logfile=str(tmp_path / "l.log"),
        env={"MARKER": "it-works"},
    )
    for _ in range(50):
        if out.exists() and out.read_text().strip():
            break
        time.sleep(0.05)
    assert out.read_text().strip() == "it-works"


@pytest.mark.parametrize("os_name", ["Debian", "Ubuntu", "Centos",
                                     "SmartOS"])
def test_os_setups_emit_the_same_commands(os_name):
    def go(p):
        remote = p.control.DummyRemote(
            responses={"dpkg-query": (0, "curl\n", "")})
        test = {"nodes": ["n1", "n2"],
                "node_ips": {"n1": "10.0.0.1", "n2": "10.0.0.2"},
                "remote": remote}
        os_ = getattr(p.os, os_name)(extra_packages=("jq",))
        sess = p.control.sessions_for(test)["n2"]
        os_.setup(test, "n2", sess)
        os_.teardown(test, "n2", sess)
        return remote.commands("n2")

    cmds = _both(go)
    assert cmds and any("jq" in c for c in cmds)


def test_daemon_helpers_emit_the_same_commands():
    def go(p):
        remote = p.control.DummyRemote(responses={
            "kill -0": (0, "", ""), "cat /opt/db.pid": (0, "4242\n", "")})
        s = p.control.sessions_for(
            {"nodes": ["n1"], "remote": remote})["n1"]
        p.util.start_daemon(s, "/opt/db/bin/db", "--port", 7,
                            pidfile="/opt/db.pid", logfile="/opt/db.log",
                            chdir="/opt/db")
        running = p.util.daemon_running(s, "/opt/db.pid")
        p.util.stop_daemon(s, "/opt/db.pid")
        p.util.grepkill(s, "etcd", signal="TERM")
        p.util.signal_proc(s, "etcd", "STOP")
        p.util.install_archive(s, "https://example.invalid/db.tgz",
                               "/opt/db")
        return running, remote.commands("n1")

    running, cmds = _both(go)
    assert running is True
    assert any("killall -s STOP etcd" in c for c in cmds)
    assert any("tar -xf" in c for c in cmds)


def test_snarf_logs_downloads(pkg, tmp_path):
    class LogDB(pkg.db.DB):
        def log_files(self, test, node):
            return [f"/var/log/db-{node}.log"]

    remote = pkg.control.DummyRemote()
    test = {"nodes": NODES, "remote": remote, "db": LogDB()}
    pkg.db.snarf_logs(test, str(tmp_path))
    downloads = [e for e in remote.log if e["type"] == "download"]
    assert len(downloads) == 3
    assert sorted(e["local"] for e in downloads) == sorted(
        str(tmp_path / n / f"db-{n}.log") for n in NODES)


def test_run_snarfs_logs_into_the_run_dir(pkg, tmp_path):
    class LogDB(pkg.db.DB):
        def log_files(self, test, node):
            return [f"/var/log/{node}.log"]

    remote = pkg.control.DummyRemote()
    with restored_run_logs():
        test = pkg.core.run({
            "name": "snarf", "nodes": NODES, "remote": remote,
            "db": LogDB(), "client": pkg.client.AtomClient(),
            "generator": pkg.gen.clients(pkg.gen.limit(3, {"f": "read"})),
            "concurrency": 1, "store": str(tmp_path / "store"),
        })
    locals_ = sorted(e["local"] for e in remote.log
                     if e["type"] == "download")
    assert locals_ == [f"{test['run_dir']}/{n}/{n}.log" for n in NODES]


# -- the control plane -------------------------------------------------------


def _both(fn):
    """fn(pkg) on each package; the two results must be equal."""
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_dummy_remote_scopes_and_answers():
    def go(p):
        remote = p.control.DummyRemote(
            responses={"cat /etc/hostname": (0, "n1\n", "")})
        s = p.control.Session(remote, "n1")
        outs = [
            s.exec("cat", "/etc/hostname"),
            s.exec("echo", "a b;c", sudo=True, cd="/var/lib/my db"),
            s.exec("ls", cd="/tmp"),
        ]
        s.upload("/tmp/x", "/srv/x")
        s.download("/srv/y", "/tmp/y")
        return outs, remote.log, remote.commands("n1"), p.control.escape(
            "it's")

    outs, log, cmds, esc = _both(go)
    assert outs[0] == "n1\n"
    assert cmds[1].startswith("sudo -n sh -c ")
    assert cmds[2] == "cd /tmp && ls"
    assert [e["type"] for e in log] == [
        "exec", "exec", "exec", "upload", "download"]
    assert esc == "'it'\"'\"'s'"


def test_session_raises_remote_error_on_nonzero_exit():
    def go(p):
        remote = p.control.DummyRemote(responses={"false": (3, "", "no")})
        s = p.control.Session(remote, "n2")
        with pytest.raises(p.control.RemoteError) as ei:
            s.exec("false")
        unchecked = s.exec("false", check=False)
        return str(ei.value), ei.value.exit_code, unchecked

    msg, code, unchecked = _both(go)
    assert code == 3 and "exited 3: no" in msg and unchecked == ""


def test_session_retries_a_transport_fault_and_reconnects():
    def go(p):
        state = {"fails": 2, "connects": 0}

        class Flaky(p.control.DummyRemote):
            def connect(self, node):
                state["connects"] += 1
                return Flaky(self.responses, self.log, node)

            def execute(self, cmd, sudo=False, cd=None, stdin=None):
                if state["fails"] > 0:
                    state["fails"] -= 1
                    raise ConnectionError("reset by peer")
                return super().execute(cmd, sudo, cd, stdin)

        s = p.control.Session(Flaky(), "n3", retries=3, backoff_s=0.0)
        out = s.exec("uptime")
        s2 = p.control.Session(Flaky(), "n3", retries=2, backoff_s=0.0)
        state["fails"] = 5
        with pytest.raises(ConnectionError):
            s2.exec("uptime")
        return out, state["connects"]

    out, connects = _both(go)
    # one connect per session, one reconnect per transport fault
    assert out == "" and connects == 2 + 2 + 2


def test_on_nodes_fans_out_and_names_the_failing_node():
    def go(p):
        test = {"nodes": NODES, "remote": p.control.DummyRemote()}
        got = p.control.on_nodes(test, lambda n, s: s.exec("hostname", n))
        primary = p.control.on_nodes(test, lambda n, s: n.upper(), ["n2"])

        def boom(n, s):
            if n != "n1":
                raise ValueError(f"down {n}")
            return n

        with pytest.raises(RuntimeError) as ei:
            p.control.on_nodes(test, boom)
        return (sorted(got.items()), primary, str(ei.value),
                type(ei.value.__cause__).__name__,
                sorted(test["_sessions"]))

    got, primary, msg, cause, sessions = _both(go)
    assert primary == {"n2": "N2"}
    assert msg == "on_nodes failed on n2: down n2" and cause == "ValueError"
    assert sessions == NODES


def test_local_remote_runs_on_this_host(tmp_path):
    def go(p):
        d = tmp_path / p.logger
        d.mkdir()
        s = p.control.Session(p.control.LocalRemote(), "local")
        out = s.exec("sh", "-c", "pwd; echo $0", cd=str(d))
        src = d / "a.txt"
        src.write_text("payload")
        s.upload(str(src), str(d / "b.txt"))
        s.download(str(d / "b.txt"), str(d / "c.txt"))
        with pytest.raises(p.control.RemoteError):
            s.exec("sh", "-c", "exit 4")
        return (out.replace(p.logger, "PKG"),
                (d / "c.txt").read_text(),
                s.exec("cat", stdin="fed"))

    out, copied, fed = _both(go)
    assert out.splitlines()[0].endswith("/PKG")
    assert copied == "payload" and fed == "fed"


def test_ssh_remote_renders_the_same_options():
    def go(p):
        r = p.control.SshRemote(username="admin", port=2222,
                                private_key_path="/k",
                                control_path="/tmp/cp")
        c = r.connect("n4")
        plain = p.control.SshRemote().connect("n5")
        return (c._dest(), c._opts(), c._scp_opts(), plain._dest(),
                plain._opts())

    dest, opts, scp, plain_dest, plain_opts = _both(go)
    assert dest == "admin@n4" and plain_dest == "n5"
    assert "StrictHostKeyChecking=no" in opts and "/k" in scp
    assert "-P" in scp and "-p" in opts


def test_sessions_log_commands_to_the_packages_control_logger(caplog):
    def go(p):
        with caplog.at_level(logging.DEBUG, logger=f"{p.logger}.control"):
            caplog.clear()
            s = p.control.Session(p.control.DummyRemote(), "n1")
            s.exec("echo", "hi", sudo=True)
            return [(r.name.replace(p.logger, "PKG"), r.getMessage())
                    for r in caplog.records]

    recs = _both(go)
    assert recs == [("PKG.control", "n1$ sudo -n sh -c 'echo hi'")]
