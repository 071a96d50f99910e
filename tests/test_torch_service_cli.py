"""The port's `daemon` command and the daemon's device rule, on the CPU.

`python3 -m jepsen_tpu_torch.cli daemon --backend cpu` serves checks in
a child process; a SIGTERM while a check is in flight closes the door
(a late request is refused), lets the in-flight check answer 200, and
the process exits 0. Without --backend cpu and without a card the
command exits 254 ("CUDA is not available"), and a CheckerDaemon built
for the card raises before it opens a socket or a file. The daemon takes
the mesh and pod flags (--devices caps the plane's mesh); the
reference's fleet --member-devices and --nodes stay usage errors (255),
as do malformed mesh and pod flags; the daemon's --profile is taken
(see tests/test_torch_perf.py)."""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from jepsen_tpu_torch import cli, sim
from jepsen_tpu_torch.service.client import CheckerClient, ServiceError
from jepsen_tpu_torch.service.server import CheckerDaemon

pytestmark = pytest.mark.service

REPO = Path(__file__).resolve().parents[1]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_healthy(port, proc, timeout_s=120):
    c = CheckerClient(port=port, timeout_s=5, retries=0)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        assert proc.poll() is None, proc.communicate()
        try:
            if c.health().get("ok"):
                return c
        except (OSError, ServiceError):
            pass
        time.sleep(0.1)
    raise TimeoutError(f"daemon on :{port} never became healthy")


def test_daemon_command_drains_on_sigterm_and_exits_zero(tmp_path):
    root = str(tmp_path / "store")
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "daemon",
         "--backend", "cpu", "--store", root, "--port", str(port),
         "--coalesce-hold", "3", "--drain-seconds", "60"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        client = _wait_healthy(port, proc)
        client.timeout_s = 120
        h = sim.gen_register_history(random.Random(7), n_ops=100,
                                     n_procs=4, p_crash=0.0)
        result = {}

        def submit():
            try:
                result["out"] = client.check(h, model="cas-register")
            except Exception as e:  # noqa: BLE001
                result["err"] = e

        t = threading.Thread(target=submit)
        t.start()
        deadline = time.time() + 60
        while time.time() < deadline:
            if client.stats()["admission"]["inflight"] >= 1:
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        # the door closes at once: a late request is refused (503, or
        # the socket is already down)
        time.sleep(0.3)
        try:
            CheckerClient(port=port, tenant="late", timeout_s=10,
                          retries=0).check(h)
            refused = False
        except (ServiceError, OSError) as e:
            refused = (getattr(e, "status", None) == 503
                       or isinstance(e, OSError))
        assert refused
        t.join(timeout=120)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert "drained. (code 0)" in out
        assert result["out"]["valid?"] is True, result
        recs = [json.loads(ln) for ln in open(
            os.path.join(root, ".service", "audit.jsonl"))]
        assert any(r["status"] == 200 and r["path"] == "/check"
                   for r in recs)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


@pytest.mark.parametrize("flag", (
    ["fleet", "--member-devices", "4"],
    ["fleet-drill", "--member-devices", "2"],
    ["fleet", "--nodes", "n1,n2"],
    ["daemon", "--devices", "all"],
    ["daemon", "--pod-coordinator"],
    ["daemon", "--pod-processes", "two"], ["daemon", "--pod-index", "first"],
))
def test_fleet_mesh_and_profile_flags_are_usage_errors(tmp_path, flag):
    """The reference's flags the port does not take: the fleet's
    --member-devices (virtual CPU devices a member; --backend takes its
    place) and the harness's --nodes; and the daemon's mesh and pod
    flags with malformed values (the flags themselves are taken:
    test_daemon_devices_caps_the_plane_mesh). The daemon's --profile is
    taken too: tests/test_torch_perf.py."""
    cmd, *rest = flag
    assert cli.main([cmd, "--backend", "cpu", "--store",
                     str(tmp_path), *rest]) == cli.EXIT_USAGE


def test_daemon_devices_caps_the_plane_mesh(tmp_path):
    """`daemon --devices 2` with 4 virtual slots (the local-slot seam):
    the daemon's plane shards over 2 of them, /stats carries the mesh
    section the reference's daemon serves, and SIGTERM exits 0."""
    from jepsen_tpu_torch.checker.sharded import ENV_LOCAL_DEVICES

    root = str(tmp_path / "store")
    port = _free_port()
    env = dict(os.environ, **{ENV_LOCAL_DEVICES: "4"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "daemon",
         "--backend", "cpu", "--store", root, "--port", str(port),
         "--coalesce-hold", "0", "--devices", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env,
    )
    try:
        client = _wait_healthy(port, proc)
        client.timeout_s = 120
        h = sim.gen_register_history(random.Random(7), n_ops=100,
                                     n_procs=4, p_crash=0.0)
        assert client.check(h, model="cas-register")["valid?"] is True
        mesh = client.stats()["mesh"]
        assert mesh["last_n_devices"] == 2
        assert mesh["sharded_launches"] >= 1
        assert mesh["topology"]["local_devices"] == 4
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def test_no_card_exits_254_and_the_daemon_raises(tmp_path, monkeypatch,
                                                 capsys):
    """The daemon never falls back to the CPU: without a card (and
    without --backend cpu) the command crashes with "CUDA is not
    available", and CheckerDaemon() raises before any file exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "store"
    assert cli.main(["daemon", "--store", str(root), "--port", "0"]) \
        == cli.EXIT_CRASH
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckerDaemon(root=str(root), port=0)
    assert not root.exists()
