"""The port's fleet commands on the CPU: `daemon --fleet-dir`, `fleet`
and `fleet-drill` (jepsen_tpu_torch/cli.py).

Each runs as a child process with ``--backend cpu``, as a user would
run it: a daemon joins a fleet dir under its member id and epoch (the
reference's registry reads its row) and retires on SIGTERM; `fleet`
spawns two members, answers a POST through its front door with the
ring owner's verdict and drains to exit 0 on SIGTERM; `fleet-drill`
with the kill and torn-write classes comes back clean with one
supervised respawn, and a planted verdict-parity violation (an oracle
that inverts every verdict) exits 8. Without a card and without
``--backend cpu`` every fleet command exits 254 before it spawns
anything."""

import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from test_torch_service_cli import _free_port, _wait_healthy

from jepsen_tpu.service.membership import FleetRegistry as RRegistry

from jepsen_tpu_torch import cli, sim
from jepsen_tpu_torch.checker import linearizable
from jepsen_tpu_torch.service.client import CheckerClient, ServiceError
from jepsen_tpu_torch.service.membership import FleetRegistry, HashRing

pytestmark = [pytest.mark.service, pytest.mark.fleet]

REPO = Path(__file__).resolve().parents[1]


def _run(*argv):
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", *argv],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate(timeout=60)


def test_daemon_joins_the_fleet_dir_and_retires(tmp_path):
    fdir = str(tmp_path / "fleet")
    port = _free_port()
    proc = _run("daemon", "--backend", "cpu", "--store",
                str(tmp_path / "store"), "--port", str(port),
                "--fleet-dir", fdir, "--member-id", "3",
                "--member-epoch", "2")
    try:
        client = _wait_healthy(port, proc)
        rows = [(m.member_id, m.epoch, m.url)
                for m in FleetRegistry(fdir).alive_members()]
        assert rows == [(3, 2, f"http://127.0.0.1:{port}")]
        assert [(m.member_id, m.epoch) for m in
                RRegistry(fdir).alive_members()] == [(3, 2)]
        member = client.stats()["member"]
        assert (member["member_id"], member["epoch"]) == (3, 2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert "member=3" in out and "drained. (code 0)" in out
        assert FleetRegistry(fdir).all_members() == []  # retired
    finally:
        _stop(proc)


def test_fleet_command_serves_and_drains(tmp_path):
    store = str(tmp_path / "store")
    port = _free_port()
    proc = _run("fleet", "--backend", "cpu", "--members", "2", "--store",
                store, "--port", str(port))
    try:
        door = CheckerClient(port=port, tenant="alice", retries=0,
                             timeout_s=60)
        deadline = time.time() + 180
        while True:
            assert proc.poll() is None, proc.communicate()
            try:
                if door.health().get("members_alive") == 2:
                    break
            except (OSError, ServiceError):
                pass
            assert time.time() < deadline, "fleet never came up"
            time.sleep(0.2)
        h = sim.gen_register_history(random.Random(9), n_ops=40,
                                     n_procs=4, p_crash=0.0)
        out = door.check(h)
        assert out["valid?"] is True
        assert out["fleet_member"] == HashRing((0, 1)).route("alice")
        proc.send_signal(signal.SIGTERM)
        stdout, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert "fleet drained. (code 0)" in stdout
        assert FleetRegistry(os.path.join(store, ".fleet")
                             ).all_members() == []
    finally:
        _stop(proc)


def test_fleet_drill_command_is_clean(tmp_path):
    report = tmp_path / "report.json"
    proc = _run("fleet-drill", "--backend", "cpu", "--members", "2",
                "--duration", "6", "--seed", "0",
                "--classes", "kill,torn_write",
                "--store", str(tmp_path / "store"),
                "--report", str(report))
    try:
        out, err = proc.communicate(timeout=400)
    finally:
        _stop(proc)
    assert proc.returncode == 0, err[-3000:]
    assert "fleet drill clean" in out
    r = json.loads(report.read_text())
    assert r["clean"] is True and r["violations"] == []
    assert {f["kind"] for f in r["nemesis"]["fired"]} == {
        "kill", "torn_write"}
    victim = next(f["member_id"] for f in r["nemesis"]["fired"]
                  if f["kind"] == "kill")
    assert r["supervisor"]["respawns"][str(victim)] == 1
    assert r["supervisor"]["epochs"][str(victim)] == 1
    assert r["final_sample"]["members_alive"] == 2
    assert r["checks"]["lost"] == 0
    assert r["parity"]["compared"] == r["checks"]["unique"] > 0
    assert r["oracle"]["device"] == "cpu"


def test_fleet_drill_planted_violation_exits_8(tmp_path, monkeypatch,
                                               capsys):
    """An oracle that inverts every verdict: the parity pass finds
    every answered check in violation, and the command exits 8."""

    class Inverted(linearizable.LinearizableChecker):
        def check(self, *a, **kw):
            out = super().check(*a, **kw)
            return {**out, "valid?": not out["valid?"]}

    monkeypatch.setattr(linearizable, "LinearizableChecker", Inverted)
    report = tmp_path / "report.json"
    rc = cli.main(["fleet-drill", "--backend", "cpu", "--members", "2",
                   "--duration", "3", "--classes", "torn_write",
                   "--store", str(tmp_path / "store"),
                   "--report", str(report)])
    assert rc == cli.EXIT_DRILL == 8
    assert "fleet drill FAILED" in capsys.readouterr().err
    r = json.loads(report.read_text())
    kinds = {v["invariant"] for v in r["violations"]}
    assert kinds == {"verdict-parity"}
    assert len(r["violations"]) == r["parity"]["compared"] > 0


@pytest.mark.parametrize("argv", [
    ["fleet", "--members", "2"],
    ["fleet-drill", "--members", "2", "--duration", "1"],
    ["daemon", "--port", "0", "--member-id", "1"],
])
def test_without_a_card_fleet_commands_exit_254(tmp_path, monkeypatch,
                                                capsys, argv):
    """No fallback hides the card: without one and without --backend
    cpu, each fleet command crashes with "CUDA is not available" before
    it spawns a member or writes a member file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fdir = tmp_path / "fleet"
    rc = cli.main([*argv, "--store", str(tmp_path / "store"),
                   "--fleet-dir", str(fdir)])
    assert rc == cli.EXIT_CRASH
    assert "CUDA is not available" in capsys.readouterr().err
    assert not fdir.exists()
