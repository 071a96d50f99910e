"""Spawn checker-daemon fleet members (the fleet half of
jepsen_tpu.pod.launcher).

Each member is a fresh interpreter (``subprocess.Popen`` of ``python -m
jepsen_tpu_torch.cli daemon``), never a fork: a process that has
initialised CUDA must not fork. A member binds an ephemeral port and
announces its URL into the shared fleet dir itself
(service/membership.py), so the parent discovers it through the
registry (``wait_fleet``) rather than picking ports.

On the card every member builds the same kernels into the same
``build/jepsen_tpu_torch/``. The parent builds them once before it
spawns a member, so N members do not each run ``nvcc`` inside
``wait_fleet``'s budget (the builds are race-safe either way: each
writes a per-pid temporary file and renames it).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional


def free_port() -> int:
    """An OS-assigned free TCP port. The bind-release race is
    acceptable: the caller binds within milliseconds."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def member_env() -> Dict[str, str]:
    """The env one fleet member needs: this process's, with the repo
    importable ahead of any ``PYTHONPATH`` it already carries."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    return env


def build_member_libraries() -> None:
    """Build the kernels and the native host libraries a member on the
    card loads, in this process, before any member starts. Already
    built sources are skipped, so a later call costs a stat each."""
    from jepsen_tpu_torch.checker import _build

    _build.build_all()
    for name in ("wgl_native", "wgl_prep"):
        _build.native_library(name)


def spawn_fleet_member(
    member_id: int,
    fleet_dir: str,
    root: str,
    *,
    device=None,
    epoch: int = 0,
    python: Optional[str] = None,
    extra_args: Optional[List[str]] = None,
    extra_env: Optional[Dict[str, str]] = None,
    log_path: Optional[str] = None,
) -> subprocess.Popen:
    """Spawn ONE checker-daemon fleet member as a subprocess on an
    ephemeral port; poll ``wait_fleet`` for readiness. The caller owns
    the process (terminate/kill/wait); SIGKILL-ing one is the fleet
    durability drill, and the front door declares the death on first
    contact.

    ``device``: None runs the member on the CUDA card (its kernels
    built here first; without a card the member exits 254), "cpu" on
    the plain versions (``--backend cpu``). ``epoch`` is the
    supervision fence (service/supervisor.py): a respawned member
    announces ``epoch = prior + 1`` so any resurrected earlier
    incarnation fences itself instead of double-owning handed-off
    checks."""
    cpu = device is not None and str(device) == "cpu"
    if not cpu:
        build_member_libraries()
    env = member_env()
    if extra_env:
        env.update(extra_env)
    cmd = [
        python or sys.executable, "-m", "jepsen_tpu_torch.cli", "daemon",
        "--store", root, "--port", "0",
        "--fleet-dir", fleet_dir, "--member-id", str(member_id),
    ]
    if epoch:
        cmd += ["--member-epoch", str(int(epoch))]
    if cpu:
        cmd += ["--backend", "cpu"]
    cmd += list(extra_args or [])
    logf = open(log_path, "ab") if log_path else subprocess.DEVNULL
    try:
        return subprocess.Popen(
            cmd, env=env, stdout=logf, stderr=logf, cwd=_repo_root(),
        )
    finally:
        if log_path:
            logf.close()


def wait_fleet(
    fleet_dir: str, n_members: int, timeout_s: float = 90.0
) -> list:
    """Block until ``n_members`` members are announced and alive in
    ``fleet_dir`` (or raise TimeoutError). Returns their MemberInfo
    rows. A member on the card pays ``import torch`` and its CUDA
    context before it binds."""
    from jepsen_tpu_torch.service.membership import FleetRegistry

    reg = FleetRegistry(fleet_dir)
    deadline = time.monotonic() + timeout_s
    while True:
        alive = reg.alive_members()
        if len(alive) >= n_members:
            return alive
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"fleet incomplete: {len(alive)}/{n_members} members "
                f"alive in {fleet_dir} after {timeout_s:.0f}s"
            )
        time.sleep(0.1)
