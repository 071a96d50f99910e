"""Spawn pod members and checker-daemon fleet members (the counterpart of
jepsen_tpu.pod.launcher).

``launch_pod`` runs a REAL N-process pod on localhost: each member is
``python -c PRELUDE + script`` with the ``JEPSEN_TPU_POD_*`` seam and the
port's local-slot seam (``JEPSEN_TPU_TORCH_LOCAL_DEVICES``, its virtual
slots) in its env, so the script body starts INSIDE the initialized pod
(topology.init_pod: gloo over TCP on 127.0.0.1). ``CUDA_VISIBLE_DEVICES``
is left as it is: on a one-card host every member shares the card, and
the pod gathers on gloo. Pod collectives are barriers, so a member that
hangs wedges the rest: past ``timeout_s`` the WHOLE pod is killed.

Each fleet member is a fresh interpreter (``subprocess.Popen`` of ``python -m
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
from dataclasses import dataclass
from typing import Dict, List, Optional

from jepsen_tpu_torch.obs import podtrace
from jepsen_tpu_torch.pod import topology

#: prepended to every pod member's script: join the pod before user code
PRELUDE = "import jepsen_tpu_torch.pod.topology as _pod_t; _pod_t.init_pod()\n"


@dataclass
class PodProc:
    """One finished pod member."""

    process_id: int
    returncode: Optional[int]
    stdout: str
    stderr: str

    @property
    def ok(self) -> bool:
        return self.returncode == 0


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


def _with_repo(env: Dict[str, str]) -> Dict[str, str]:
    env["PYTHONPATH"] = (
        _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    return env


def pod_env(
    coordinator: str,
    n_procs: int,
    process_id: int,
    n_local_devices: int,
    base_env: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """The env one pod member needs: the JEPSEN_TPU_POD_* seam,
    ``n_local_devices`` virtual slots (the port's local-slot seam), and
    the repo importable."""
    from jepsen_tpu_torch.checker.sharded import ENV_LOCAL_DEVICES

    env = dict(os.environ if base_env is None else base_env)
    env[topology.ENV_COORDINATOR] = coordinator
    env[topology.ENV_NPROCS] = str(n_procs)
    env[topology.ENV_PROCESS_ID] = str(process_id)
    env[ENV_LOCAL_DEVICES] = str(int(n_local_devices))
    return _with_repo(env)


def member_env() -> Dict[str, str]:
    """The env one fleet member needs: this process's, minus any pod
    identity (a member must not block in init_pod waiting for a
    collective peer it must not have), with the repo importable ahead
    of any ``PYTHONPATH`` it already carries."""
    env = dict(os.environ)
    for k in (topology.ENV_COORDINATOR, topology.ENV_NPROCS,
              topology.ENV_PROCESS_ID):
        env.pop(k, None)
    return _with_repo(env)


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


def launch_pod(
    n_procs: int,
    script: str,
    *,
    n_local_devices: int = 4,
    timeout_s: float = 240.0,
    python: Optional[str] = None,
    extra_env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
    trace_dir: Optional[str] = None,
) -> List[PodProc]:
    """Spawn an ``n_procs``-process pod on localhost running ``script``
    (Python source) in every member, each with ``n_local_devices``
    virtual slots, and wait for all of them. On a CUDA host the kernels
    are built here first, so the members do not each run nvcc. Blowing
    ``timeout_s`` kills the WHOLE pod (survivors of a hung member would
    never finish); killed members report the kill signal.

    ``trace_dir`` propagates the tracing env seam
    (``JEPSEN_TPU_TRACE_DIR``) to every member, so each persists its
    flight-recorder ring there for ``podtrace.merge_pod_trace``."""
    import torch

    if torch.cuda.is_available():
        build_member_libraries()
    coordinator = f"127.0.0.1:{free_port()}"
    procs: List[subprocess.Popen] = []
    for pid in range(n_procs):
        env = pod_env(coordinator, n_procs, pid, n_local_devices)
        if trace_dir is not None:
            env[podtrace.ENV_TRACE_DIR] = trace_dir
        if extra_env:
            env.update(extra_env)
        procs.append(subprocess.Popen(
            [python or sys.executable, "-c", PRELUDE + script],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=cwd,
        ))
    deadline = time.monotonic() + timeout_s
    out: List[PodProc] = []
    for pid, p in enumerate(procs):
        try:
            so, se = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            so, se = p.communicate()
        out.append(PodProc(pid, p.returncode, so or "", se or ""))
    for q in procs:  # reap any member killed after its collect
        if q.poll() is None:
            q.kill()
            q.wait()
    return out
