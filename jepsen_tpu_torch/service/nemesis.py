"""The fleet nemesis: the fault injector turned on the service itself
(the port of jepsen_tpu.service.nemesis).

The reference framework's identity is its nemesis — partitions,
process kills, and clock skew injected into a running system while a
checker holds the history to its model (jepsen.nemesis; PAPER.md §1).
``checker/chaos.py`` gives the ANALYSIS plane that treatment at
device-seam granularity; this module lifts the same discipline to the
fleet layer the analysis plane now runs on: N checker daemons behind
a front door, supervised and drilled under the fault classes that
actually kill production fleets.

Fault classes (``FleetFault.kind``):

- ``kill``    — member SIGKILL: the clean crash. The door declares the
  death on first contact; the supervisor respawns under budget.
- ``stall``   — member SIGSTOP for ``duration_s``: the GRAY failure.
  The member's socket still accepts connections (the kernel backlog
  answers), replies never come. This is the class the gray-failure
  literature names as dominant in production (PAPERS.md) and exactly
  what a refused/timeout conflation mishandles.
- ``delay`` / ``drop`` — asymmetric partition: the member accepts and
  processes, but its REPLIES are delayed ``value`` seconds or dropped
  on the floor (in-process members via ``ResponseGate``).
- ``torn_write`` — a torn member row lands in the registry mid-read:
  the atomic-write discipline is violated on purpose to prove readers
  skip, never crash.
- ``clock_skew`` — a member's ``heartbeat_ts`` is rewritten ``value``
  seconds (negative = into the past, so the TTL gate fires early).
- ``checkpoint_corrupt`` — durable checkpoint/stream files under the
  shared store root are bit-flipped mid-drill: the sink's content-hash
  verification must reject and cold-start, never resume garbage.

A ``FleetChaosPlan`` is a deterministic schedule (seeded jitter only)
so every drill is replayable byte-for-byte: ``FleetChaosPlan.drill``
builds the canonical gauntlet the exit-8 gate runs. ``FleetNemesis``
executes a plan against member HANDLES — ``ProcMemberHandle`` (real
subprocess members: signals) and ``LocalMemberHandle`` (in-process
test fleets: the same plan drives socket teardown and reply gates) —
so ``cli fleet`` spawns and the in-process ``_Fleet`` test rig honor
one plan format.

``run_fleet_drill`` is the full gauntlet: spawn a fleet, start the
supervisor (``service/supervisor.py``) and the invariant monitor
(``service/invariants.py``), drive live multi-tenant traffic through
the front door while the nemesis fires, then settle and report. The
report's ``clean`` flag is the ``cli fleet-drill`` exit-8 gate. The
drill's members run on the CUDA card unless the caller asks for the
CPU, and so does its parity oracle: the port's ``LinearizableChecker``
on the drill's device, which on the card is kernel A.
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from jepsen_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("jepsen_tpu_torch.service.nemesis")

#: every fault class the plan format knows
FAULT_KINDS = (
    "kill", "stall", "delay", "drop",
    "torn_write", "clock_skew", "checkpoint_corrupt",
)

#: a stalled reply is released after this bound even if nobody calls
#: ``open()`` — a leaked gate must not wedge handler threads forever
MAX_STALL_S = 120.0


class ResponseGate:
    """The asymmetric-partition seam for in-process members: the
    daemon's handler calls ``apply()`` immediately before writing any
    response. ``open`` passes through; ``delay`` sleeps replies;
    ``drop`` tells the handler to close the connection unanswered;
    ``stall`` blocks replies until ``open()`` (the SIGSTOP analog —
    connections accept, replies never come)."""

    def __init__(self, max_stall_s: float = MAX_STALL_S):
        self.max_stall_s = float(max_stall_s)
        self._mode = "open"
        self._delay_s = 0.0
        self._resume = threading.Event()
        self._resume.set()

    def stall(self) -> None:
        self._mode = "stall"
        self._resume.clear()

    def delay(self, seconds: float) -> None:
        self._mode = "delay"
        self._delay_s = float(seconds)
        self._resume.set()

    def drop(self) -> None:
        self._mode = "drop"
        self._resume.set()

    def open(self) -> None:
        self._mode = "open"
        self._delay_s = 0.0
        self._resume.set()

    def apply(self) -> str:
        """Called by the handler before each response: returns
        ``"send"`` (after any injected delay) or ``"drop"``."""
        self._resume.wait(timeout=self.max_stall_s)
        mode = self._mode
        if mode == "delay" and self._delay_s > 0:
            time.sleep(self._delay_s)
        return "drop" if mode == "drop" else "send"


# -- member handles ----------------------------------------------------


class ProcMemberHandle:
    """A subprocess fleet member (``pod/launcher.spawn_fleet_member``):
    faults land as real signals. A member stopped with a launch in
    flight keeps its CUDA context: the kernel finishes on the card,
    and the host collects it after SIGCONT."""

    def __init__(self, member_id: int, proc):
        self.member_id = int(member_id)
        self.proc = proc

    @property
    def pid(self) -> Optional[int]:
        return getattr(self.proc, "pid", None)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        self.proc.kill()

    def stall(self) -> None:
        os.kill(self.proc.pid, signal.SIGSTOP)

    def unstall(self) -> None:
        try:
            os.kill(self.proc.pid, signal.SIGCONT)
        except (OSError, ProcessLookupError):
            pass

    def delay(self, seconds: float) -> None:
        # a subprocess has no reply gate; the closest signal-level
        # analog is a bounded stall (released by the nemesis loop)
        self.stall()

    def drop(self) -> None:
        self.stall()

    def open(self) -> None:
        self.unstall()


class LocalMemberHandle:
    """An in-process fleet member (the tests' ``_Fleet`` rig): kill
    tears the socket down WITHOUT retiring (dead on the wire, member
    file left behind — exactly what SIGKILL looks like from outside),
    gray faults ride the daemon's ``ResponseGate``."""

    def __init__(self, member_id: int, daemon):
        self.member_id = int(member_id)
        self.daemon = daemon
        if getattr(daemon, "chaos_gate", None) is None:
            daemon.chaos_gate = ResponseGate()
        self._killed = False

    def alive(self) -> bool:
        return not self._killed

    def kill(self) -> None:
        self._killed = True
        d = self.daemon
        if d._registry is not None:
            d._registry.stop_heartbeat()
        d.httpd.shutdown()
        try:
            d.httpd.server_close()
        except OSError:
            pass

    def stall(self) -> None:
        self.daemon.chaos_gate.stall()

    def unstall(self) -> None:
        self.daemon.chaos_gate.open()

    def delay(self, seconds: float) -> None:
        self.daemon.chaos_gate.delay(seconds)

    def drop(self) -> None:
        self.daemon.chaos_gate.drop()

    def open(self) -> None:
        self.daemon.chaos_gate.open()


# -- registry / store faults (no handle needed) ------------------------


def torn_member_write(fleet_dir: str, member_id: int) -> str:
    """Deliberately violate the atomic-write discipline: leave a
    TRUNCATED member row where readers expect a whole one. The
    registry's read path must skip it (the member drops from routing
    until its next heartbeat rewrites the row) — never crash, never
    route on garbage."""
    from jepsen_tpu_torch.service.membership import MEMBER_FILE_FMT

    p = os.path.join(fleet_dir, MEMBER_FILE_FMT.format(int(member_id)))
    with open(p, "w", encoding="utf-8") as f:
        f.write('{"schema": 1, "member_id": ')  # torn mid-value
    return p


def skew_heartbeat(
    fleet_dir: str, member_id: int, skew_s: float
) -> Optional[float]:
    """Rewrite one member's ``heartbeat_ts`` by ``skew_s`` seconds
    (negative = into the past: the TTL gate sees a stale member and
    drops it until the member's own next heartbeat corrects the row).
    Returns the new heartbeat_ts, or None when the row was unreadable
    (torn rows cannot be skewed — there is nothing to skew)."""
    from jepsen_tpu_torch.service.membership import MEMBER_FILE_FMT
    from jepsen_tpu_torch.store import atomic_write_text

    p = os.path.join(fleet_dir, MEMBER_FILE_FMT.format(int(member_id)))
    try:
        with open(p, encoding="utf-8") as f:
            d = json.load(f)
        d["heartbeat_ts"] = float(d["heartbeat_ts"]) + float(skew_s)
    except (OSError, ValueError, KeyError, TypeError):
        return None
    atomic_write_text(p, json.dumps(d))
    return d["heartbeat_ts"]


def corrupt_service_checkpoints(
    store_root: str, rng: random.Random, max_files: int = 2
) -> List[str]:
    """Bit-flip up to ``max_files`` durable checkpoint/stream files
    under the shared store root — the mid-hand-off corruption drill.
    The checkpoint sink's version/content-hash/payload-sha gauntlet
    must REJECT the corrupt frontier and cold-start (same verdict,
    paid again) rather than resume garbage."""
    base = os.path.join(store_root, ".service")
    targets: List[str] = []
    for dirpath, _dirs, names in os.walk(base):
        for name in names:
            if name in ("checkpoint.json", "stream.json"):
                targets.append(os.path.join(dirpath, name))
    targets.sort()
    if not targets:
        return []
    chosen = rng.sample(targets, min(max_files, len(targets)))
    hit: List[str] = []
    for p in chosen:
        try:
            with open(p, "r+b") as f:
                raw = f.read()
                if not raw:
                    continue
                i = rng.randrange(len(raw))
                f.seek(i)
                f.write(bytes([raw[i] ^ 0x5A]))
        except OSError:
            continue
        hit.append(p)
    return hit


# -- the plan ----------------------------------------------------------


@dataclass(frozen=True)
class FleetFault:
    """One scheduled fleet-level fault. ``at_s`` is the offset from
    drill start; ``duration_s`` bounds gray periods (stall/delay/
    drop); ``value`` carries the kind-specific magnitude (delay
    seconds, skew seconds)."""

    kind: str
    member_id: int
    at_s: float
    duration_s: float = 0.0
    value: float = 0.0

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "member_id": self.member_id,
            "at_s": round(self.at_s, 3),
            "duration_s": round(self.duration_s, 3),
            "value": round(self.value, 3),
        }


@dataclass
class FleetChaosPlan:
    """A deterministic fleet-fault schedule. The seed drives jitter
    ONLY at build time — executing a plan twice fires the same faults
    at the same offsets against the same members."""

    faults: List[FleetFault] = field(default_factory=list)
    seed: int = 0

    def scheduled(self) -> List[FleetFault]:
        return sorted(self.faults, key=lambda f: f.at_s)

    def to_json(self) -> dict:
        return {
            "seed": self.seed,
            "faults": [f.to_json() for f in self.scheduled()],
        }

    @classmethod
    def drill(
        cls,
        members: int = 2,
        duration_s: float = 30.0,
        seed: int = 0,
        gray_s: float = 12.0,
        ttl_s: float = 10.0,
        classes: Optional[Sequence[str]] = None,
    ) -> "FleetChaosPlan":
        """The canonical gauntlet: one SIGSTOP gray period on member
        A, then registry torn-write + clock-skew + checkpoint
        corruption + SIGKILL against member B, at seed-jittered
        offsets chosen so at least one member stays routable at every
        instant. ``classes`` restricts which kinds are emitted (the
        smoke drill's subset knob)."""
        if members < 2:
            raise ValueError("a drill needs at least 2 members")
        rng = random.Random(int(seed))
        want = set(classes or FAULT_KINDS)
        a = rng.randrange(members)          # the gray victim
        b = (a + 1 + rng.randrange(members - 1)) % members  # the crash victim

        def jit(frac: float, spread: float = 0.05) -> float:
            return duration_s * (frac + rng.uniform(0.0, spread))

        gray_s = min(float(gray_s), duration_s * 0.45)
        faults = []
        if "stall" in want:
            faults.append(FleetFault(
                "stall", a, at_s=jit(0.10), duration_s=gray_s,
            ))
        if "torn_write" in want:
            faults.append(FleetFault("torn_write", b, at_s=jit(0.30)))
        if "clock_skew" in want:
            faults.append(FleetFault(
                "clock_skew", b, at_s=jit(0.42),
                value=-(2.0 * float(ttl_s)),
            ))
        if "checkpoint_corrupt" in want:
            faults.append(FleetFault(
                "checkpoint_corrupt", b, at_s=jit(0.55),
            ))
        if "kill" in want:
            faults.append(FleetFault("kill", b, at_s=jit(0.70)))
        if "delay" in want:
            faults.append(FleetFault(
                "delay", a, at_s=jit(0.82), duration_s=duration_s * 0.1,
                value=0.2,
            ))
        if "drop" in want:
            faults.append(FleetFault(
                "drop", b, at_s=jit(0.88), duration_s=duration_s * 0.08,
            ))
        return cls(faults=faults, seed=int(seed))


class FleetNemesis:
    """Execute a ``FleetChaosPlan`` against live member handles on a
    background thread. Gray-period faults (stall/delay/drop) are
    released at ``at_s + duration_s``; ``stop()`` releases everything
    still gated so teardown never inherits a stalled member."""

    def __init__(
        self,
        plan: FleetChaosPlan,
        handles: Dict[int, object],
        fleet_dir: Optional[str] = None,
        store_root: Optional[str] = None,
        monitor=None,
    ):
        self.plan = plan
        self.handles = dict(handles)
        self.fleet_dir = fleet_dir
        self.store_root = store_root
        self.monitor = monitor
        self.fired: List[dict] = []
        self._rng = random.Random(plan.seed ^ 0x9E3779B9)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._gated: Dict[int, object] = {}  # member -> handle to open

    # -- lifecycle --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self.run, daemon=True, name="fleet-nemesis",
        )
        self._thread.start()

    def run(self) -> None:
        t0 = time.monotonic()
        pending = list(self.plan.scheduled())
        releases: List[tuple] = []  # (release_at, member_id)
        while (pending or releases) and not self._stop.is_set():
            now = time.monotonic() - t0
            while pending and pending[0].at_s <= now:
                f = pending.pop(0)
                self._fire(f, now)
                if f.kind in ("stall", "delay", "drop") and f.duration_s:
                    releases.append(
                        (f.at_s + f.duration_s, f.member_id)
                    )
                    releases.sort()
            while releases and releases[0][0] <= now:
                _, mid = releases.pop(0)
                self._release(mid, now)
            nxt = min(
                [p.at_s for p in pending[:1]]
                + [r[0] for r in releases[:1]]
            ) if (pending or releases) else now
            self._stop.wait(timeout=max(0.05, min(nxt - now, 0.25)))
        self._open_all()

    def stop(self, join_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_s)
        self._open_all()

    def done(self) -> bool:
        t = self._thread
        return t is not None and not t.is_alive()

    # -- execution --

    def _note(self, f: FleetFault, at: float, **extra) -> None:
        row = {"t_s": round(at, 3), **f.to_json(), **extra}
        self.fired.append(row)
        obs_trace.instant(
            "fleet_fault", kind="nemesis",
            fault=f.kind, member=f.member_id,
        )
        if self.monitor is not None:
            self.monitor.note_fault(row)
        log.info("nemesis: %s member=%d t=%.1fs %s",
                 f.kind, f.member_id, at, extra or "")

    def _fire(self, f: FleetFault, at: float) -> None:
        h = self.handles.get(f.member_id)
        try:
            if f.kind == "kill":
                if h is None:
                    raise KeyError(f.member_id)
                h.kill()
                self._note(f, at)
            elif f.kind == "stall":
                if h is None:
                    raise KeyError(f.member_id)
                h.stall()
                self._gated[f.member_id] = h
                self._note(f, at)
            elif f.kind == "delay":
                if h is None:
                    raise KeyError(f.member_id)
                h.delay(f.value)
                self._gated[f.member_id] = h
                self._note(f, at)
            elif f.kind == "drop":
                if h is None:
                    raise KeyError(f.member_id)
                h.drop()
                self._gated[f.member_id] = h
                self._note(f, at)
            elif f.kind == "torn_write":
                torn_member_write(self.fleet_dir, f.member_id)
                self._note(f, at)
            elif f.kind == "clock_skew":
                ts = skew_heartbeat(
                    self.fleet_dir, f.member_id, f.value
                )
                self._note(f, at, applied=ts is not None)
            elif f.kind == "checkpoint_corrupt":
                hit = corrupt_service_checkpoints(
                    self.store_root, self._rng
                )
                self._note(f, at, files=len(hit))
            else:
                self._note(f, at, error=f"unknown kind {f.kind!r}")
        except (OSError, KeyError, ProcessLookupError) as e:
            # a fault aimed at an already-dead member is a no-op, not
            # a drill failure — record the miss and move on
            self._note(f, at, missed=str(e) or type(e).__name__)

    def _release(self, member_id: int, at: float) -> None:
        h = self._gated.pop(member_id, None)
        if h is None:
            return
        try:
            h.open()
        except (OSError, ProcessLookupError):
            pass
        obs_trace.instant(
            "fleet_fault_release", kind="nemesis", member=member_id,
        )
        self.fired.append(
            {"t_s": round(at, 3), "kind": "release",
             "member_id": member_id}
        )

    def _open_all(self) -> None:
        for mid in list(self._gated):
            self._release(mid, -1.0)

    def summary(self) -> dict:
        return {
            "plan": self.plan.to_json(),
            "fired": list(self.fired),
        }


# -- the drill: the whole gauntlet, end to end -------------------------


def _drill_histories(
    seed: int, tenants: Sequence[str], per_tenant: int, n_ops: int
):
    """A FIXED pool of submissions per tenant (deterministic from the
    seed): cycling a bounded pool keeps the oracle pass bounded AND
    makes repeated submission of the same bytes — content-hash
    idempotency under fire — part of the drill itself. Returns
    {tenant: [(body, check_id, model, ops, init_value, durable)]}."""
    from jepsen_tpu_torch.service.server import check_id_for
    from jepsen_tpu_torch.sim import gen_register_history
    from jepsen_tpu_torch.store import op_to_json

    pools: Dict[str, list] = {}
    for t_i, tenant in enumerate(tenants):
        rows = []
        for k in range(per_tenant):
            rng = random.Random(
                (int(seed) * 1000003 + t_i * 101 + k) & 0x7FFFFFFF
            )
            hist = gen_register_history(
                rng, n_ops=n_ops, n_procs=4, p_crash=0.0
            )
            ops = [op_to_json(o) for o in hist.ops]
            model = "cas-register"
            durable = k % 2 == 0
            req: dict = {"history": ops, "model": model}
            if durable:
                req["durable"] = True
            body = json.dumps(req).encode()
            rows.append({
                "body": body,
                "check_id": check_id_for(model, body),
                "model": model,
                "ops": ops,
                "init_value": None,
                "durable": durable,
            })
        pools[tenant] = rows
    return pools


def run_fleet_drill(
    root: str,
    fleet_dir: str,
    *,
    members: int = 2,
    duration_s: float = 30.0,
    seed: int = 0,
    tenants: int = 4,
    per_tenant_histories: int = 4,
    n_ops: int = 40,
    gray_s: float = 12.0,
    forward_timeout_s: float = 3.0,
    health_window_s: float = 5.0,
    restart_budget: int = 3,
    device=None,
    spawn_timeout_s: float = 180.0,
    restore_timeout_s: float = 180.0,
    classes: Optional[Sequence[str]] = None,
    log_dir: Optional[str] = None,
    parity: bool = True,
) -> dict:
    """The full fleet chaos gauntlet (module docstring): spawn a
    subprocess fleet, put a proxy front door + supervisor + invariant
    monitor over it, drive live multi-tenant traffic while the
    seeded ``FleetChaosPlan.drill`` fires, then settle (final sweep of
    unanswered checks, intent recovery, fleet restoration), judge
    verdict parity against a solo in-process oracle, and return the
    invariant report. ``report["clean"]`` is the exit-8 gate.

    ``device``: None runs the members and the oracle on the CUDA card
    (raising here, before any member starts, without one); "cpu" on the
    plain versions."""
    from jepsen_tpu_torch.device import device_label, resolve_device
    from jepsen_tpu_torch.pod import launcher
    from jepsen_tpu_torch.service.client import CheckerClient, ServiceError
    from jepsen_tpu_torch.service.frontdoor import FleetFrontDoor
    from jepsen_tpu_torch.service.invariants import InvariantMonitor
    from jepsen_tpu_torch.service.supervisor import (
        FleetSupervisor,
        SupervisionPolicy,
    )

    oracle_device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    os.makedirs(fleet_dir, exist_ok=True)
    tenant_names = [f"drill-t{i}" for i in range(int(tenants))]
    pools = _drill_histories(
        seed, tenant_names, int(per_tenant_histories), int(n_ops)
    )

    spawn_kwargs = dict(device=device)

    #: every process the drill started, respawns included: the
    #: supervisor's ``procs`` keeps only the newest per member id, and
    #: a fenced older incarnation still draining must not outlive the
    #: drill
    spawned: List[object] = []

    def spawn(member_id: int, epoch: int = 0):
        lp = (
            os.path.join(log_dir, f"member-{member_id}-e{epoch}.log")
            if log_dir else None
        )
        proc = launcher.spawn_fleet_member(
            member_id, fleet_dir, root, epoch=epoch,
            log_path=lp, **spawn_kwargs,
        )
        spawned.append(proc)
        return proc

    procs: List[object] = []
    door = None
    door_thread = None
    sup = None
    nem = None
    monitor = InvariantMonitor(
        target_members=int(members),
        health_window_s=float(health_window_s),
    )
    try:
        with obs_trace.span("fleet_drill", kind="drill",
                            members=members, seed=seed,
                            duration_s=duration_s):
            for i in range(int(members)):
                procs.append(spawn(i))
            launcher.wait_fleet(
                fleet_dir, int(members), timeout_s=spawn_timeout_s
            )
            door = FleetFrontDoor(
                fleet_dir, port=0, mode="proxy",
                forward_timeout_s=float(forward_timeout_s),
                health_window_s=float(health_window_s),
            )
            door_thread = threading.Thread(
                target=door.serve_forever, daemon=True,
                name="drill-door",
            )
            door_thread.start()
            sup = FleetSupervisor(
                fleet_dir, range(int(members)),
                spawn_fn=spawn,
                policy=SupervisionPolicy(
                    restart_budget=int(restart_budget),
                ),
            )
            sup.start()
            monitor.watch(door=door, supervisor=sup)
            plan = FleetChaosPlan.drill(
                members=int(members), duration_s=float(duration_s),
                seed=int(seed), gray_s=float(gray_s),
                ttl_s=door.registry.ttl_s, classes=classes,
            )
            nem = FleetNemesis(
                plan,
                {i: ProcMemberHandle(i, p)
                 for i, p in enumerate(procs)},
                fleet_dir=fleet_dir, store_root=root,
                monitor=monitor,
            )
            nem.start()

            # -- live traffic under fire --
            stop_traffic = threading.Event()

            def tenant_loop(tenant: str, t_i: int) -> None:
                cli = CheckerClient(
                    door.host, door.port, tenant=tenant,
                    timeout_s=float(forward_timeout_s) * 4 + 10,
                    retries=3, backoff_s=0.1,
                )
                rng = random.Random(int(seed) * 7919 + t_i)
                pool, k = pools[tenant], 0
                while not stop_traffic.is_set():
                    row = pool[k % len(pool)]
                    k += 1
                    monitor.note_submitted(
                        tenant, row["check_id"], row["model"],
                        row["ops"], row["init_value"],
                    )
                    try:
                        out = cli._roundtrip(
                            "POST", "/check", row["body"]
                        )
                        monitor.note_verdict(
                            tenant, row["check_id"], out
                        )
                    except (ServiceError, OSError) as e:
                        monitor.note_client_error(
                            tenant, row["check_id"], e
                        )
                    stop_traffic.wait(0.05 + rng.random() * 0.15)

            threads = [
                threading.Thread(
                    target=tenant_loop, args=(t, i), daemon=True,
                    name=f"drill-{t}",
                )
                for i, t in enumerate(tenant_names)
            ]
            for t in threads:
                t.start()
            deadline = time.monotonic() + float(duration_s)
            while time.monotonic() < deadline:
                time.sleep(0.2)
            nem.stop()
            stop_traffic.set()
            for t in threads:
                t.join(timeout=30.0)

            # -- settle: restore the fleet, sweep the stragglers --
            obs_trace.instant("drill_settle", kind="drill")
            restore_deadline = (
                time.monotonic() + float(restore_timeout_s)
            )
            # A member whose first process is gone (killed, or fenced
            # and drained) counts as restored only once a respawned
            # incarnation (epoch >= 1) is alive: the dead process's row
            # stays alive for up to the TTL after its last heartbeat,
            # and the reference's count of alive rows alone can end
            # the drill on it before the supervisor has acted.
            gone = {
                h.member_id for h in nem.handles.values()
                if not h.alive()
            }
            while time.monotonic() < restore_deadline:
                alive = {
                    m.member_id: m
                    for m in door.registry.alive_members()
                }
                if len(alive) >= int(members) and all(
                    mid in alive and alive[mid].epoch >= 1
                    for mid in gone
                ):
                    break
                time.sleep(0.5)
            sweep_errors: List[str] = []
            for req in monitor.pending_requests():
                tenant, cid = req["tenant"], req["check_id"]
                row = next(
                    r for r in pools[tenant]
                    if r["check_id"] == cid
                )
                cli = CheckerClient(
                    door.host, door.port, tenant=tenant,
                    timeout_s=60.0, retries=5, backoff_s=0.2,
                )
                try:
                    out = cli._roundtrip(
                        "POST", "/check", row["body"]
                    )
                    monitor.note_verdict(tenant, cid, out)
                except (ServiceError, OSError) as e:
                    sweep_errors.append(f"{cid}: {e}")
            door.recover_intents()
            try:
                orphan_intents = len([
                    n for n in os.listdir(door.intent_dir)
                    if n.endswith(".json")
                ])
            except OSError:
                orphan_intents = 0
            monitor.stop()
            if sup is not None:
                sup.stop()

            # -- the solo oracle pass --
            oracle_methods: set = set()
            if parity:
                def oracle(model, ops, init_value) -> bool:
                    from jepsen_tpu_torch.checker.linearizable import (
                        LinearizableChecker,
                    )
                    from jepsen_tpu_torch.history.history import History
                    from jepsen_tpu_torch.store import op_from_json

                    hist = History(
                        [op_from_json(d) for d in ops],
                        indexed=True,
                    )
                    out = LinearizableChecker(
                        model=model, init_value=init_value,
                        device=oracle_device,
                    ).check({}, hist)
                    oracle_methods.add(str(out.get("method")))
                    return bool(out.get("valid?"))

                monitor.run_parity(oracle)

            report = monitor.report(orphan_intents=orphan_intents)
            report["sweep_errors"] = sweep_errors
            report["nemesis"] = nem.summary()
            report["supervisor"] = (
                sup.snapshot() if sup is not None else None
            )
            stats = door.fleet_stats()
            report["door"] = stats["door"]
            report["health"] = stats["health"]
            report["oracle"] = {
                "device": device_label(oracle_device),
                "methods": sorted(oracle_methods),
            }
            report["params"] = {
                "members": int(members),
                "duration_s": float(duration_s),
                "seed": int(seed),
                "tenants": int(tenants),
                "gray_s": float(gray_s),
                "forward_timeout_s": float(forward_timeout_s),
                "health_window_s": float(health_window_s),
                "restart_budget": int(restart_budget),
            }
            obs_trace.instant(
                "drill_done", kind="drill",
                clean=report["clean"],
                violations=len(report["violations"]),
            )
            return report
    finally:
        if nem is not None:
            nem.stop()
        monitor.stop()
        if sup is not None:
            sup.stop()
        all_procs = list(spawned)
        for p in all_procs:
            try:
                if p.poll() is None:
                    os.kill(p.pid, signal.SIGCONT)  # unfreeze first
                    p.terminate()
            except (OSError, ProcessLookupError):
                pass
        t_end = time.monotonic() + 15.0
        for p in all_procs:
            try:
                p.wait(timeout=max(0.1, t_end - time.monotonic()))
            except Exception:  # noqa: BLE001
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except (OSError, ProcessLookupError):
                    pass
        if door is not None:
            # shutdown() only after serve_forever started (it waits
            # on the serve loop's exit event and would deadlock on a
            # door whose thread never ran)
            if door_thread is not None:
                door.shutdown()
                door_thread.join(timeout=5.0)
            door.close()
