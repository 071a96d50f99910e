"""Fleet self-healing: restart-budgeted, backoff-governed respawn (the
port of jepsen_tpu.service.supervisor).

The nemesis (``service/nemesis.py``) proves the fleet SURVIVES member
death — checks hand off, verdicts stay correct. This module closes
the loop so the fleet also RECOVERS: a supervisor watches the
membership registry and respawns members that died, under an explicit
``SupervisionPolicy`` (a bounded restart budget per member, and
exponential backoff between attempts, so a crash-looping member
converges to "down, budget exhausted" instead of a fork bomb).

Death evidence is the registry's own: a member file whose heartbeat
expired the TTL, a quarantine row from the front door's dead-on-wire
declaration, or a missing member file. Draining members are LEAVING —
never respawned.

Epoch fencing: every respawn carries ``epoch = prior + 1``, stamped
into ``member-NNN.json`` first by the supervisor (``FleetRegistry.fence``:
the row at the new epoch with an expired heartbeat, so no router routes
to the dead incarnation's URL while the replacement starts; a departure
from the reference, whose stale row lets a router re-quarantine the
member id after its re-admission) and then by the member's announce. A
presumed-dead
incarnation that comes back (SIGSTOP → declared dead → SIGCONT) finds
the higher epoch in its own member file and is FENCED
(``membership.MemberFenced``): it stops heartbeating and drains
instead of reclaiming tenant ownership of in-flight checks that were
already handed off by content identity. The fence is what makes
"respawn" safe against gray failures rather than just crashes.

Lock discipline: respawn DECISIONS are made under the supervisor's
lock; the spawns themselves — subprocess starts, signal sends — always
happen after it is released. A spawn held under
a registry/plane lock stalls every router sharing it for the full
exec latency.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from jepsen_tpu_torch.checker import chaos
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.service.membership import (
    FleetRegistry,
    member_label,
)

log = logging.getLogger("jepsen_tpu_torch.service.supervisor")


@dataclass(frozen=True)
class SupervisionPolicy:
    """How aggressively the supervisor heals.

    ``restart_budget`` is PER MEMBER for the supervisor's lifetime: a
    member that keeps dying stops being respawned once its budget is
    spent (the drill gate checks restoration happened WITHIN budget).
    ``backoff_base_s`` doubles per consecutive respawn of the same
    member, capped at ``backoff_max_s``. ``spawn_grace_s`` is how
    long a freshly-spawned member may take to announce before it is
    considered dead again (a spawn on the card pays the interpreter,
    ``import torch`` and its CUDA context)."""

    restart_budget: int = 3
    backoff_base_s: float = 1.0
    backoff_max_s: float = 30.0
    spawn_grace_s: float = 90.0
    poll_interval_s: float = 0.5
    #: death must persist this long before a respawn fires: one torn
    #: registry row (healed by the member's next heartbeat) or one
    #: slow poll must not fork a duplicate member. Default sits just
    #: above the default heartbeat cadence.
    confirm_s: float = 4.0


class FleetSupervisor:
    """Watch ``fleet_dir``; respawn dead members via ``spawn_fn``.

    ``spawn_fn(member_id, epoch)`` must start a replacement member
    announcing into the same fleet dir with the given epoch, and
    return a process-like object (or None for in-process rigs). The
    default (``spawn_fn=None``) starts a subprocess through
    ``pod/launcher.spawn_fleet_member`` with ``spawn_kwargs`` (its
    ``device=`` among them: None, the card)."""

    def __init__(
        self,
        fleet_dir: str,
        target_members: Sequence[int],
        spawn_fn: Optional[Callable] = None,
        policy: Optional[SupervisionPolicy] = None,
        store_root: Optional[str] = None,
        spawn_kwargs: Optional[dict] = None,
    ):
        self.fleet_dir = fleet_dir
        self.targets = sorted(int(m) for m in target_members)
        self.policy = policy or SupervisionPolicy()
        self.registry = FleetRegistry(fleet_dir)
        self.store_root = store_root
        self._spawn_kwargs = dict(spawn_kwargs or {})
        self._spawn_fn = spawn_fn or self._spawn_subprocess
        self._lock = threading.Lock()
        #: all state below is guarded by _lock
        self._respawns: Dict[int, int] = {m: 0 for m in self.targets}
        self._epochs: Dict[int, int] = {}
        self._next_try: Dict[int, float] = {}
        self._dead_since: Dict[int, float] = {}
        self._pending_until: Dict[int, float] = {}
        self._exhausted: List[int] = []
        self.procs: Dict[int, object] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- default subprocess spawner --

    def _spawn_subprocess(self, member_id: int, epoch: int):
        from jepsen_tpu_torch.pod.launcher import spawn_fleet_member

        if self.store_root is None:
            raise ValueError(
                "FleetSupervisor needs store_root to spawn subprocess "
                "members (or pass a custom spawn_fn)"
            )
        return spawn_fleet_member(
            member_id, self.fleet_dir, self.store_root,
            epoch=epoch, **self._spawn_kwargs,
        )

    # -- lifecycle --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-supervisor",
        )
        self._thread.start()

    def stop(self, join_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_s)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("supervisor poll failed")

    # -- one supervision round --

    def _dead_targets(self) -> List[int]:
        """Members that SHOULD exist but show no life: quarantined,
        heartbeat-expired, or missing. Draining members are leaving
        on purpose — not dead, never respawned."""
        now = time.time()
        rows = {m.member_id: m for m in self.registry.all_members()}
        dead: List[int] = []
        for mid in self.targets:
            m = rows.get(mid)
            if m is not None and m.draining:
                continue
            alive = (
                m is not None
                and now - m.heartbeat_ts <= self.registry.ttl_s
                and not chaos.is_quarantined(member_label(mid))
            )
            if not alive:
                dead.append(mid)
        return dead

    def poll_once(self) -> List[int]:
        """One supervision round; returns the member ids respawned."""
        dead = self._dead_targets()
        alive = set(self.targets) - set(dead)
        now = time.monotonic()
        due: List[tuple] = []
        with self._lock:
            for mid in alive:
                # a member that came back clears its pending window
                # and resets its backoff ladder (recovery is evidence
                # the respawn took)
                self._pending_until.pop(mid, None)
                self._next_try.pop(mid, None)
                self._dead_since.pop(mid, None)
            for mid in dead:
                since = self._dead_since.setdefault(mid, now)
                if now - since < self.policy.confirm_s:
                    continue  # one torn row / slow poll is not death
                if now < self._pending_until.get(mid, 0.0):
                    continue  # a spawn is still warming up
                if now < self._next_try.get(mid, 0.0):
                    continue  # backing off
                n = self._respawns.get(mid, 0)
                if n >= self.policy.restart_budget:
                    if mid not in self._exhausted:
                        self._exhausted.append(mid)
                        log.warning(
                            "member %d: restart budget (%d) "
                            "exhausted; leaving it down",
                            mid, self.policy.restart_budget,
                        )
                    continue
                epoch = max(
                    self._epochs.get(mid, 0),
                    self._filed_epoch(mid),
                ) + 1
                self._respawns[mid] = n + 1
                self._epochs[mid] = epoch
                backoff = min(
                    self.policy.backoff_base_s * (2 ** n),
                    self.policy.backoff_max_s,
                )
                self._next_try[mid] = now + backoff
                self._pending_until[mid] = (
                    now + self.policy.spawn_grace_s
                )
                due.append((mid, epoch))
        # Spawns run OUTSIDE the lock: spawning and
        # signaling under the supervision lock would stall every
        # concurrent poll/snapshot for the full exec latency.
        spawned: List[int] = []
        for mid, epoch in due:
            self._respawn(mid, epoch)
            spawned.append(mid)
        return spawned

    def _filed_epoch(self, member_id: int) -> int:
        m = self.registry.member_by_id(member_id)
        return 0 if m is None else int(m.epoch)

    def _respawn(self, member_id: int, epoch: int) -> None:
        # Supersede the dead incarnation's row first (the reference
        # leaves it, so a router can re-quarantine the member id off
        # the stale row after the re-admission below: membership.fence)
        try:
            self.registry.fence(member_id, epoch)
        except OSError:
            pass
        # Re-admission before spawn: the replacement inherits the dead
        # incarnation's host:<i> quarantine label, and a born-
        # quarantined member would never route. Scoped to one label —
        # no other breaker is amnestied.
        chaos.clear_quarantine_label(member_label(member_id))
        log.info(
            "respawning member %d (epoch %d)", member_id, epoch
        )
        obs_trace.instant(
            "member_respawn", kind="supervisor",
            member=member_id, epoch=epoch,
        )
        try:
            proc = self._spawn_fn(member_id, epoch)
        except Exception:  # noqa: BLE001 - spawn failure != crash
            log.exception("respawn of member %d failed", member_id)
            return
        if proc is not None:
            with self._lock:
                self.procs[member_id] = proc

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "targets": list(self.targets),
                "restart_budget": self.policy.restart_budget,
                "respawns": dict(self._respawns),
                "epochs": dict(self._epochs),
                "exhausted": list(self._exhausted),
                "pending": sorted(self._pending_until),
            }
