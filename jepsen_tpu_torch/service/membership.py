"""Fleet membership: the control plane above the checker daemons (the
port of jepsen_tpu.service.membership).

One daemon owns one plane; many users need N of them. This module makes
N daemons a fleet instead of N strangers: a file-backed membership
registry (members announce themselves with heartbeats into a shared
``fleet_dir``), a consistent hash ring over the alive members (tenants
shard stably: a member joining or leaving moves only ~1/N of the tenant
space), and the death path: a member that stops heartbeating, or that
the front door catches dead on the wire, is quarantined under its
``host:<i>`` label in the chaos module's ledger, which removes it from
routing and records the death.

The member files and the ring are the reference's: the same schema
(``SCHEMA = 1``, ``member-NNN.json``) and the same sha256 points with
``VNODES`` virtual nodes per member, so a tenant routes to the same
member id in both packages and either package's router reads either
package's members.

Identity is filesystem-shaped: fleet members already share a store
root (that is what makes ``check_id_for`` hand-off work: the checkpoint
a dead member wrote is readable by whoever inherits the check), so the
membership plane rides the same shared directory with the same
atomic-write discipline. No new transport, no consensus: heartbeat
freshness and quarantine labels are the liveness truth, and every
router re-derives the ring from them.

Concurrency contract: the cached routing state (``_members``,
``_ring``) is only ever mutated under ``_membership_lock``. Routing
reads take a reference under the lock and never mutate; a stale ring
routes to a member whose admission door answers authoritatively anyway
(429 and connection-refused both reroute), so staleness costs a hop,
never a wrong verdict.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from jepsen_tpu_torch.checker import chaos

#: member files are named member-<id>.json inside the fleet dir
MEMBER_FILE_FMT = "member-{:03d}.json"

#: schema version stamped into member files — old files reject
SCHEMA = 1

#: a member whose heartbeat is older than this is presumed dead
DEFAULT_TTL_S = 10.0

#: default heartbeat cadence (TTL / 3: two missed beats of slack)
DEFAULT_HEARTBEAT_S = DEFAULT_TTL_S / 3.0

#: virtual nodes per member on the hash ring — enough that tenant
#: load spreads within a few percent of uniform at small N
VNODES = 64


def member_label(member_id: int) -> str:
    """The quarantine-ledger label of a fleet member: the host label
    ``host:<i>``, as in the reference, where member i serves host i's
    slice in a pod-backed fleet."""
    return f"{chaos.HOST_PREFIX}{int(member_id)}"


class MemberFenced(RuntimeError):
    """This member's identity has been superseded: its member file
    carries a HIGHER epoch than its own (the supervisor respawned a
    replacement while this incarnation was presumed dead). A fenced
    member must stop announcing and drain — its in-flight checks were
    already handed off by content identity, and re-claiming ownership
    would double-own them."""


@dataclass(frozen=True)
class MemberInfo:
    """One member's announced identity, as read from its file."""

    member_id: int
    url: str
    pid: int
    started_at: float
    heartbeat_ts: float
    draining: bool = False
    #: supervision epoch: bumped by every supervisor respawn. The
    #: journal fence — an older incarnation (lower epoch) may never
    #: overwrite the row of the member that replaced it.
    epoch: int = 0

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "member_id": self.member_id,
            "url": self.url,
            "pid": self.pid,
            "started_at": self.started_at,
            "heartbeat_ts": self.heartbeat_ts,
            "draining": self.draining,
            "epoch": self.epoch,
        }


class HashRing:
    """Consistent hashing over member ids (sha256 points, VNODES
    virtual nodes per member). Immutable once built — membership
    changes build a NEW ring, so a reader holding a reference can
    never see a half-updated one."""

    def __init__(self, member_ids, vnodes: int = VNODES):
        points: List[Tuple[int, int]] = []
        for mid in sorted(set(int(m) for m in member_ids)):
            for v in range(vnodes):
                h = hashlib.sha256(
                    f"member{mid}:vnode{v}".encode()
                ).digest()
                points.append(
                    (int.from_bytes(h[:8], "big"), mid)
                )
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]
        self.member_ids = tuple(
            sorted(set(p[1] for p in points))
        )

    def __len__(self) -> int:
        return len(self.member_ids)

    def route(self, tenant: str) -> Optional[int]:
        """The member id owning this tenant (clockwise successor of
        the tenant's hash point), or None on an empty ring."""
        if not self._points:
            return None
        h = hashlib.sha256(str(tenant).encode()).digest()
        point = int.from_bytes(h[:8], "big")
        i = bisect.bisect_right(self._keys, point)
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def successors(self, tenant: str) -> List[int]:
        """Every member id, owner first then distinct clockwise
        successors — the hand-off / steal order for this tenant."""
        if not self._points:
            return []
        h = hashlib.sha256(str(tenant).encode()).digest()
        point = int.from_bytes(h[:8], "big")
        i = bisect.bisect_right(self._keys, point)
        seen: List[int] = []
        for k in range(len(self._points)):
            mid = self._points[(i + k) % len(self._points)][1]
            if mid not in seen:
                seen.append(mid)
            if len(seen) == len(self.member_ids):
                break
        return seen


class FleetRegistry:
    """File-backed membership over a shared ``fleet_dir``.

    A member constructs one with its own identity and calls
    ``announce()`` after binding its socket (then ``heartbeat()`` on
    a cadence — ``start_heartbeat`` runs the loop on a daemon
    thread). Routers construct one with no identity and call
    ``route``/``alive_members``. ``note_member_death`` is the shared
    death path: heartbeat expiry is the passive detector, a router
    catching a connection error is the active one; both land in the
    same quarantine ladder."""

    def __init__(
        self,
        fleet_dir: str,
        member_id: Optional[int] = None,
        url: Optional[str] = None,
        ttl_s: float = DEFAULT_TTL_S,
        epoch: int = 0,
    ):
        self.fleet_dir = fleet_dir
        self.member_id = member_id
        self.url = url
        self.ttl_s = float(ttl_s)
        self.epoch = int(epoch)
        os.makedirs(fleet_dir, exist_ok=True)
        self._membership_lock = threading.Lock()
        #: routing cache, guarded by _membership_lock:
        #: the alive-id tuple the cached ring was built from
        self._members: Tuple[int, ...] = ()
        self._ring: Optional[HashRing] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._started_at = time.time()

    # -- member side ---------------------------------------------------

    def _my_path(self) -> str:
        if self.member_id is None:
            raise ValueError("registry has no member identity")
        return os.path.join(
            self.fleet_dir, MEMBER_FILE_FMT.format(self.member_id)
        )

    def _filed_epoch(self) -> Optional[int]:
        """The epoch currently on disk for this member id, or None
        when the file is missing/torn."""
        try:
            with open(self._my_path(), encoding="utf-8") as f:
                d = json.load(f)
            return int(d.get("epoch", 0))
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def announce(self, draining: bool = False) -> MemberInfo:
        """Durably publish this member's identity + a fresh
        heartbeat. Atomic (tmp+rename via the store primitive), so a
        reader never sees a torn member file.

        The journal fence rides every announce: if the file on disk
        already carries a HIGHER epoch, a supervisor respawned a
        replacement while this incarnation was stalled or presumed
        dead — raise ``MemberFenced`` instead of overwriting, so a
        resurrected zombie can never reclaim the member row (or the
        tenant ownership that goes with it)."""
        from jepsen_tpu_torch.store import atomic_write_text

        filed = self._filed_epoch()
        if filed is not None and filed > self.epoch:
            raise MemberFenced(
                f"member {self.member_id} epoch {self.epoch} "
                f"superseded by epoch {filed}"
            )
        info = MemberInfo(
            member_id=int(self.member_id),
            url=str(self.url),
            pid=os.getpid(),
            started_at=self._started_at,
            heartbeat_ts=time.time(),
            draining=bool(draining),
            epoch=self.epoch,
        )
        atomic_write_text(
            self._my_path(), json.dumps(info.to_json())
        )
        return info

    heartbeat = announce

    def start_heartbeat(
        self,
        interval_s: float = DEFAULT_HEARTBEAT_S,
        on_fenced=None,
    ) -> None:
        """Heartbeat on a daemon thread until ``stop_heartbeat``.
        ``on_fenced`` fires (once, from the heartbeat thread) when an
        announce raises ``MemberFenced`` — the member should drain."""
        if self._hb_thread is not None:
            return
        self._hb_stop.clear()

        def _loop():
            while not self._hb_stop.wait(interval_s):
                try:
                    self.announce()
                except MemberFenced:
                    if on_fenced is not None:
                        try:
                            on_fenced()
                        except Exception:  # noqa: BLE001
                            pass
                    return
                except OSError:
                    pass  # fleet dir went away: the TTL judges us

        t = threading.Thread(
            target=_loop, daemon=True,
            name=f"fleet-heartbeat-{self.member_id}",
        )
        t.start()
        self._hb_thread = t

    def stop_heartbeat(self, join_s: float = 2.0) -> None:
        self._hb_stop.set()
        t = self._hb_thread
        if t is not None:
            t.join(timeout=join_s)
        self._hb_thread = None

    def retire(self) -> None:
        """Graceful leave: stop heartbeating and delete the member
        file, so routers drop this member on their next ring rebuild
        without waiting out the TTL (and without a quarantine row —
        retirement is not death). Fenced incarnations must NOT unlink:
        the file now belongs to the higher-epoch replacement."""
        self.stop_heartbeat()
        filed = self._filed_epoch()
        if filed is not None and filed > self.epoch:
            return
        try:
            os.unlink(self._my_path())
        except OSError:
            pass

    # -- router side ---------------------------------------------------

    def all_members(self) -> List[MemberInfo]:
        """Every announced member, fresh from disk, alive or not."""
        out: List[MemberInfo] = []
        try:
            names = sorted(os.listdir(self.fleet_dir))
        except OSError:
            return out
        for name in names:
            if not (
                name.startswith("member-")
                and name.endswith(".json")
            ):
                continue
            try:
                with open(
                    os.path.join(self.fleet_dir, name),
                    encoding="utf-8",
                ) as f:
                    d = json.load(f)
                if d.get("schema") != SCHEMA:
                    continue
                out.append(MemberInfo(
                    member_id=int(d["member_id"]),
                    url=str(d["url"]),
                    pid=int(d.get("pid", 0)),
                    started_at=float(d.get("started_at", 0.0)),
                    heartbeat_ts=float(d["heartbeat_ts"]),
                    draining=bool(d.get("draining")),
                    epoch=int(d.get("epoch", 0)),
                ))
            except (OSError, ValueError, KeyError, TypeError):
                continue  # torn/foreign file: not a member
        return out

    def alive_members(self) -> List[MemberInfo]:
        """Members with a fresh heartbeat, not draining, and not
        quarantined by the death ladder."""
        now = time.time()
        return [
            m for m in self.all_members()
            if now - m.heartbeat_ts <= self.ttl_s
            and not m.draining
            and not chaos.is_quarantined(member_label(m.member_id))
        ]

    def ring(self) -> HashRing:
        """The consistent-hash ring over the currently-alive members
        (cached; rebuilt under the membership lock only when the
        alive set changed)."""
        alive = tuple(
            sorted(m.member_id for m in self.alive_members())
        )
        with self._membership_lock:
            if self._ring is None or self._members != alive:
                self._ring = HashRing(alive)
                self._members = alive
            return self._ring

    def member_by_id(
        self, member_id: int
    ) -> Optional[MemberInfo]:
        for m in self.all_members():
            if m.member_id == int(member_id):
                return m
        return None

    def route(self, tenant: str) -> Optional[MemberInfo]:
        """The alive member owning ``tenant``, or None when the
        fleet is empty."""
        mid = self.ring().route(tenant)
        return None if mid is None else self.member_by_id(mid)

    def route_order(self, tenant: str) -> List[MemberInfo]:
        """Owner first, then hand-off/steal successors — only alive
        members appear."""
        by_id = {
            m.member_id: m for m in self.alive_members()
        }
        return [
            by_id[mid]
            for mid in self.ring().successors(tenant)
            if mid in by_id
        ]

    def fence(self, member_id: int, epoch: int) -> None:
        """Supersede a dead incarnation's row before its replacement
        starts: rewrite it at ``epoch`` with an expired heartbeat. A
        router stops routing to the dead URL at once (without this the
        row stays alive for up to the TTL after the last heartbeat, and
        a router that finds the URL refused quarantines the member id
        again, after the supervisor re-admitted it, so the replacement
        would be born quarantined), and an older incarnation that comes
        back finds the higher epoch and fences itself. The replacement's
        own announce at ``epoch`` overwrites the row."""
        from jepsen_tpu_torch.store import atomic_write_text

        old = self.member_by_id(member_id)
        info = MemberInfo(
            member_id=int(member_id),
            url=old.url if old is not None else "",
            pid=old.pid if old is not None else 0,
            started_at=old.started_at if old is not None else 0.0,
            heartbeat_ts=0.0,
            epoch=int(epoch),
        )
        atomic_write_text(
            os.path.join(
                self.fleet_dir, MEMBER_FILE_FMT.format(int(member_id))
            ),
            json.dumps(info.to_json()),
        )

    # -- the death path ------------------------------------------------

    def note_member_death(self, member_id: int) -> Tuple[str, ...]:
        """Declare a member dead. The label quarantines at once
        (routers drop it on the next ring rebuild, no TTL wait) and,
        inside a real multi-process pod, the dead member's whole slot
        slice ejects through the faultdomains ladder before the next
        collective. Localhost fleets (independent planes) get the label
        and ledger row only: there is no shared mesh to shrink. Returns
        the ejected slot labels (empty off-pod)."""
        from jepsen_tpu_torch.pod import topology

        if topology.is_multiprocess():
            from jepsen_tpu_torch.pod import faultdomains

            return faultdomains.note_host_death(int(member_id))
        chaos.quarantine_label(member_label(member_id))
        return ()

    def snapshot(self) -> dict:
        """The /fleet view: members (alive + dead), the ring's
        routing table, and the quarantine census."""
        alive = {m.member_id for m in self.alive_members()}
        ring = self.ring()
        return {
            "fleet_dir": self.fleet_dir,
            "ttl_s": self.ttl_s,
            "members": [
                {**m.to_json(), "alive": m.member_id in alive}
                for m in self.all_members()
            ],
            "ring_members": list(ring.member_ids),
            "quarantined_members": [
                int(h) for h in chaos.quarantined_hosts()
                if str(h).isdigit()
            ],
        }


def tenant_spread(
    ring: HashRing, tenants, by_member: Optional[Dict] = None
) -> Dict[int, int]:
    """How many of ``tenants`` each member owns — the balance the
    tests pin (consistent hashing keeps max/mean bounded)."""
    out: Dict[int, int] = dict(by_member or {})
    for t in tenants:
        mid = ring.route(t)
        if mid is not None:
            out[mid] = out.get(mid, 0) + 1
    return out
