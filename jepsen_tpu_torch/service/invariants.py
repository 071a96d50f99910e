"""Continuous fleet-invariant monitoring for chaos drills (the port of
jepsen_tpu.service.invariants).

The reference framework's checker judges a DATABASE's history against
its model; this monitor judges the CHECKER FLEET's own history
against the three contracts the fleet architecture promises
(frontdoor.py module docstring), while the nemesis is actively
breaking members:

1. **Zero accepted-check loss** — every submission the fleet accepted
   eventually yields a verdict (client receipt or replayed intent);
   after recovery the durable intent journal is empty.
2. **At-most-once verdict side-effects per check_id** — content-hash
   identity makes duplicate submission idempotent, so every verdict
   observed for one check_id must be IDENTICAL. Two divergent
   verdicts for one check_id means a hand-off or a fenced zombie
   double-applied.
3. **Verdict parity vs a solo-plane oracle** — the fleet under chaos
   answers exactly what one clean solo checker answers for the same
   history. Hand-off, resume, corruption-rejection, and hedged
   duplicates may change COST, never the verdict.

Drill-health contracts ride the same report (fed by the ``watch``
sampler): a gray (stalled) member must leave routing within 2× the
front door's health window, and the supervisor must restore
``members_alive`` to target within its restart budget.

The monitor is stdlib-only and passive: the drill code feeds it client
receipts (``note_submitted`` / ``note_verdict`` / ``note_client_error``),
the nemesis feeds it fired faults (``note_fault``), and ``watch``
samples the door + registry on a thread. ``report()`` flattens
everything into the JSON block ``cli fleet-drill`` prints; ``clean`` is
the exit-8 gate."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from jepsen_tpu_torch.obs import trace as obs_trace


class InvariantMonitor:
    """Passive recorder + judge for the fleet contracts (module
    docstring). All note_* feeds are thread-safe; ``report()`` may be
    called once the drill has settled."""

    def __init__(
        self,
        target_members: Optional[int] = None,
        health_window_s: Optional[float] = None,
    ):
        self.target_members = target_members
        self.health_window_s = health_window_s
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        #: check_id -> {"tenant", "model", "ops", "init_value",
        #:              "submissions", "receipts", "errors"}
        self._checks: Dict[str, dict] = {}
        #: check_id -> list of distinct verdict fingerprints seen
        self._verdicts: Dict[str, List[tuple]] = {}
        self._faults: List[dict] = []
        self._timeline: List[dict] = []
        self._client_errors = 0
        self._parity: Optional[dict] = None
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None

    def _now(self) -> float:
        return time.monotonic() - self._t0

    # -- client-side feeds --

    def note_submitted(
        self, tenant: str, check_id: str, model: str,
        ops: list, init_value=None,
    ) -> None:
        with self._lock:
            row = self._checks.setdefault(check_id, {
                "tenant": tenant, "model": model, "ops": ops,
                "init_value": init_value,
                "submissions": 0, "receipts": 0, "errors": 0,
            })
            row["submissions"] += 1

    def note_verdict(
        self, tenant: str, check_id: str, out: dict
    ) -> None:
        fp = (bool(out.get("valid?")),)
        with self._lock:
            row = self._checks.get(check_id)
            if row is not None:
                row["receipts"] += 1
            fps = self._verdicts.setdefault(check_id, [])
            if fp not in fps:
                fps.append(fp)

    def note_client_error(
        self, tenant: str, check_id: Optional[str], err
    ) -> None:
        with self._lock:
            self._client_errors += 1
            if check_id is not None:
                row = self._checks.get(check_id)
                if row is not None:
                    row["errors"] += 1

    def note_fault(self, fault: dict) -> None:
        with self._lock:
            self._faults.append(
                {"at_mono_s": self._now(), **fault}
            )

    def unresolved(self) -> List[str]:
        """check_ids submitted but never answered — the final-sweep
        worklist (a drill resubmits these once the nemesis stops; a
        survivor after the sweep is a LOST check)."""
        with self._lock:
            return sorted(
                cid for cid, row in self._checks.items()
                if row["receipts"] == 0
            )

    def pending_requests(self) -> List[dict]:
        """Submission payload descriptors for every unresolved check
        (what the final sweep re-POSTs)."""
        with self._lock:
            return [
                {"check_id": cid, **{
                    k: self._checks[cid][k]
                    for k in ("tenant", "model", "ops", "init_value")
                }}
                for cid in self.unresolved_locked()
            ]

    def unresolved_locked(self) -> List[str]:
        # caller already holds self._lock
        return sorted(
            cid for cid, row in self._checks.items()
            if row["receipts"] == 0
        )

    # -- the watcher thread --

    def watch(
        self,
        door=None,
        registry=None,
        supervisor=None,
        interval_s: float = 0.5,
    ) -> None:
        """Sample fleet health on a thread until ``stop()``: alive
        members from the registry, the door's routable set (alive
        minus degraded-evicted), and the door's routing counters.
        Feeds the gray-eviction and restoration judgments."""
        if self._watch_thread is not None:
            return
        reg = registry or (door.registry if door is not None else None)

        def sample() -> None:
            row: dict = {"t_s": round(self._now(), 3)}
            if reg is not None:
                alive = [m.member_id for m in reg.alive_members()]
                row["alive"] = sorted(alive)
                row["members_alive"] = len(alive)
            if door is not None:
                h = door.health_snapshot()
                row["degraded"] = h["degraded"]
                row["routable"] = sorted(
                    set(row.get("alive", [])) - set(h["degraded"])
                )
            if supervisor is not None:
                snap = supervisor.snapshot()
                row["respawns"] = sum(snap["respawns"].values())
            with self._lock:
                self._timeline.append(row)

        def loop() -> None:
            while not self._watch_stop.wait(interval_s):
                try:
                    sample()
                except Exception:  # noqa: BLE001 - keep sampling
                    pass
            try:
                sample()  # one final settled row
            except Exception:  # noqa: BLE001
                pass

        self._watch_stop.clear()
        t = threading.Thread(
            target=loop, daemon=True, name="invariant-watch",
        )
        t.start()
        self._watch_thread = t

    def stop(self, join_s: float = 3.0) -> None:
        self._watch_stop.set()
        t = self._watch_thread
        if t is not None:
            t.join(timeout=join_s)
        self._watch_thread = None

    # -- the oracle pass --

    def run_parity(
        self, oracle: Callable[[str, list, object], bool],
        max_checks: Optional[int] = None,
    ) -> dict:
        """Re-judge every unique answered history through
        ``oracle(model, ops, init_value) -> valid?`` (a solo clean
        plane) and compare against the fleet's verdicts. Stores and
        returns the parity block."""
        with self._lock:
            work = [
                (cid, dict(row)) for cid, row in self._checks.items()
                if self._verdicts.get(cid)
            ]
        if max_checks is not None:
            work = work[:max_checks]
        compared, mismatches = 0, []
        for cid, row in work:
            with obs_trace.span("oracle_check", kind="drill",
                                check_id=cid):
                want = bool(oracle(
                    row["model"], row["ops"], row["init_value"]
                ))
            got = self._verdicts[cid][0][0]
            compared += 1
            if want != got:
                mismatches.append({
                    "check_id": cid, "tenant": row["tenant"],
                    "fleet": got, "oracle": want,
                })
        block = {"compared": compared, "mismatches": mismatches}
        with self._lock:
            self._parity = block
        return block

    # -- judgment --

    def _gray_violations(self) -> List[dict]:
        """Every stall fault must be followed by the victim leaving
        the routable set within 2× the health window (door eviction,
        quarantine, or TTL expiry all count — the contract is 'stops
        receiving traffic', not the mechanism)."""
        if self.health_window_s is None:
            return []
        budget = 2.0 * self.health_window_s
        out: List[dict] = []
        for f in self._faults:
            if f.get("kind") != "stall":
                continue
            mid, t0 = f.get("member_id"), f.get("at_mono_s", 0.0)
            evicted_at = None
            for row in self._timeline:
                if row["t_s"] < t0 or "routable" not in row:
                    continue
                if mid not in row["routable"]:
                    evicted_at = row["t_s"]
                    break
            if evicted_at is None or evicted_at - t0 > budget:
                out.append({
                    "invariant": "gray-eviction",
                    "member_id": mid,
                    "stalled_at_s": round(t0, 3),
                    "evicted_at_s": (
                        None if evicted_at is None
                        else round(evicted_at, 3)
                    ),
                    "budget_s": budget,
                })
        return out

    def report(self, orphan_intents: int = 0) -> dict:
        """The drill verdict: violations per contract, plus the raw
        evidence (counts, timeline tail, faults). ``clean`` is the
        exit-8 gate."""
        with self._lock:
            checks = {k: dict(v) for k, v in self._checks.items()}
            verdicts = {k: list(v) for k, v in self._verdicts.items()}
            timeline = list(self._timeline)
            faults = list(self._faults)
            parity = self._parity
            client_errors = self._client_errors
        violations: List[dict] = []
        lost = [
            cid for cid, row in checks.items()
            if row["receipts"] == 0
        ]
        for cid in lost:
            violations.append({
                "invariant": "zero-loss", "check_id": cid,
                "tenant": checks[cid]["tenant"],
                "submissions": checks[cid]["submissions"],
            })
        if orphan_intents:
            violations.append({
                "invariant": "zero-loss",
                "orphan_intents": int(orphan_intents),
            })
        for cid, fps in verdicts.items():
            if len(fps) > 1:
                violations.append({
                    "invariant": "at-most-once", "check_id": cid,
                    "distinct_verdicts": [list(f) for f in fps],
                })
        if parity is not None:
            for m in parity["mismatches"]:
                violations.append(
                    {"invariant": "verdict-parity", **m}
                )
        violations.extend(self._gray_violations())
        final = timeline[-1] if timeline else {}
        if (
            self.target_members is not None
            and timeline
            and final.get("members_alive", self.target_members)
            < self.target_members
        ):
            violations.append({
                "invariant": "fleet-restored",
                "members_alive": final.get("members_alive"),
                "target": self.target_members,
            })
        return {
            "clean": not violations,
            "violations": violations,
            "checks": {
                "unique": len(checks),
                "submissions": sum(
                    r["submissions"] for r in checks.values()
                ),
                "receipts": sum(
                    r["receipts"] for r in checks.values()
                ),
                "lost": len(lost),
                "client_errors": client_errors,
            },
            "verdict_identity": {
                "check_ids_with_verdicts": len(verdicts),
                "divergent": sum(
                    1 for f in verdicts.values() if len(f) > 1
                ),
            },
            "parity": parity,
            "faults": faults,
            "final_sample": final,
            "samples": len(timeline),
        }
