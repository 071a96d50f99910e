"""The port's fleet nemesis, supervisor and invariant gate
(jepsen_tpu_torch.service: nemesis.py, supervisor.py, invariants.py and
the front door's gray-failure plane), on the CPU.

The plan and the report are held against the JAX package's: the seeded
``FleetChaosPlan.drill`` schedules are equal, and ``InvariantMonitor``
judges the same feed into the same report. The in-process cases follow
tests/test_fleet_chaos.py's, case for case, on the port's daemons
(device="cpu", tests/test_torch_fleet.py's ``Fleet`` rig): a stalled
member is suspected and hedged, never declared dead; a stream survives
its sticky owner's death; a respawned incarnation fences the old one;
quarantine re-admission is scoped to one label; and the mini drill with
a supervised respawn comes back clean. Tolerance: exact equality."""

import json
import os
import threading
import time

import pytest
from test_torch_fleet import N_OPS, Fleet, fstrip, owned_by
from test_torch_service import register, strip

from jepsen_tpu.service import invariants as r_inv
from jepsen_tpu.service import nemesis as r_nem

from jepsen_tpu_torch.checker import chaos
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.service.client import ServiceError, encode_history
from jepsen_tpu_torch.service.invariants import InvariantMonitor
from jepsen_tpu_torch.service.membership import (
    FleetRegistry,
    MemberFenced,
    member_label,
)
from jepsen_tpu_torch.service.nemesis import (
    FAULT_KINDS,
    FleetChaosPlan,
    FleetFault,
    FleetNemesis,
    LocalMemberHandle,
)
from jepsen_tpu_torch.service.server import check_id_for
from jepsen_tpu_torch.service.supervisor import (
    FleetSupervisor,
    SupervisionPolicy,
)
from jepsen_tpu_torch.store import op_from_json

pytestmark = [pytest.mark.service, pytest.mark.fleet,
              pytest.mark.fleet_chaos]


@pytest.fixture(autouse=True)
def _clean():
    yield
    chaos.reset_resilience()
    t_dp.reset_default_plane()


# -- the plan and the report against the reference ------------------------


@pytest.mark.parametrize("seed", range(5))
def test_drill_plan_equals_the_reference(seed):
    """The canonical gauntlet's seeded schedule is the reference's, for
    every class and for the smoke subset."""
    for kw in ({}, {"members": 3, "duration_s": 20.0},
               {"classes": ("kill", "torn_write")}):
        got = FleetChaosPlan.drill(seed=seed, **kw).to_json()
        want = r_nem.FleetChaosPlan.drill(seed=seed, **kw).to_json()
        assert got == want
    assert {f["kind"] for f in FleetChaosPlan.drill(seed=seed).to_json()[
        "faults"]} == set(FAULT_KINDS)


def _feed(mon):
    """One feed for either package's monitor: two checks, one lost,
    one answered twice with divergent verdicts, an error, a stall and
    its eviction sampled 1 s later, and a parity pass with a mismatch."""
    mon.note_submitted("a", "c1", "cas-register", [], None)
    mon.note_submitted("a", "c1", "cas-register", [], None)
    mon.note_verdict("a", "c1", {"valid?": True})
    mon.note_verdict("a", "c1", {"valid?": False})
    mon.note_submitted("b", "c2", "cas-register", [], None)
    mon.note_client_error("b", "c2", OSError("reset"))
    mon.note_submitted("b", "c3", "cas-register", [], None)
    mon.note_verdict("b", "c3", {"valid?": True})
    mon._faults.append({"at_mono_s": 1.0, "kind": "stall",
                        "member_id": 1})
    mon._faults.append({"at_mono_s": 2.0, "kind": "kill",
                        "member_id": 0})
    for t, routable, alive in ((0.5, [0, 1], 2), (2.0, [0], 1),
                               (9.0, [0], 1)):
        mon._timeline.append({"t_s": t, "routable": routable,
                              "alive": routable, "members_alive": alive})
    mon.run_parity(lambda model, ops, init: False)
    return mon.report(orphan_intents=1)


def test_invariant_report_equals_the_reference():
    got = _feed(InvariantMonitor(target_members=2, health_window_s=5.0))
    want = _feed(r_inv.InvariantMonitor(target_members=2,
                                        health_window_s=5.0))
    assert got == want
    assert not got["clean"]
    assert sorted({v["invariant"] for v in got["violations"]}) == [
        "at-most-once", "fleet-restored", "verdict-parity", "zero-loss"]
    # a gray member evicted past its 2x-window budget is a violation
    late = InvariantMonitor(target_members=2, health_window_s=0.25)
    rlate = r_inv.InvariantMonitor(target_members=2, health_window_s=0.25)
    assert _feed(late)["violations"] == _feed(rlate)["violations"]
    assert any(v["invariant"] == "gray-eviction"
               for v in _feed(InvariantMonitor(
                   target_members=2, health_window_s=0.25))["violations"])


# -- gray failure: suspect, hedge, drain — never declare death ------------


def test_stalled_member_is_suspected_not_killed(tmp_path):
    """A stalled member (accepts connections, replies never come: the
    in-process SIGSTOP) rides the suspect/hedge ladder: its tenants'
    checks succeed on the ring successor, it is never quarantined,
    three strikes drain it from routing, and after the cooldown it
    serves again."""
    fl = Fleet(tmp_path, door_kw=dict(forward_timeout_s=0.75,
                                      health_window_s=1.0))
    handle = LocalMemberHandle(0, fl.daemons[0])
    try:
        ring = fl.door.registry.ring()
        victim, survivor = 0, 1
        good = register(1901, n_ops=N_OPS)
        local = LinearizableChecker(device="cpu").check({}, good)
        handle.stall()
        for k in range(3):
            t = owned_by(ring, victim, prefix=f"gray{k}")
            out = fl.client(t, timeout_s=30).check(good)
            assert out["fleet_member"] == survivor
            assert fstrip(out) == strip(local)
        assert not chaos.is_quarantined(member_label(victim))
        assert chaos.quarantined_hosts() == ()
        c = fl.door._counters
        assert c["member_deaths"] == 0
        assert c["suspects"] >= 3 and c["hedges"] >= 3
        assert victim in fl.door.health_snapshot()["degraded"]
        # a drained member is skipped without paying the timeout
        before = c["suspects"]
        t = owned_by(ring, victim, prefix="drained")
        assert fl.client(t, timeout_s=30).check(good)[
            "fleet_member"] == survivor
        assert fl.door._counters["suspects"] == before
        # recovery: unstall, wait out the cooldown, probation
        handle.unstall()
        time.sleep(fl.door.degrade_cooldown_s + 0.3)
        t = owned_by(ring, victim, prefix="healed")
        assert fl.client(t, timeout_s=30).check(good)[
            "fleet_member"] == victim
        assert victim not in fl.door.health_snapshot()["degraded"]
    finally:
        handle.open()
        fl.close()


# -- sticky streams survive the sticky owner dying ------------------------


def test_stream_survives_sticky_owner_death(tmp_path):
    """Kill the stream's sticky owner after the first chunk: the next
    append fails over, the client stream replays its buffered prefix at
    the new owner, and the final verdict is the solo check's."""
    fl = Fleet(tmp_path)
    try:
        ring = fl.door.registry.ring()
        victim, survivor = 0, 1
        tenant = owned_by(ring, victim, prefix="stream")
        good = register(1902, n_ops=45)
        local = LinearizableChecker(device="cpu").check({}, good)
        ops = list(good)
        sc = fl.client(tenant, timeout_s=30).stream("s-chaos-1")
        assert sc.append(ops[:15])["fleet_member"] == victim
        LocalMemberHandle(victim, fl.daemons[victim]).kill()
        assert sc.append(ops[15:30])["fleet_member"] == survivor
        out = sc.finish(ops[30:])
        assert out["fleet_member"] == survivor and sc.replays >= 1
        assert out["valid?"] == local["valid?"]
        # dead on the wire: the death ladder, not the suspect ladder
        assert chaos.quarantined_hosts() == (str(victim),)
        assert chaos.quarantined_devices() == ()
        assert fl.door._counters["member_deaths"] >= 1
    finally:
        fl.close()


# -- supervision epoch fencing --------------------------------------------


def test_epoch_fencing_blocks_resurrected_incarnation(tmp_path):
    """A replacement with a higher epoch fences the old incarnation:
    its announce raises, its retire leaves the replacement's row, and a
    heartbeating zombie drains through on_fenced; a fenced daemon
    emits member_fenced and drains."""
    fdir = str(tmp_path / "fleet")
    old = FleetRegistry(fdir, member_id=0, url="http://127.0.0.1:1")
    old.announce()
    repl = FleetRegistry(fdir, member_id=0, url="http://127.0.0.1:2",
                         epoch=1)
    repl.announce()
    with pytest.raises(MemberFenced):
        old.announce()
    old.retire()
    assert old._filed_epoch() == 1
    assert [(m.member_id, m.epoch, m.url)
            for m in FleetRegistry(fdir).alive_members()] == [
        (0, 1, "http://127.0.0.1:2")]
    fenced = threading.Event()
    old.start_heartbeat(interval_s=0.05, on_fenced=fenced.set)
    assert fenced.wait(5.0)
    old.stop_heartbeat()
    repl.retire()

    fl = Fleet(tmp_path, n=1, name="daemon")
    try:
        d = fl.daemons[0]
        FleetRegistry(fl.fdir, member_id=0, url="http://127.0.0.1:3",
                      epoch=1).announce()
        d._on_fenced()
        assert d.admission.draining
        fl.threads[0].join(timeout=10)
        assert not fl.threads[0].is_alive()
        # the fenced member left the replacement's row alone
        assert FleetRegistry(fl.fdir).member_by_id(0).epoch == 1
    finally:
        fl.close()


def test_clear_quarantine_label_is_scoped():
    """Re-admission amnesties exactly one label; hooks see each
    quarantine once, with no lock held."""
    seen = []

    def hook(label):
        seen.append((label, chaos.is_quarantined(label)))

    chaos.add_quarantine_hook(hook)
    try:
        assert chaos.quarantine_label(member_label(0)) is True
        assert chaos.quarantine_label(member_label(0)) is False
        chaos.quarantine_label(member_label(1))
        chaos.note_device_failure("tenant:t", quarantine_after=1)
        assert chaos.clear_quarantine_label(member_label(0)) is True
        assert not chaos.is_quarantined(member_label(0))
        assert chaos.is_quarantined(member_label(1))
        assert chaos.is_quarantined("tenant:t")
        assert chaos.clear_quarantine_label(member_label(0)) is False
    finally:
        chaos.remove_quarantine_hook(hook)
    assert seen == [("host:0", True), ("host:1", True),
                    ("tenant:t", True)]
    assert chaos.quarantined_hosts() == ("1",)
    assert chaos.quarantined_devices() == ()


# -- supervision: the respawned row --------------------------------------


def test_respawn_supersedes_the_dead_row(tmp_path):
    """A departure from the reference: the supervisor rewrites a dead
    member's row at the new epoch with an expired heartbeat before it
    spawns the replacement. The dead incarnation's URL leaves routing
    at once (the reference's stale row stays routable for up to the
    TTL, and a router that finds it refused quarantines the member id
    again after the re-admission), and the replacement, when it
    announces, routes."""
    from jepsen_tpu.service import membership as r_mem
    from jepsen_tpu.service import supervisor as r_sup
    from jepsen_tpu.checker import chaos as r_chaos

    policy = dict(confirm_s=0.0, poll_interval_s=0.1)
    alive = {}
    for name, mem, sup_mod, ch in (
            ("port", None, None, chaos),
            ("ref", r_mem, r_sup, r_chaos)):
        fdir = str(tmp_path / name)
        reg_cls = FleetRegistry if mem is None else mem.FleetRegistry
        for i in (0, 1):
            reg_cls(fdir, member_id=i,
                    url=f"http://127.0.0.1:{7000 + i}").announce()
        router = reg_cls(fdir)
        router.note_member_death(0)  # the door found it refused
        spawns = []
        sup_cls = (FleetSupervisor if sup_mod is None
                   else sup_mod.FleetSupervisor)
        pol_cls = (SupervisionPolicy if sup_mod is None
                   else sup_mod.SupervisionPolicy)
        sup = sup_cls(fdir, range(2),
                      spawn_fn=lambda m, e: spawns.append((m, e)),
                      policy=pol_cls(**policy))
        assert sup.poll_once() == [0] and spawns == [(0, 1)]
        alive[name] = sorted(m.member_id for m in router.alive_members())
        ch.reset_resilience()
    assert alive == {"port": [1], "ref": [0, 1]}

    fl = Fleet(tmp_path, name="rig")
    try:
        tenant = owned_by(fl.door.registry.ring(), 0)
        LocalMemberHandle(0, fl.daemons[0]).kill()
        h = register(1903, n_ops=N_OPS)
        assert fl.client(tenant).check(h)["fleet_member"] == 1
        assert fl.door._counters["member_deaths"] == 1
        sup = FleetSupervisor(fl.fdir, range(2),
                              spawn_fn=lambda m, e: None,
                              policy=SupervisionPolicy(**policy))
        assert sup.poll_once() == [0]
        # the respawn pending: no second death off the dead row
        assert fl.client(tenant).check(h)["fleet_member"] == 1
        assert fl.door._counters["member_deaths"] == 1
        assert not chaos.is_quarantined(member_label(0))
        fl.spawn(0, epoch=1)
        assert fl.client(tenant).check(h)["fleet_member"] == 0
    finally:
        fl.close()


# -- the in-process mini drill ---------------------------------------------


def _bodies(seed, n=3, n_ops=30):
    """Prebuilt /check payloads with content identity (the drill's
    traffic pool, in miniature)."""
    rows = []
    for k in range(n):
        ops = encode_history(register(seed * 101 + k, n_ops=n_ops))
        body = json.dumps({"history": ops,
                           "model": "cas-register"}).encode()
        rows.append({"body": body, "ops": ops, "model": "cas-register",
                     "check_id": check_id_for("cas-register", body)})
    return rows


def test_mini_drill_invariants_hold_with_respawn(tmp_path):
    """The drill gate in process: kill one member and tear the other's
    row under live traffic; the supervisor respawns the dead member at
    epoch 1, the sweep answers every accepted check, and the invariant
    report (the gate `cli fleet-drill` exits 8 on) comes back clean."""
    fl = Fleet(tmp_path)
    sup = nem = None
    monitor = InvariantMonitor(target_members=2)
    try:
        victim, torn = 1, 0

        def spawn_fn(mid, epoch):
            fl.spawn(mid, epoch=epoch)

        sup = FleetSupervisor(
            fl.fdir, range(2), spawn_fn=spawn_fn,
            policy=SupervisionPolicy(
                restart_budget=3, backoff_base_s=0.1, backoff_max_s=0.5,
                spawn_grace_s=15.0, poll_interval_s=0.1, confirm_s=0.2,
            ),
        )
        sup.start()
        monitor.watch(door=fl.door, supervisor=sup, interval_s=0.1)
        plan = FleetChaosPlan(faults=[
            FleetFault("kill", victim, at_s=0.5),
            FleetFault("torn_write", torn, at_s=0.9),
        ], seed=5)
        nem = FleetNemesis(
            plan, {i: LocalMemberHandle(i, fl.daemons[i])
                   for i in range(2)},
            fleet_dir=fl.fdir, store_root=fl.root, monitor=monitor,
        )
        ring = fl.door.registry.ring()
        tenants = [owned_by(ring, 0, prefix="drill0"),
                   owned_by(ring, 1, prefix="drill1")]
        pools = {t: _bodies(1000 + i) for i, t in enumerate(tenants)}
        clients = {t: fl.client(t, retries=3, backoff_s=0.05,
                                timeout_s=30) for t in tenants}
        nem.start()
        deadline = time.monotonic() + 6.0
        k = 0
        while time.monotonic() < deadline and not (nem.done()
                                                   and k >= 12):
            tenant = tenants[k % 2]
            row = pools[tenant][(k // 2) % 3]
            k += 1
            monitor.note_submitted(tenant, row["check_id"], row["model"],
                                   row["ops"], None)
            try:
                out = clients[tenant]._roundtrip("POST", "/check",
                                                 row["body"])
                monitor.note_verdict(tenant, row["check_id"], out)
            except (ServiceError, OSError) as e:
                monitor.note_client_error(tenant, row["check_id"], e)
            time.sleep(0.05)
        nem.stop()
        end = time.monotonic() + 20.0
        while time.monotonic() < end:
            if len(fl.door.registry.alive_members()) >= 2:
                break
            time.sleep(0.2)
        for req in monitor.pending_requests():
            tenant, cid = req["tenant"], req["check_id"]
            row = next(r for r in pools[tenant] if r["check_id"] == cid)
            out = fl.client(tenant, retries=5, backoff_s=0.2,
                            timeout_s=60)._roundtrip("POST", "/check",
                                                     row["body"])
            monitor.note_verdict(tenant, cid, out)
        fl.door.recover_intents()
        orphans = len([n for n in os.listdir(fl.door.intent_dir)
                       if n.endswith(".json")])
        monitor.stop()
        sup.stop()

        def oracle(model, ops, init_value):
            hist = History([op_from_json(d) for d in ops], indexed=True)
            return bool(LinearizableChecker(
                model=model, init_value=init_value, device="cpu",
            ).check({}, hist).get("valid?"))

        monitor.run_parity(oracle)
        report = monitor.report(orphan_intents=orphans)
        assert report["clean"], report["violations"]
        assert report["checks"]["submissions"] >= 12
        assert report["checks"]["lost"] == 0
        assert report["parity"]["compared"] == report["checks"]["unique"]
        assert report["parity"]["mismatches"] == []
        snap = sup.snapshot()
        assert 1 <= snap["respawns"][victim] <= 3
        assert snap["epochs"][victim] >= 1 and not snap["exhausted"]
        assert {f["kind"] for f in nem.fired} == {"kill", "torn_write"}
        assert chaos.quarantined_devices() == ()
    finally:
        if nem is not None:
            nem.stop()
        monitor.stop()
        if sup is not None:
            sup.stop()
        fl.close()
