"""The port's checker fleet (jepsen_tpu_torch.service: membership.py,
frontdoor.py and the daemon's fleet identity) against the JAX package's
(jepsen_tpu.service), on the CPU.

The ring and the member files are compared directly: the same tenants
route to the same member ids, and either package's registry reads the
other's member files. Fleets run in this process as
tests/test_fleet.py's ``_Fleet`` runs them: N daemons on ephemeral
ports sharing one default plane (member 0 owns it, ``own_plane=False``
for the others) and one store root, behind a front door on a thread.
The port's daemons run with device="cpu", the reference's with
interpret=True; the SAME request bytes go through either door, and the
verdicts are compared as tests/test_fleet.py's ``_fstrip`` does
(``method``, ``wall_s`` and ``fleet_member`` aside, with the transport
fields of tests/test_service.py's ``_strip``). Tolerance: exact
equality. The port-only cases follow tests/test_fleet.py's, case for
case; none races a heartbeat against a sleep (an aged heartbeat is a
skewed one, or a TTL of seconds)."""

import http.client
import json
import os
import random
import threading

import pytest
from test_torch_checkpoint import Die, burst_ops, die_after
from test_torch_service import (
    body_of,
    get,
    post,
    ref_history,
    register,
    strip,
)

from jepsen_tpu.checker import chaos as r_chaos
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.checker.linearizable import (
    LinearizableChecker as RLinearizableChecker,
)
from jepsen_tpu.service import membership as r_mem
from jepsen_tpu.service.frontdoor import FleetFrontDoor as RDoor
from jepsen_tpu.service.server import CheckerDaemon as RDaemon

from jepsen_tpu_torch import device as t_dev
from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker import chaos
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.checker.checkpoint import (
    CheckpointSink,
    checkpoint_stats,
    reset_checkpoint_stats,
)
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.service import membership as t_mem
from jepsen_tpu_torch.service.client import CheckerClient, ServiceError
from jepsen_tpu_torch.service.frontdoor import FleetFrontDoor
from jepsen_tpu_torch.service.nemesis import skew_heartbeat
from jepsen_tpu_torch.service.server import CheckerDaemon, check_id_for
from jepsen_tpu_torch.store import Store

pytestmark = [pytest.mark.service, pytest.mark.fleet]

#: 40-op register histories: one W bucket, so the reference's
#: interpret-mode compile is paid once for the file
N_OPS = 40


@pytest.fixture(autouse=True)
def _clean():
    """Deaths quarantine members in each package's resilience ledger;
    never leak one into the next test."""
    yield
    chaos.reset_resilience()
    r_chaos.reset_resilience()
    t_dp.reset_default_plane()
    r_dp.reset_default_plane()


def fstrip(out):
    """strip() plus the door's fleet_member stamp."""
    return strip({k: v for k, v in out.items() if k != "fleet_member"})


class Fleet:
    """N in-process daemons of one package behind one front door (of the
    same package unless ``door`` names the other): test_fleet.py's
    ``_Fleet``, for either package."""

    def __init__(self, tmp_path, pkg="port", n=2, mode="proxy",
                 door=None, door_kw=None, name="fleet", **daemon_kw):
        self.pkg = pkg
        self.fdir = str(tmp_path / name / "fleet")
        self.root = str(tmp_path / name / "store")
        self.daemons, self.threads = [], []
        for i in range(n):
            self.spawn(i, own_plane=(i == 0), **daemon_kw)
        door_cls = {"port": FleetFrontDoor, "ref": RDoor}[door or pkg]
        self.door = door_cls(self.fdir, port=0, mode=mode,
                             **(door_kw or {}))
        self.door_thread = threading.Thread(
            target=self.door.serve_forever, daemon=True)
        self.door_thread.start()

    def spawn(self, member_id, epoch=0, own_plane=False, **kw):
        if self.pkg == "port":
            d = CheckerDaemon(root=self.root, port=0, device="cpu",
                              fleet_dir=self.fdir, member_id=member_id,
                              member_epoch=epoch, own_plane=own_plane,
                              **kw)
        else:
            d = RDaemon(root=self.root, port=0, interpret=True,
                        fleet_dir=self.fdir, member_id=member_id,
                        member_epoch=epoch, own_plane=own_plane, **kw)
        t = threading.Thread(target=d.serve_forever, daemon=True)
        t.start()
        self.daemons.append(d)
        self.threads.append(t)
        return d

    def client(self, tenant, **kw):
        kw.setdefault("retries", 0)
        kw.setdefault("timeout_s", 120)
        return CheckerClient(port=self.door.port, tenant=tenant, **kw)

    def close(self):
        self.door.shutdown()
        self.door_thread.join(timeout=10)
        self.door.close()
        for d, t in zip(self.daemons, self.threads):
            if d.chaos_gate is not None:
                d.chaos_gate.open()
            d.admission.start_drain()
            d.httpd.shutdown()
            t.join(timeout=10)
            d.close()


@pytest.fixture
def fleet2(tmp_path):
    fl = Fleet(tmp_path)
    try:
        yield fl
    finally:
        fl.close()


def owned_by(ring, member_id, prefix="tenant"):
    for i in range(10_000):
        t = f"{prefix}-{i}"
        if ring.route(t) == member_id:
            return t
    raise AssertionError(f"no tenant routes to member {member_id}")


def kill(fl, i):
    """Member i dies on the wire: its socket closes, its member file
    stays (what a SIGKILL looks like from outside)."""
    fl.daemons[i]._registry.stop_heartbeat()
    fl.daemons[i].httpd.shutdown()
    fl.threads[i].join(timeout=10)
    fl.daemons[i].httpd.server_close()


# -- the hash ring ---------------------------------------------------------

TENANTS = [f"tenant-{i}" for i in range(10_000)]


@pytest.mark.parametrize("members", [(0, 1), (0, 1, 2), (0, 2)])
def test_ring_routes_as_the_reference(members):
    """10,000 tenants route to the same member id in both packages,
    with the same successor order; the spreads are equal."""
    ring, ref = t_mem.HashRing(members), r_mem.HashRing(members)
    assert ring.member_ids == ref.member_ids == tuple(members)
    assert [ring.route(t) for t in TENANTS] == [ref.route(t)
                                                for t in TENANTS]
    assert all(ring.successors(t) == ref.successors(t)
               for t in TENANTS[:1000])
    assert t_mem.tenant_spread(ring, TENANTS) == r_mem.tenant_spread(
        ref, TENANTS)
    assert t_mem.HashRing([]).route("x") is r_mem.HashRing([]).route("x")


@pytest.mark.parametrize("leaving", [0, 1, 2])
def test_a_leaving_member_moves_the_same_tenants(leaving):
    """Drop one member of {0,1,2}: the same tenants move in both
    packages, and only those the leaving member owned."""
    rest = tuple(m for m in (0, 1, 2) if m != leaving)
    moved = {}
    for name, mod in (("port", t_mem), ("ref", r_mem)):
        before, after = mod.HashRing((0, 1, 2)), mod.HashRing(rest)
        moved[name] = [t for t in TENANTS
                       if before.route(t) != after.route(t)]
        assert all(before.route(t) == leaving for t in moved[name])
    assert moved["port"] == moved["ref"] and moved["port"]


# -- member files ----------------------------------------------------------


def test_member_files_read_across_packages(tmp_path):
    """Either package's registry reads the other's member files (schema
    1, member-NNN.json) and skips torn and foreign files alike; both
    route a tenant to the same member."""
    fdir = str(tmp_path / "fleet")
    t_mem.FleetRegistry(fdir, member_id=0, url="http://127.0.0.1:7000",
                        epoch=2).announce()
    r_mem.FleetRegistry(fdir, member_id=1, url="http://127.0.0.1:7001"
                        ).announce()
    with open(os.path.join(fdir, "member-099.json"), "w") as f:
        f.write('{"member_id": 99, "url"')  # torn mid-write
    with open(os.path.join(fdir, "member-098.json"), "w") as f:
        json.dump({"schema": 999, "member_id": 98}, f)  # foreign schema
    port, ref = t_mem.FleetRegistry(fdir), r_mem.FleetRegistry(fdir)
    rows = {name: sorted((m.member_id, m.url, m.epoch, m.draining)
                         for m in reg.all_members())
            for name, reg in (("port", port), ("ref", ref))}
    assert rows["port"] == rows["ref"] == [
        (0, "http://127.0.0.1:7000", 2, False),
        (1, "http://127.0.0.1:7001", 0, False)]
    assert port.ring().member_ids == ref.ring().member_ids == (0, 1)
    for t in TENANTS[:200]:
        assert port.route(t).member_id == ref.route(t).member_id
    # a skewed heartbeat (the nemesis's clock_skew) ages a member out of
    # both packages' routing, without racing a sleep against the TTL
    assert skew_heartbeat(fdir, 1, -60.0) is not None
    assert [m.member_id for m in port.alive_members()] == [0]
    assert [m.member_id for m in ref.alive_members()] == [0]


def test_member_death_is_a_host_quarantine_not_the_cards(tmp_path):
    """note_member_death quarantines host:<i>: quarantined_hosts names
    it and quarantined_devices stays empty, in the port as in the
    reference; the ring drops the member at once."""
    out = {}
    for name, mod, ch in (("port", t_mem, chaos), ("ref", r_mem, r_chaos)):
        fdir = str(tmp_path / name)
        for i in (0, 1):
            mod.FleetRegistry(fdir, member_id=i,
                              url=f"http://127.0.0.1:{7000 + i}").announce()
        router = mod.FleetRegistry(fdir)
        assert router.note_member_death(1) == ()
        res = ch.resilience_snapshot()
        snap = router.snapshot()
        out[name] = (ch.quarantined_hosts(), ch.quarantined_devices(),
                     res["quarantined_hosts"], res["quarantined_devices"],
                     snap["quarantined_members"], snap["ring_members"])
    assert out["port"] == out["ref"] == (("1",), (), ["1"], [], [1], [0])


# -- fleets ------------------------------------------------------------------


def test_fleet_verdicts_equal_the_reference_fleet(tmp_path):
    """A 2-member port fleet and a 2-member reference fleet get the same
    bodies through a proxy door: equal verdicts, the same owner per
    tenant, equal /stats rollups; the port launches no more."""
    hists = [register(401 + k, n_ops=N_OPS) for k in range(3)]
    hists.append(sim.corrupt_history(register(404, n_ops=N_OPS),
                                     random.Random(55)))
    bodies = [body_of(h, model="cas-register") for h in hists]
    ring = t_mem.HashRing((0, 1))
    tenants = [owned_by(ring, k % 2, prefix="fleet") for k in range(4)]
    got = {}
    for pkg in ("port", "ref"):
        # each member's /stats reports its process's launch counters:
        # from 0 here, so the rollups count this test's launches only
        t_dev.reset_launch_stats()
        r_bs.reset_launch_stats()
        fl = Fleet(tmp_path, pkg=pkg, name=pkg)
        try:
            outs = [post(fl.door, "/check", b, tenant=t)
                    for t, b in zip(tenants, bodies)]
            got[pkg] = (outs, fl.door.fleet_stats())
        finally:
            fl.close()
            (t_dp if pkg == "port" else r_dp).reset_default_plane()
    (pouts, pst), (routs, rst) = got["port"], got["ref"]
    for (sp, op), (sr, orf) in zip(pouts, routs):
        assert sp == sr == 200
        assert op["fleet_member"] == orf["fleet_member"]
        assert fstrip(op) == fstrip(orf)
    assert [o["fleet_member"] for _, o in pouts] == [0, 1, 0, 1]
    assert [o["valid?"] for _, o in pouts] == [True, True, True, False]
    for k in ("completed", "valid", "invalid"):
        assert pst["rollup"][k] == rst["rollup"][k]
    assert pst["rollup"]["completed"] == 4
    assert pst["rollup"]["invalid"] == 1
    assert pst["rollup"]["launches"] <= rst["rollup"]["launches"]
    assert pst["door"] == rst["door"]
    assert pst["membership"]["ring_members"] == [0, 1]


def test_reference_door_routes_to_port_daemons(tmp_path):
    """A mixed fleet: the reference's front door reads the port
    daemons' member files and routes each tenant to its ring owner;
    the verdicts equal the port's local checks."""
    fl = Fleet(tmp_path, door="ref")
    try:
        ring = fl.door.registry.ring()
        assert ring.member_ids == (0, 1)
        for mid, seed in ((0, 501), (1, 502)):
            h = register(seed, n_ops=N_OPS)
            tenant = owned_by(ring, mid, prefix="mixed")
            s, out = post(fl.door, "/check", body_of(h), tenant=tenant)
            assert s == 200 and out["fleet_member"] == mid
            assert out["tenant"] == tenant
            local = LinearizableChecker(device="cpu").check({}, h)
            assert fstrip(out) == strip(local)
        st = fl.door.fleet_stats()
        assert st["rollup"]["completed"] == 2
        assert {m: st["members"][m]["completed"] for m in ("0", "1")} == {
            "0": 1, "1": 1}
    finally:
        fl.close()


def test_shed_owner_is_stolen_then_every_member_sheds(fleet2):
    """The owner's admission door answers 429 (its per-tenant slot is
    held): the door steals the same bytes to the ring successor. With
    every member shedding, the client gets the last 429 with
    Retry-After and fleet_exhausted."""
    ring = fleet2.door.registry.ring()
    tenant = owned_by(ring, 0)
    held = [fleet2.daemons[0].admission.admit(tenant)
            for _ in range(fleet2.daemons[0].admission.per_tenant_inflight)]
    try:
        out = fleet2.client(tenant).check(register(402, n_ops=N_OPS))
        assert out["fleet_member"] == 1 and out["valid?"] is True
        st = fleet2.door.fleet_stats()
        assert st["door"]["steals"] == 1 and st["door"]["exhausted"] == 0
        d1 = fleet2.daemons[1].admission
        held += [d1.admit(tenant) for _ in range(d1.per_tenant_inflight)]
        body = body_of(register(403, n_ops=N_OPS))
        conn = http.client.HTTPConnection("127.0.0.1", fleet2.door.port,
                                          timeout=60)
        try:
            conn.request("POST", "/check", body=body, headers={
                "X-Tenant": tenant, "Content-Length": str(len(body))})
            resp = conn.getresponse()
            obj = json.loads(resp.read())
        finally:
            conn.close()
        assert resp.status == 429
        assert resp.getheader("Retry-After") == "1"
        assert obj["fleet_exhausted"] is True
        assert obj["error"] == "tenant-inflight-cap"
        assert fleet2.door.fleet_stats()["door"]["exhausted"] == 1
    finally:
        for tok in held:
            tok.release()


def test_draining_owner_is_stolen_and_all_draining_is_503(fleet2):
    """503 (admission draining) is the other arm of SHED."""
    ring = fleet2.door.registry.ring()
    tenant = owned_by(ring, 0)
    fleet2.daemons[0].admission.start_drain()
    out = fleet2.client(tenant).check(register(405, n_ops=N_OPS))
    assert out["fleet_member"] == 1
    fleet2.daemons[1].admission.start_drain()
    with pytest.raises(ServiceError) as ei:
        fleet2.client(tenant).check(register(406, n_ops=N_OPS))
    assert ei.value.status == 503
    assert ei.value.body.get("fleet_exhausted") is True


def test_redirect_mode_client_follows_to_owner(tmp_path):
    fl = Fleet(tmp_path, mode="redirect")
    try:
        h = register(404, n_ops=N_OPS)
        local = LinearizableChecker(device="cpu").check({}, h)
        tenant = owned_by(fl.door.registry.ring(), 1)
        out = fl.client(tenant).check(h)
        # the client followed the 307 to the owner, which does not stamp
        # fleet_member
        assert strip(out) == strip(local) and "fleet_member" not in out
        st = fl.door.fleet_stats()
        assert st["door"]["redirects"] == 1 and st["door"]["proxied"] == 0
        assert st["members"]["1"]["completed"] == 1
        assert st["members"]["0"]["completed"] == 0
    finally:
        fl.close()


def test_intent_journal_is_idempotent_and_recoverable(fleet2):
    """An intent journaled by a door that died before a member answered
    replays through recover_intents and retires once answered; the
    same bytes journal to one file."""
    door = fleet2.door
    body = body_of(register(407, n_ops=N_OPS), model="cas-register")
    p1 = door.journal_intent("alice", "/check", body)
    assert door.journal_intent("alice", "/check", body) == p1
    assert os.listdir(door.intent_dir) == [os.path.basename(p1)]
    replayed = door.recover_intents()
    assert [(s, o["valid?"]) for s, o in replayed] == [(200, True)]
    assert not os.path.exists(p1)
    assert door.fleet_stats()["door"]["intents_recovered"] == 1
    # a torn journal file is not an intent: skipped, never fatal
    with open(os.path.join(door.intent_dir, "torn.json"), "w") as f:
        f.write('{"tenant": ')
    assert door.recover_intents() == []


def test_tenant_plane_fault_stays_journaled_until_the_fault_clears(
        tmp_path):
    """A member whose plane does not degrade (the card's default)
    answers a tenant-targeted device fault with 500. The door retires an
    intent only on a status under 500 that is no shed, so the check
    stays in the intent journal. Once the fault clears,
    recover_intents() re-runs it: the reference's verdict, status 200,
    and the intent retired. This is the zero-loss rule at work (ROADMAP
    queue 3 records it as a departure: the reference's plane degrades
    and answers 200 at once)."""
    h = register(413, n_ops=N_OPS)
    body = body_of(h, model="cas-register")
    want = strip(RLinearizableChecker(interpret=True).check(
        {}, ref_history(h)))
    fl = Fleet(tmp_path, n=1, degrade=False, coalesce_hold_s=0.0)
    try:
        assert fl.daemons[0].plane.degrade is False
        with chaos.chaos_plan(chaos.persistent_device_fault(
                chaos.TENANT_PREFIX + "x")):
            status, out = post(fl.door, "/check", body, tenant="x")
        assert status == 500 and out["error"] == "check-failed"
        journaled = os.listdir(fl.door.intent_dir)
        assert len(journaled) == 1
        replayed = fl.door.recover_intents()
        assert [s for s, _ in replayed] == [200]
        assert fstrip(replayed[0][1]) == want
        assert os.listdir(fl.door.intent_dir) == []
        assert fl.door.fleet_stats()["door"]["intents_recovered"] == 1
        # a second pass finds nothing left to re-post
        assert fl.door.recover_intents() == []
    finally:
        fl.close()


@pytest.fixture
def small_w(monkeypatch):
    """test_torch_checkpoint's seam: narrow W buckets and 1-step
    segments make a multi-segment durable check out of a small one."""
    monkeypatch.setattr(t_bs, "W_BUCKETS", (4, 5) + t_bs.W_BUCKETS)
    monkeypatch.setenv("JEPSEN_TPU_SEG_MIN_LEN", "1")


def test_dead_member_hands_off_and_the_successor_resumes(tmp_path,
                                                         small_w):
    """The owner dies mid-check, after 2 durable boundaries of a check
    it owned: the door finds it dead on the wire, quarantines it, and
    replays the same bytes to the successor, which resumes from the
    owner's checkpoint (same check id, same file under the shared
    store): handoffs 1, resumed_from_owner member-0, the cold verdict,
    fewer launches than a cold durable run."""
    fl = Fleet(tmp_path)
    try:
        tenant = owned_by(fl.door.registry.ring(), 0)
        h = History(burst_ops(t_ops, rounds=2, nburst=5))
        body = json.dumps({"history": json.loads(body_of(h))["history"],
                           "model": "cas-register",
                           "durable": True}).encode()
        path = Store(fl.root).service_checkpoint_path(
            tenant, check_id_for("cas-register", body))
        t_dev.reset_launch_stats()
        cold = LinearizableChecker(device="cpu").check(
            {}, h, checkpoint=CheckpointSink(str(tmp_path / "cold"),
                                             seg_min_len=1))
        cold_launches = t_dev.launch_stats_snapshot()["launches"]
        reset_checkpoint_stats()
        # member 0 ran the check and died at boundary 2
        with pytest.raises(Die):
            LinearizableChecker(device="cpu").check(
                {}, h, checkpoint=CheckpointSink(
                    path, seg_min_len=1, owner="member-0",
                    after_save=die_after(2)))
        kill(fl, 0)
        t_dev.reset_launch_stats()
        s, out = post(fl.door, "/check", body, tenant=tenant)
        assert s == 200 and out["fleet_member"] == 1
        assert fstrip(out) == strip(cold)
        ck = out["checkpoint"]
        assert ck["resumed_from_segment"] == 2
        assert ck["resumed_from_owner"] == "member-0"
        assert ck["owner"] == "member-1"
        assert checkpoint_stats()["handoffs"] == 1
        assert t_dev.launch_stats_snapshot()["launches"] < cold_launches
        st = fl.door.fleet_stats()
        assert st["door"]["member_deaths"] == 1
        assert st["door"]["handoffs"] == 1
        assert chaos.quarantined_hosts() == ("0",)
        assert chaos.quarantined_devices() == ()
        assert fl.door.registry.ring().member_ids == (1,)
        assert os.listdir(fl.door.intent_dir) == []
    finally:
        fl.close()


def test_same_owner_resume_is_not_a_handoff(tmp_path, small_w):
    """A member resuming its own crash is a resume, never a hand-off:
    the counter moves only when ownership changes."""
    h = History(burst_ops(t_ops, rounds=2, nburst=5))
    reset_checkpoint_stats()
    with pytest.raises(Die):
        LinearizableChecker(device="cpu").check(
            {}, h, checkpoint=CheckpointSink(
                str(tmp_path), seg_min_len=1, owner="member-0",
                after_save=die_after(2)))
    sink = CheckpointSink(str(tmp_path), seg_min_len=1, owner="member-0")
    LinearizableChecker(device="cpu").check({}, h, checkpoint=sink)
    assert sink.resumed_from == 2
    assert sink.resumed_from_owner is None
    assert checkpoint_stats()["handoffs"] == 0


def test_door_listen_backlog_admits_a_burst(tmp_path):
    """A repair, as the daemon's (tests/test_torch_service.py): the
    reference's door listens with the stdlib's backlog of 5, so past
    about 5 simultaneous connects a client's SYN waits a retransmit
    (seen on the H100: 3 of fleet_door's 10 requests a second late).
    The port's door listens with the system's most: 12 connects
    complete while it accepts none."""
    from test_torch_service import _connects_within

    fdir = str(tmp_path / "fleet")
    doors = (FleetFrontDoor(fdir, port=0), RDoor(fdir, port=0))
    try:
        assert _connects_within(doors[0].port, 12) == 12
        assert _connects_within(doors[1].port, 12) < 12
    finally:
        for d in doors:
            d.close()


def test_member_stats_carry_the_fleet_identity(fleet2):
    """/stats of a member names it (the door's rollup keys on it); the
    owner tag reaches the plane of the member that owns it."""
    st = fleet2.daemons[1].stats()
    assert st["member"]["member_id"] == 1
    assert st["member"]["url"] == fleet2.daemons[1].url
    assert st["member"]["epoch"] == 0
    assert fleet2.daemons[0].plane.owner == "member-0"
    assert fleet2.daemons[1].plane is fleet2.daemons[0].plane
    assert fleet2.daemons[1]._owner == "member-1"
    status, _, raw = get(fleet2.door, "/healthz")
    hz = json.loads(raw)
    assert status == 200 and hz["ok"] is True and hz["members_alive"] == 2
    assert hz["role"] == "frontdoor"
