"""Tenant attribution, tenant-targeted faults and durable resumption of
the port's checker daemon against the JAX package's, on the CPU.

- dispatch's tenant scope: tenant_context / current_tenant and the
  riders' ``tenant:<name>`` guard labels behave as the reference's,
  and the plane's trace instants carry the tenant.
- a ChaosFault aimed at one tenant's pseudo-label: on the CPU plane
  (which degrades) that tenant's check answers from the host oracle as
  the reference's does, the other tenant's verdict is unchanged, and
  no device is quarantined. On a plane that does not degrade (the
  card's default) the tenant gets its 500 instead: the port's
  departure, pinned here. Either way only that tenant's breaker trips.
- a durable check killed at boundary 2 by the REFERENCE's checkpoint
  sink, at the store's service checkpoint path, resumes in the port's
  daemon at segment 2 with the cold verdict, then replays launch-free.

Daemons are torn down as tests/test_torch_service.py's are. Tolerance:
exact equality."""

import json
import random

import pytest
from test_torch_checkpoint import Die, burst_ops, die_after
from test_torch_service import (
    port_daemon,
    post,
    ref_daemon,
    ref_history,
    register,
    rows,
    strip,
)

from jepsen_tpu.checker import chaos as r_chaos
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.checker.checkpoint import CheckpointSink as RSink
from jepsen_tpu.checker.linearizable import (
    LinearizableChecker as RLinearizableChecker,
)

from jepsen_tpu_torch import device as t_dev
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checker import chaos as t_chaos
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.checker.checkpoint import CheckpointSink
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.service.client import encode_history
from jepsen_tpu_torch.service.server import check_id_for
from jepsen_tpu_torch.store import Store

pytestmark = pytest.mark.service


# -- the plane's tenant scope ---------------------------------------------


def test_tenant_context_nests_and_clears_as_the_reference():
    for dp in (t_dp, r_dp):
        assert dp.current_tenant() is None
        with dp.tenant_context("a"):
            assert dp.current_tenant() == "a"
            with dp.tenant_context("b"):
                assert dp.current_tenant() == "b"
            with dp.tenant_context(None):
                assert dp.current_tenant() is None
            assert dp.current_tenant() == "a"
        assert dp.current_tenant() is None


def test_tenant_tags_equal_the_reference():
    class F:
        def __init__(self, t):
            self.tenant = t

    futs = [F("x"), F(None), F("y"), F("x"), F('q"uote')]
    assert t_dp._tenant_tags(futs) == r_dp._tenant_tags(futs) == [
        "tenant:x", "tenant:y", 'tenant:q"uote']
    assert t_chaos.TENANT_PREFIX == r_chaos.TENANT_PREFIX
    for lbl in ("tenant:x", "cuda:0", "cpu", None, 3):
        assert t_chaos.is_tenant_label(lbl) == r_chaos.is_tenant_label(lbl)


def test_futures_and_instants_carry_the_tenant():
    """A future submitted inside tenant_context is stamped; the submit
    and dispatch_solo instants carry the tenant, outside they carry
    None."""
    h = register(401)
    obs.enable()
    try:
        obs.reset()
        with t_dp.DispatchPlane(device="cpu") as plane:
            from jepsen_tpu_torch.checker.linearizable import (
                LinearizableChecker,
            )

            ck = LinearizableChecker(plane=plane)
            with t_dp.tenant_context("alice"):
                r = ck.check_async({}, h)
            fut_out = r()
            assert fut_out["valid?"] is True
            ck.check({}, h)
        subs = [e for e in obs.spans() if e["name"] == "submit"]
    finally:
        obs.disable()
        obs.reset()
    assert [e["args"]["tenant"] for e in subs] == ["alice", None]


def test_tenant_fault_never_charges_the_device():
    """_on_fault of a tenant label trips that tenant's breaker: it
    shows in quarantined_tenants, never in quarantined_devices."""
    t_chaos.reset_resilience()
    try:
        exc = RuntimeError("boom")
        for _ in range(3):
            t_dp.DispatchPlane._on_fault("fatal", "tenant:evil", exc)
        assert t_chaos.quarantined_tenants() == ("evil",)
        assert t_chaos.quarantined_devices() == ()
        res = t_chaos.resilience_snapshot()
        assert res["quarantined_devices"] == []
        assert res["quarantined_tenants"] == ["evil"]
    finally:
        t_chaos.reset_resilience()


# -- a fault aimed at one tenant -----------------------------------------


def test_tenant_targeted_fault_degrades_only_that_tenant(tmp_path):
    """The CPU plane degrades: the evil tenant's check answers from the
    host oracle in both packages (same validity and failing index), the
    clean tenant's verdict equals its solo run's, the fault lands in
    the evil row only, and no device is quarantined."""
    h_evil = register(501, n_ops=60)
    h_clean = register(502)
    solo = strip(
        RLinearizableChecker(interpret=True).check({}, ref_history(h_clean))
    )
    got = {}
    for name, mk, chaos in (("port", port_daemon, t_chaos),
                            ("ref", ref_daemon, r_chaos)):
        with mk(tmp_path, coalesce_hold_s=0.0,
                tenant_quarantine_after=100) as d:
            d.plane.retry = chaos.RetryPolicy(max_retries=1,
                                              base_delay_s=0.001)
            body_e = json.dumps({"history": encode_history(h_evil)}).encode()
            body_c = json.dumps({"history": encode_history(h_clean)}).encode()
            with chaos.chaos_plan(chaos.persistent_device_fault(
                    chaos.TENANT_PREFIX + "evil")):
                se, out_e = post(d, "/check", body_e, tenant="evil")
                sc, out_c = post(d, "/check", body_c, tenant="clean")
            assert se == sc == 200
            snap = rows(d)
            got[name] = (out_e, out_c, snap)
            assert chaos.resilience_snapshot()["quarantined_devices"] == []
    (pe, pc, ps), (re_, rc, rs) = got["port"], got["ref"]
    for k in ("valid?", "failed_op_index"):
        assert pe.get(k) == re_.get(k)
    assert pe["method"].startswith("cpu-oracle")
    assert re_["method"].startswith("cpu-oracle")
    assert pe["degraded"]
    assert strip(pc) == strip(rc) == solo
    assert not pc["method"].startswith("cpu-oracle")
    assert ps["clean"] == rs["clean"]
    assert ps["clean"]["oracle_fallbacks"] == ps["clean"]["faults"] == 0
    assert ps["evil"]["oracle_fallbacks"] == 1
    assert rs["evil"]["oracle_fallbacks"] >= 1


def test_tenant_fault_on_a_plane_that_does_not_degrade(tmp_path):
    """The card's default (degrade=False): the evil tenant's check
    fails with the PlaneFault, which the daemon maps to 500; the clean
    tenant is unperturbed; the evil tenant's breaker trips after a few
    faults and its next request sheds at the door (429), while the
    device is never quarantined."""
    h_evil = register(511, n_ops=60)
    h_clean = register(512)
    solo = strip(
        RLinearizableChecker(interpret=True).check({}, ref_history(h_clean))
    )
    body_e = json.dumps({"history": encode_history(h_evil)}).encode()
    body_c = json.dumps({"history": encode_history(h_clean)}).encode()
    with port_daemon(tmp_path, degrade=False, coalesce_hold_s=0.0) as d:
        assert d.plane.degrade is False
        with t_chaos.chaos_plan(t_chaos.persistent_device_fault(
                t_chaos.TENANT_PREFIX + "evil")):
            se, out_e = post(d, "/check", body_e, tenant="evil")
            sc, out_c = post(d, "/check", body_c, tenant="clean")
            codes = [se]
            for _ in range(6):
                s, out = post(d, "/check", body_e, tenant="evil")
                codes.append(s)
                if s == 429:
                    break
        assert se == 500 and out_e["error"] == "check-failed"
        assert sc == 200 and strip(out_c) == solo
        assert codes[-1] == 429 and set(codes[:-1]) == {500}
        assert out["error"] == "tenant-quarantined"
        snap = rows(d)
        assert snap["evil"]["errors"] == len(codes) - 1
        assert snap["evil"]["plane_faults"] == len(codes) - 1
        assert snap["evil"]["shed_quarantined"] == 1
        assert snap["clean"]["errors"] == snap["clean"]["faults"] == 0
        assert t_chaos.quarantined_tenants() == ("evil",)
        assert t_chaos.quarantined_devices() == ()
        assert "cpu" not in t_chaos.device_failures()


# -- durable checks across packages -------------------------------------


@pytest.fixture
def small_w(monkeypatch):
    monkeypatch.setattr(r_bs, "W_BUCKETS", (4, 5) + r_bs.W_BUCKETS)
    monkeypatch.setattr(t_bs, "W_BUCKETS", (4, 5) + t_bs.W_BUCKETS)
    monkeypatch.setenv("JEPSEN_TPU_SEG_MIN_LEN", "1")


def test_reference_checkpoint_resumes_in_the_port_daemon(tmp_path, small_w):
    """The reference's sink dies after boundary 2 at the service
    checkpoint path of the request's check id; the port's daemon over
    the same store resumes there with the cold verdict, then answers a
    resubmission from the finished checkpoint with zero launches."""
    h = History(burst_ops(t_ops, rounds=2, nburst=5))
    body = json.dumps({"history": encode_history(h),
                       "model": "cas-register", "durable": True}).encode()
    check_id = check_id_for("cas-register", body)
    root = str(tmp_path / "store")
    path = Store(root).service_checkpoint_path("default", check_id)
    cold = RLinearizableChecker(interpret=True).check({}, ref_history(h))
    with pytest.raises(Die):
        RLinearizableChecker(interpret=True).check(
            {}, ref_history(h),
            checkpoint=RSink(path, seg_min_len=1, after_save=die_after(2)),
        )
    with port_daemon(tmp_path, root=root) as d:
        s, out = post(d, "/check", body)
        assert s == 200 and out["check_id"] == check_id
        assert out["checkpoint"]["resumed_from_segment"] == 2
        assert strip(out) == strip(cold)
        assert d.ledger.snapshot()["default"]["durable_resumes"] == 1
        t_dev.reset_launch_stats()
        s, out2 = post(d, "/check", body)
        assert s == 200 and out2["checkpoint"]["replayed_verdict"] is True
        assert t_dev.launch_stats_snapshot()["launches"] == 0
        assert out2["valid?"] == cold["valid?"]
        assert d.ledger.snapshot()["default"]["durable_replays"] == 1
    # a port-written checkpoint resumes in the reference's sink too
    ref_path = str(tmp_path / "to-ref")
    with pytest.raises(Die):
        from jepsen_tpu_torch.checker.linearizable import (
            LinearizableChecker,
        )

        LinearizableChecker(device="cpu").check(
            {}, History(burst_ops(t_ops, rounds=2, nburst=5)),
            checkpoint=CheckpointSink(ref_path, seg_min_len=1,
                                      after_save=die_after(2)),
        )
    k = RSink(ref_path, seg_min_len=1)
    out = RLinearizableChecker(interpret=True).check(
        {}, ref_history(h), checkpoint=k)
    assert k.resumed_from == 2 and out["valid?"] == cold["valid?"]
