"""The port's mesh (jepsen_tpu_torch.checker.sharded's Mesh of slots,
pod/slicing.py, the mesh arms of wgl_bitset, txn_graph and the dispatch
plane) against the JAX package's shard_map'd mesh, on the CPU.

The reference runs on tests/conftest.py's 8-device CPU mesh
(``default_mesh()`` or an explicit 8-device Mesh) with its Pallas
kernels in interpret mode; the port runs on ``virtual_mesh("cpu", 8)``
(eight virtual slots on the CPU, kernel A's plain version once per
slot) or on the ambient mesh the local-slot seam gives. The same seeded
histories go through both. Compared, with tolerance 0: per key
``valid?``, ``failed_op_index``, ``frontier_k`` and ``escalations``,
the method mapped tpu-* -> gpu-*, LAUNCH_STATS, MESH_STATS (minus the
topology block, whose slot labels differ) and the txn graph's counts.
DEVICE_STATS compare by slot position: the reference's labels are
JAX's device names, the port's its slot labels. These are the
counterparts of tests/test_mesh.py, plus the graph arms and the stream
tails' mesh arm.

Interpret shapes are few and shared: register streams of 40 ops at
W=12, S=8 in batches of 16 (2 keys a device) or 8 (1 key a device)."""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RMesh

from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import sharded as r_sh
from jepsen_tpu.checker import txn_graph as rtg
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.checker.models import model as r_model
from jepsen_tpu import sim as r_sim

from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import sharded as t_sh
from jepsen_tpu_torch.checker import txn_graph as ttg
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.checker.models import model as t_model
from jepsen_tpu_torch.checker.wgl_oracle import check_events as oracle_check
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats

pytestmark = pytest.mark.mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' launch, dispatch and mesh counters from zero, and
    the port's mesh policy as it was."""
    from jepsen_tpu_torch.checker import chaos

    saved = dict(t_sh._MESH_POLICY)
    for reset in (r_bs.reset_launch_stats, reset_launch_stats,
                  r_sh.reset_mesh_stats, t_sh.reset_mesh_stats,
                  r_dp.reset_dispatch_stats, t_dp.reset_dispatch_stats,
                  chaos.reset_resilience):
        reset()
    yield
    t_sh._MESH_POLICY.update(saved)
    chaos.reset_resilience()


def _mesh8() -> RMesh:
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return RMesh(np.asarray(devs[:8]), axis_names=("keys",))


def _streams(n, n_ops=40, corrupt_every=0, seed=4200, p_crash=0.02):
    """(reference streams, the port's copies) of n seeded histories."""
    out = []
    for i in range(n):
        rng = random.Random(seed + i)
        h = r_sim.gen_register_history(rng, n_ops=n_ops, n_procs=3,
                                       p_crash=p_crash)
        if corrupt_every and i % corrupt_every == corrupt_every - 1:
            h = r_sim.corrupt_history(h, rng)
        out.append(r_ev.history_to_events(h))
    return out, [from_reference(s) for s in out]


def _strip(r):
    return {k: v for k, v in r.items() if k not in ("method", "wall_s")}


def _method(m: str) -> str:
    return m.replace("tpu-", "gpu-")


#: an escalated key's solo rung: the reference's jax scan on the CPU
#: meets the port's kernel-B tier (tests/test_torch_keys.py)
CPU_TIER_DIFFERS = {("gpu-wgl", "gpu-wgl-kfrontier")}


def _same_rows(got, want):
    for i, (t, r) in enumerate(zip(got, want)):
        assert _strip(t) == _strip(r), (i, t, r)
        pair = (_method(r["method"]), t["method"])
        assert pair[0] == pair[1] or pair in CPU_TIER_DIFFERS, (i, t, r)
    assert len(got) == len(want)


def _mesh_stats(mod):
    snap = mod.mesh_stats_snapshot()
    snap.pop("topology")
    return snap


def _per_device(st):
    return [(b["launches"], b["requests"], b["occupancy"],
             b["floor_amortization"]) for b in st["per_device"].values()]


# -- mesh selection --------------------------------------------------------------


def test_default_mesh_resolution(monkeypatch):
    """resolve_mesh semantics: None auto-detects over the healthy slots
    of the device's type (8 with the local-slot seam, none without it:
    a one-device host keeps the single-device path), False forces one
    device, a Mesh passes through, a Mesh on another device type is
    refused."""
    monkeypatch.delenv(t_sh.ENV_LOCAL_DEVICES, raising=False)
    assert t_sh.default_mesh("cpu") is None
    assert t_sh.resolve_mesh(None, "cpu") is None
    monkeypatch.setenv(t_sh.ENV_LOCAL_DEVICES, "8")
    m = t_sh.default_mesh("cpu")
    assert m is not None and t_sh.mesh_size(m) == 8
    assert m == t_sh.virtual_mesh("cpu", 8) and hash(m) == hash(
        t_sh.virtual_mesh("cpu", 8))
    assert r_sh.mesh_size(r_sh.default_mesh()) == t_sh.mesh_size(m)
    assert t_sh.resolve_mesh(False, "cpu") is None
    explicit = t_sh.virtual_mesh("cpu", 8)
    assert t_sh.resolve_mesh(explicit, "cpu") is explicit
    assert t_sh.mesh_size(t_sh.resolve_mesh(None, "cpu")) == 8
    with pytest.raises(ValueError, match="not on the cuda device"):
        t_sh.resolve_mesh(explicit, "cuda")
    # the reference's attribute surface
    assert m.axis_names == ("keys",) and m.shape["keys"] == 8
    assert [str(d) for d in m.devices.flat] == [
        f"cpu[{k}]" for k in range(8)]


def test_multichip_r02_sharded_bitset_one_launch():
    """One coalesced bucket of 16 keys over 8 slots: ONE counted launch
    (kernel A once per slot), one host sync, verdicts the reference's
    and the oracle's, MESH_STATS the reference's."""
    mesh = _mesh8()
    ref, port = _streams(16, p_crash=0.0)
    want = r_sh.check_keys(ref, mesh=mesh, interpret=True)
    got = t_sh.check_keys(port, device="cpu",
                          mesh=t_sh.virtual_mesh("cpu", 8))
    _same_rows(got, want)
    for s, r in zip(port, got):
        assert r["method"] == "gpu-wgl-bitset-batch"
        assert r["valid?"] == oracle_check(s)
    assert launch_stats_snapshot() == r_bs.launch_stats_snapshot()
    assert launch_stats_snapshot()["launches"] == 1
    assert launch_stats_snapshot()["host_syncs"] == 1
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)
    assert t_sh.MESH_STATS["last_n_devices"] == 8


def test_check_keys_mesh_vs_single_differential_bitset():
    """Mesh and single-device bitset batches agree on EVERY verdict
    field, with an exact-tier escalation from the corrupted keys (2
    launches both ways, the escalation sharded too), and equal the
    reference's sharded run."""
    mesh = _mesh8()
    ref, port = _streams(16, corrupt_every=3, seed=4300)
    assert not all(oracle_check(s) for s in port)
    want = r_sh.check_keys(ref, mesh=mesh, interpret=True)
    sharded = t_sh.check_keys(port, device="cpu",
                              mesh=t_sh.virtual_mesh("cpu", 8))
    assert launch_stats_snapshot() == r_bs.launch_stats_snapshot()
    assert launch_stats_snapshot()["launches"] == 2
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)
    assert t_sh.MESH_STATS["sharded_launches"] == 2
    reset_launch_stats()
    single = t_sh.check_keys(port, device="cpu", mesh=False)
    assert launch_stats_snapshot()["launches"] == 2
    _same_rows(sharded, want)
    assert sharded == single
    for s, r in zip(port, sharded):
        assert r["valid?"] == oracle_check(s)


def _wide(n_procs=24, corrupt_key=1):
    """Contended CAS counters of window 24 (one of them corrupted):
    outside the bitset envelope, so both packages take their sharded
    scan under a mesh. Built with the port's generator and carried to
    the reference as op dicts."""
    from jepsen_tpu.history.history import History as RHistory

    ref = []
    for k, rounds in enumerate((1, 2, 2)):
        h = t_sim.gen_cas_counter_history(random.Random(320 + k),
                                          n_rounds=rounds, n_procs=n_procs)
        if k == corrupt_key:
            h = t_sim.corrupt_history(h, random.Random(330),
                                      n_values=n_procs + 1)
        ref.append(r_ev.history_to_events(RHistory(h.to_dicts())))
    return ref, [from_reference(s) for s in ref]


@pytest.mark.parametrize("ladder", [(128, 256), (16, 128)],
                         ids=["definite", "escalating"])
def test_check_keys_mesh_vs_single_differential_vmap(ladder):
    """The sharded torch-ops scan (gpu-wgl-sharded) against the
    reference's sharded vmap (tpu-wgl-sharded): at K=128 every verdict
    is definite, at K=16 every key overflows and escalates alone up the
    ladder; the single-device run (kernel B's tier here) gives the same
    verdicts."""
    mesh = _mesh8()
    ref, port = _wide()
    want = r_sh.check_keys(ref, mesh=mesh, k_ladder=ladder)
    got = t_sh.check_keys(port, device="cpu", k_ladder=ladder,
                          mesh=t_sh.virtual_mesh("cpu", 8))
    _same_rows(got, want)
    if ladder[0] == 128:
        assert {r["method"] for r in got} == {"gpu-wgl-sharded"}
    else:
        assert all(r["escalations"] == 1 for r in got)
    assert [r["valid?"] for r in got] == [True, False, True]
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)
    assert t_sh.MESH_STATS["sharded_launches"] == 1
    assert launch_stats_snapshot()["host_syncs"] >= 1
    single = t_sh.check_keys(port, device="cpu", mesh=False,
                             k_ladder=ladder)
    assert [_strip(r) for r in single] == [_strip(r) for r in got]


@pytest.mark.parametrize("n_keys", [16, 5])
def test_uneven_key_padding(n_keys):
    """16 keys fill 8 slots evenly, 5 keys pad 3 blank rows (trivially
    alive, sliced off before the verdicts return): the reference's
    verdicts and counts, each key the oracle's."""
    mesh = _mesh8()
    ref, port = _streams(n_keys, corrupt_every=2, seed=4500 + n_keys)
    want = r_sh.check_keys(ref, mesh=mesh, interpret=True)
    got = t_sh.check_keys(port, device="cpu",
                          mesh=t_sh.virtual_mesh("cpu", 8))
    assert len(got) == n_keys
    _same_rows(got, want)
    assert launch_stats_snapshot() == r_bs.launch_stats_snapshot()
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)
    for s, r in zip(port, got):
        assert r["valid?"] == oracle_check(s)


def test_collect_keys_bitset_mesh_arm_matches_the_reference():
    """launch_keys_bitset / collect_keys_bitset with a mesh, directly:
    the same verdict tuples, pad rows sliced off, one launch plus the
    sharded exact re-run."""
    mesh = _mesh8()
    ref, port = _streams(5, corrupt_every=2, seed=4505)
    m = r_model("cas-register")
    W, S = r_bs.plan(m, max(s.window for s in ref),
                     max(len(s.value_codes) for s in ref))
    want = r_bs.collect_keys_bitset(r_bs.launch_keys_bitset(
        [r_ev.events_to_steps(s, W=W) for s in ref], S=S, interpret=True,
        mesh=mesh))
    got = t_bs.collect_keys_bitset(t_bs.launch_keys_bitset(
        [t_ev.events_to_steps(s, W=W) for s in port], S=S, device="cpu",
        mesh=t_sh.virtual_mesh("cpu", 8)))
    assert got == [tuple(x) for x in want]
    assert launch_stats_snapshot() == r_bs.launch_stats_snapshot()
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)


def test_launch_tails_bitset_mesh_arm():
    """The stream tails' mesh arm: rows from fresh streams and from
    host frontiers of the launch's own width give the reference's
    verdicts and boundary frontiers; a narrower seed (a W12 row in a
    W13 launch) the port moves into the launch's mask space, where the
    reference's mesh arm inherits its queue 3 fault and raises."""
    mesh = _mesh8()
    ref, port = _streams(5, seed=4600, p_crash=0.0)
    W, S = 12, 8
    r_steps = [r_ev.events_to_steps(s, W=W) for s in ref]
    t_steps = [t_ev.events_to_steps(s, W=W) for s in port]
    r_out, (r_fr, *_) = r_bs.launch_tails_bitset(
        r_steps, [None] * 5, S=S, interpret=True, mesh=mesh)
    t_out, (t_fr, *_) = t_bs.launch_tails_bitset(
        t_steps, [None] * 5, S=S, device="cpu",
        mesh=t_sh.virtual_mesh("cpu", 8))
    assert np.array_equal(t_out.numpy()[:5], np.asarray(r_out)[:5])
    assert np.array_equal(t_fr.numpy()[:5], np.asarray(r_fr)[:5])
    seeds = [np.asarray(r_fr[i]) for i in range(5)]
    r_out2, _ = r_bs.launch_tails_bitset(r_steps, seeds, S=S,
                                         interpret=True, mesh=mesh)
    t_out2, (t_fr2, *_) = t_bs.launch_tails_bitset(
        t_steps, [t_fr[i] for i in range(5)], S=S, device="cpu",
        mesh=t_sh.virtual_mesh("cpu", 8))
    assert np.array_equal(t_out2.numpy()[:5], np.asarray(r_out2)[:5])
    assert launch_stats_snapshot() == r_bs.launch_stats_snapshot()
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)
    # a W12 seed row in a W13 launch
    r13 = [r_ev.events_to_steps(s, W=13) for s in ref]
    t13 = [t_ev.events_to_steps(s, W=13) for s in port]
    with pytest.raises(Exception):
        r_bs.launch_tails_bitset(r13, seeds, S=S, interpret=True,
                                 mesh=mesh)
    got, _ = t_bs.launch_tails_bitset(
        t13, [t_fr[i] for i in range(5)], S=S, device="cpu",
        mesh=t_sh.virtual_mesh("cpu", 8))
    solo, _ = t_bs.launch_tails_bitset(
        t13, [t_fr[i] for i in range(5)], S=S, device="cpu")
    assert torch.equal(got[:5], solo)


# -- the dispatch plane -----------------------------------------------------------


def test_plane_coalesced_bucket_mesh_differential(monkeypatch):
    """A coalesced bucket through the auto-meshed plane (the local-slot
    seam: 8 virtual slots): still ONE stacked launch (one key a slot),
    verdicts the reference's auto-meshed plane's and the single-device
    plane's, and dispatch_stats() per slot the reference's per device:
    one launch each, occupancy 1/8."""
    ref, port = _streams(8, n_ops=60, p_crash=0.0, seed=4600)
    with r_dp.DispatchPlane(interpret=True) as plane:
        futs = [plane.submit(s) for s in ref]
        plane.flush()
        want = [f.result() for f in futs]
    st_r = r_dp.dispatch_stats()
    monkeypatch.setenv(t_sh.ENV_LOCAL_DEVICES, "8")
    with t_dp.DispatchPlane(device="cpu") as plane:
        assert plane.mesh is not None and t_sh.mesh_size(plane.mesh) == 8
        futs = [plane.submit(s) for s in port]
        plane.flush()
        got = [f.result() for f in futs]
    st_t = t_dp.dispatch_stats()
    _same_rows(got, want)
    assert launch_stats_snapshot() == r_bs.launch_stats_snapshot()
    assert launch_stats_snapshot()["launches"] == 1
    assert st_t["batches"] == st_r["batches"] == 1
    assert st_t["n_devices"] == st_r["n_devices"] == 8
    assert _per_device(st_t) == _per_device(st_r)
    assert list(st_t["per_device"]) == [f"cpu[{k}]" for k in range(8)]
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)

    t_dp.reset_dispatch_stats()
    reset_launch_stats()
    with t_dp.DispatchPlane(device="cpu", mesh=False) as plane:
        assert plane.mesh is None
        futs = [plane.submit(s) for s in port]
        plane.flush()
        single = [f.result() for f in futs]
    assert launch_stats_snapshot()["launches"] == 1
    assert t_dp.dispatch_stats()["n_devices"] == 1
    assert got == single


def test_plane_run_keys_mesh_argument():
    """run_keys: None defers to the plane's mesh, False forces one
    device, a Mesh shards explicitly (the reference's rule)."""
    ref, port = _streams(16, p_crash=0.0)
    W, S = 12, 8
    steps = [t_ev.events_to_steps(s, W=W) for s in port]
    mesh = t_sh.virtual_mesh("cpu", 4)
    with t_dp.DispatchPlane(device="cpu", mesh=mesh) as plane:
        a = plane.run_keys(steps, S=S)
        assert t_sh.MESH_STATS["last_n_devices"] == 4
        b = plane.run_keys(steps, S=S, mesh=False)
        assert t_sh.MESH_STATS["sharded_launches"] == 1
        c = plane.run_keys(steps, S=S, mesh=t_sh.virtual_mesh("cpu", 8))
        assert t_sh.MESH_STATS["last_n_devices"] == 8
    assert a == b == c
    per = t_dp.dispatch_stats()["per_device"]
    assert per["cpu[0]"]["launches"] == 3  # the unsharded one lands first


def test_segmented_chain_commits_to_device():
    """A segmented chain launched on a slot's device (the plane's
    round-robin placement) gives the reference's verdict for the same
    chain committed to device 3."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    ref, port = _streams(1, n_ops=72, p_crash=0.1, seed=4710)
    plan = r_bs.plan(r_model("cas-register"), ref[0].window,
                     len(ref[0].value_codes))
    bW, S = plan
    r_steps = r_ev.events_to_steps(ref[0], W=bW)
    handle = r_bs.launch_steps_bitset_segmented(
        r_steps, S=S, interpret=True, min_len=1, device=devs[3])
    assert len(handle[0]) > 1
    want = r_bs.collect_steps_bitset_segmented(r_steps, handle)
    slot = list(t_sh.virtual_mesh("cpu", 8).devices.flat)[3]
    t_steps = t_ev.events_to_steps(port[0], W=bW)
    with t_sh.slot_scope(slot):
        th = t_bs.launch_steps_bitset_segmented(
            t_steps, S=S, min_len=1, device=slot.device)
    assert len(th[0]) == len(handle[0])
    assert th[0][0].device == slot.device
    got = t_bs.collect_steps_bitset_segmented(t_steps, th)
    assert tuple(got) == tuple(want)
    assert got[0] == oracle_check(port[0])


def test_plane_round_robins_segmented_chains():
    """Segmented chains round-robin onto the slots: 4 requests land on 4
    distinct slots, one launch each, verdicts the reference's (whose
    chains land on 4 distinct devices) and the oracle's."""
    mesh = _mesh8()
    ref, port = _streams(4, n_ops=48, p_crash=0.0, seed=4800)

    def run(dp_mod, plane, streams, ev_mod, model_of):
        futs = []
        for ev in streams:
            bW, S = (r_bs if dp_mod is r_dp else t_bs).plan(
                model_of("cas-register"), ev.window, len(ev.value_codes))
            f = dp_mod.CheckFuture(plane, ev, "cas-register")
            f.kind = "segmented"
            f.steps = ev_mod.events_to_steps(ev, W=bW)
            f.S, f.W = S, bW
            plane._dispatch_segmented(f)
            futs.append(f)
        return [f.result() for f in futs], dp_mod.dispatch_stats()

    with r_dp.DispatchPlane(interpret=True, mesh=mesh) as plane:
        want, st_r = run(r_dp, plane, ref, r_ev, r_model)
    with t_dp.DispatchPlane(device="cpu",
                            mesh=t_sh.virtual_mesh("cpu", 8)) as plane:
        got, st_t = run(t_dp, plane, port, t_ev, t_model)
    _same_rows(got, want)
    for ev, out in zip(port, got):
        assert out["valid?"] == oracle_check(ev)
    assert st_t["n_devices"] == st_r["n_devices"] == 4
    assert _per_device(st_t) == _per_device(st_r)
    assert list(st_t["per_device"]) == [f"cpu[{k}]" for k in range(4)]


def test_segmented_chain_replaces_off_a_dead_slot():
    """A persistent fault on slot 1: the second chain's placement fails
    there, the slot is quarantined, the mesh re-shards onto the 7
    survivors and the chain re-places on the next pick, all through the
    plane's one ladder. Verdicts, per-slot accounting by position and
    the reshard count equal the reference's under the same fault."""
    from jepsen_tpu.checker import chaos as r_chaos
    from jepsen_tpu_torch.checker import chaos as t_chaos

    mesh = _mesh8()
    t_mesh = t_sh.virtual_mesh("cpu", 8)
    ref, port = _streams(3, n_ops=48, p_crash=0.0, seed=4810)
    r_dead = str(list(mesh.devices.flat)[1])
    t_dead = str(list(t_mesh.devices.flat)[1])

    def run(dp_mod, plane, streams, ev_mod, model_of, bs_mod):
        futs = []
        for ev in streams:
            bW, S = bs_mod.plan(model_of("cas-register"), ev.window,
                                len(ev.value_codes))
            f = dp_mod.CheckFuture(plane, ev, "cas-register")
            f.kind = "segmented"
            f.steps = ev_mod.events_to_steps(ev, W=bW)
            f.S, f.W = S, bW
            plane._dispatch_segmented(f)
            futs.append(f)
        return [f.result() for f in futs], dp_mod.dispatch_stats()

    r_chaos.reset_resilience()
    try:
        with r_chaos.chaos_plan(r_chaos.persistent_device_fault(r_dead)):
            with r_dp.DispatchPlane(interpret=True, mesh=mesh,
                                    quarantine_after=1) as plane:
                want, st_r = run(r_dp, plane, ref, r_ev, r_model, r_bs)
                r_left = [str(d) for d in plane.mesh.devices.flat]
        r_res = r_sh.mesh_stats_snapshot()["resilience"]
    finally:
        r_chaos.reset_resilience()
    # two earlier attributed failures: the plane's first on the slot
    # reaches chaos.note_device_failure's threshold of 3
    for _ in range(2):
        t_chaos.note_device_failure(t_dead)
    with t_chaos.chaos_plan(t_chaos.persistent_device_fault(t_dead)):
        with t_dp.DispatchPlane(device="cpu", mesh=t_mesh) as plane:
            got, st_t = run(t_dp, plane, port, t_ev, t_model, t_bs)
            t_left = [str(d) for d in plane.mesh.devices.flat]
    _same_rows(got, want)
    for ev, out in zip(port, got):
        assert out["valid?"] == oracle_check(ev)
    res = t_sh.mesh_stats_snapshot()["resilience"]
    assert res["quarantined_devices"] == [t_dead]
    assert r_res["quarantined_devices"] == [r_dead]
    assert res["resharded_launches"] == r_res["resharded_launches"] == 1
    r_pos = {str(d): i for i, d in enumerate(mesh.devices.flat)}
    t_pos = {str(d): i for i, d in enumerate(t_mesh.devices.flat)}
    assert [t_pos[d] for d in t_left] == [r_pos[d] for d in r_left] == [
        0, 2, 3, 4, 5, 6, 7]
    assert [t_pos[d] for d in st_t["per_device"]] == [
        r_pos[d] for d in st_r["per_device"]] == [0, 3, 4]
    assert _per_device(st_t) == _per_device(st_r)


# -- the txn graph's arms -------------------------------------------------------

GRAPH_STATS = ("device_graphs", "matmul_rounds", "oversize_components",
               "row_sharded_launches", "host_fallback_components")


def _graph_histories(seed, **kw):
    return (r_sim.gen_txn_graph_history(random.Random(seed), **kw),
            t_sim.gen_txn_graph_history(random.Random(seed), **kw))


@pytest.mark.parametrize("anom", ["g1c", "g2-item"])
def test_txn_graph_batch_arm_matches_the_reference(anom):
    """The graph buckets sharded over 8 slots (the plane's mesh) against
    the reference's sharded graph batches on its auto mesh: the verdict,
    the graph counters and the mesh engagement."""
    _mesh8()
    rh, th = _graph_histories(7, n_txns=80, anomaly=anom, cycle_len=3)
    rtg.reset_txn_graph_stats()
    ttg.reset_txn_graph_stats()
    want = rtg.TxnGraphChecker().check({}, rh)
    with t_dp.DispatchPlane(device="cpu",
                            mesh=t_sh.virtual_mesh("cpu", 8)) as plane:
        got = ttg.TxnGraphChecker(plane=plane).check({}, th)
    assert _strip(got) == _strip(want)
    assert got["method"] == "gpu-txn-graph"
    assert {k: ttg.TXN_GRAPH_STATS[k] for k in GRAPH_STATS} == {
        k: rtg.TXN_GRAPH_STATS[k] for k in GRAPH_STATS}
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)
    assert t_sh.MESH_STATS["sharded_launches"] > 0


def test_txn_graph_oversize_arm_matches_the_reference():
    """buckets=(4,) sends every wider component down the oversize path,
    row-sharded over 8 slots in both packages (the N padded to a slot
    multiple, one gathered closure round after another, the counts
    summed): the verdict, the graph counters, row_sharded_launches and
    one host sync a component."""
    mesh = _mesh8()
    rh, th = _graph_histories(13, n_txns=40, anomaly="g1c", cycle_len=8)
    rtg.reset_txn_graph_stats()
    ttg.reset_txn_graph_stats()
    want = rtg.TxnGraphChecker(buckets=(4,), mesh=mesh).check({}, rh)
    # the reference's bucket batches shard over its default plane's
    # mesh too: the port's plane gets the same 8 slots
    with t_dp.DispatchPlane(device="cpu",
                            mesh=t_sh.virtual_mesh("cpu", 8)) as plane:
        got = ttg.TxnGraphChecker(buckets=(4,), plane=plane,
                                  mesh=t_sh.virtual_mesh("cpu", 8)).check(
            {}, th)
    assert _strip(got) == _strip(want)
    assert got["components"]["oversize"] > 0
    assert {k: ttg.TXN_GRAPH_STATS[k] for k in GRAPH_STATS} == {
        k: rtg.TXN_GRAPH_STATS[k] for k in GRAPH_STATS}
    assert ttg.TXN_GRAPH_STATS["row_sharded_launches"] == \
        got["components"]["oversize"]
    assert _mesh_stats(t_sh) == _mesh_stats(r_sh)


def test_row_sharded_counts_equal_the_single_graph_counts():
    """The row-sharded closure on an uneven split (N=13 over 4 slots,
    padded to 16) gives graph_counts_torch's counts on the whole graph,
    for each edge-class need."""
    rng = np.random.default_rng(3)
    n = 13
    wrww = (rng.random((n, n)) < 0.15).astype(np.float32)
    allm = np.maximum(wrww, (rng.random((n, n)) < 0.1).astype(np.float32))
    rw = (allm > 0) & (wrww == 0)
    from jepsen_tpu_torch.pod.slicing import host_shard_put

    mesh = t_sh.virtual_mesh("cpu", 4)
    pad = [np.pad(a, ((0, 3), (0, 3))) for a in (wrww, allm, rw)]
    for need1, need2 in ((True, True), (True, False), (False, True)):
        want = ttg.graph_counts_torch(
            *(torch.from_numpy(a[None]) for a in (wrww, allm, rw)),
            ttg._n_iters(n), need1, need2)
        got = t_sh.make_sharded_graph_rows(
            mesh, ttg._n_iters(n), need1, need2)(
            host_shard_put(pad, mesh))
        assert got.tolist() == [int(w[0]) for w in want]
