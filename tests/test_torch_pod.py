"""The port's pod layer (jepsen_tpu_torch.pod: topology, faultdomains,
slicing, launch_pod) against the JAX package's jepsen_tpu.pod, on the
CPU.

The host-domain quarantine cases run in one process on a virtual
("hosts", "chips") mesh of 2 x 4 slots (``virtual_mesh("cpu", 8,
hosts=2)``) beside the reference's 2 x 4 reshape of conftest's 8 CPU
devices: the same labels-by-position, ladder rungs and reshard
machinery, without killing live pod members (a killed gloo member
wedges the survivors' collectives). The real-pod case spawns a
2-process gloo pod on localhost through ``launch_pod`` (about 4 s) and
holds its verdicts against the single-process run and the reference's
``mesh=False`` run. Tolerance: exact equality."""

import json
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RMesh

from jepsen_tpu.checker import chaos as r_chaos
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import sharded as r_sh
from jepsen_tpu.pod import faultdomains as r_fd
from jepsen_tpu.pod import topology as r_topo
from jepsen_tpu import sim as r_sim

from jepsen_tpu_torch.checker import chaos
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import sharded
from jepsen_tpu_torch.checker.wgl_oracle import check_events as oracle_check
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats
from jepsen_tpu_torch.pod import faultdomains, launcher, topology

pytestmark = pytest.mark.pod


@pytest.fixture(autouse=True)
def _clean_resilience(monkeypatch):
    """Host-domain tests mutate both packages' quarantine ledgers, mesh
    stats and the default planes' sticky meshes: reset on both sides so
    nothing leaks; the port's mesh policy is restored."""
    monkeypatch.setitem(sharded._MESH_POLICY, "devices",
                        sharded._MESH_POLICY["devices"])
    monkeypatch.setitem(sharded._MESH_POLICY, "backend",
                        sharded._MESH_POLICY["backend"])
    for mod in (chaos, r_chaos):
        mod.reset_resilience()
    for mod in (sharded, r_sh):
        mod.reset_mesh_stats()
    t_dp.reset_default_plane()
    r_dp.reset_default_plane()
    yield
    for mod in (chaos, r_chaos):
        mod.reset_resilience()
    for mod in (sharded, r_sh):
        mod.reset_mesh_stats()
    t_dp.reset_default_plane()
    r_dp.reset_default_plane()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(n_keys, n_ops=24, corrupt_every=3, base=0):
    """(reference streams, the port's copies)."""
    out = []
    for seed in range(n_keys):
        rng = random.Random(base + seed)
        h = r_sim.gen_register_history(rng, n_ops=n_ops, n_procs=3,
                                       p_crash=0.05)
        if corrupt_every and seed % corrupt_every == 0:
            h = r_sim.corrupt_history(h, rng)
        out.append(r_ev.history_to_events(h))
    return out, [from_reference(s) for s in out]


def _hosts_meshes(n_hosts=2):
    """(the reference's 2 x 4 hosts x chips mesh, the port's)."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    ref = RMesh(np.asarray(devs[:8]).reshape(n_hosts, 8 // n_hosts),
                axis_names=("hosts", "chips"))
    return ref, sharded.virtual_mesh("cpu", 8, hosts=n_hosts)


def _positions(mesh, labels):
    """Flat slot positions of labels on a mesh (either package's)."""
    flat = [str(d) for d in mesh.devices.flat]
    return sorted(flat.index(lab) for lab in labels)


# -- topology (single-process side) ----------------------------------


def test_topology_snapshot_single_process():
    snap = topology.topology_snapshot()
    assert snap["n_hosts"] == 1
    assert snap["process_index"] == 0
    assert snap["backend"] == "cpu"
    assert snap["local_devices"] == snap["global_devices"] >= 1
    assert snap["initialized"] is False  # no pod joined in-process
    assert set(snap) == set(r_topo.topology_snapshot())


def test_init_pod_noop_without_config():
    # no env seam, no explicit config: nothing initializes
    assert topology.PodConfig.from_env({}) is None
    snap = topology.init_pod()
    assert snap["initialized"] is False
    assert topology.is_multiprocess() is False
    assert topology.pod_clock() is None


@pytest.mark.parametrize("env", [
    {},
    {"JEPSEN_TPU_POD_COORDINATOR": "127.0.0.1:9999",
     "JEPSEN_TPU_POD_NPROCS": "4", "JEPSEN_TPU_POD_PROCESS_ID": "2"},
    {"JEPSEN_TPU_POD_COORDINATOR": "10.0.0.1:1234"},
    {"JEPSEN_TPU_POD_NPROCS": "2"},
])
def test_pod_config_from_env(env):
    """The same env seam and names as the reference's, read the same."""
    assert topology.ENV_COORDINATOR == r_topo.ENV_COORDINATOR
    assert topology.ENV_NPROCS == r_topo.ENV_NPROCS
    assert topology.ENV_PROCESS_ID == r_topo.ENV_PROCESS_ID
    got = topology.PodConfig.from_env(env)
    want = r_topo.PodConfig.from_env(env)
    if want is None:
        assert got is None
    else:
        assert (got.coordinator, got.num_processes, got.process_id) == (
            want.coordinator, want.num_processes, want.process_id)
    if env.get("JEPSEN_TPU_POD_NPROCS") == "4":
        assert got == topology.PodConfig("127.0.0.1:9999", 4, 2)


def test_mesh_stats_snapshot_carries_topology():
    snap = sharded.mesh_stats_snapshot()
    topo = snap["topology"]
    assert topo["n_hosts"] == 1
    assert topo["backend"] == "cpu"
    assert topo["global_devices"] >= 1
    assert set(snap) == set(r_sh.mesh_stats_snapshot())


def test_mesh_policy_device_cap(monkeypatch):
    monkeypatch.setenv(sharded.ENV_LOCAL_DEVICES, "8")
    sharded.set_mesh_policy(devices=4)
    mesh = sharded.default_mesh("cpu")
    assert mesh is not None and sharded.mesh_size(mesh) == 4
    sharded.set_mesh_policy(devices=1)
    assert sharded.default_mesh("cpu") is None  # single-device path
    sharded.set_mesh_policy(backend="cpu")
    mesh = sharded.default_mesh()
    assert mesh is not None and sharded.mesh_size(mesh) == 8
    sharded.set_mesh_policy(backend="gpu")
    assert sharded.mesh_policy() == {"devices": None, "backend": "cuda"}
    sharded.set_mesh_policy()
    assert sharded.mesh_policy() == {"devices": None, "backend": None}


# -- host-level failure domains (virtual hosts, single-process) ------


def test_host_domains_virtual_mesh(monkeypatch):
    ref, mesh = _hosts_meshes(2)
    domains = faultdomains.host_domains(mesh)
    want = r_fd.host_domains(ref)
    assert sorted(domains) == sorted(want) == [0, 1]
    for h in domains:
        assert _positions(mesh, domains[h]) == _positions(ref, want[h])
    flat = [d for v in domains.values() for d in v]
    assert sorted(flat) == sorted(str(d) for d in mesh.devices.flat)
    # a 1-D mesh has no host structure: one domain
    monkeypatch.setenv(sharded.ENV_LOCAL_DEVICES, "8")
    assert list(faultdomains.host_domains(sharded.default_mesh("cpu"))) \
        == list(r_fd.host_domains(r_sh.default_mesh())) == [0]
    assert faultdomains.host_domains(None) == r_fd.host_domains(None) == {}
    assert faultdomains.host_label(3) == r_fd.host_label(3) == "host:3"


def test_mesh_without_ejects_whole_host_slice():
    ref, mesh = _hosts_meshes(2)
    smaller = sharded.mesh_without(mesh, [faultdomains.host_label(1)])
    r_smaller = r_sh.mesh_without(ref, [r_fd.host_label(1)])
    assert smaller is not None and smaller is not mesh
    survivors = {str(d) for d in smaller.devices.flat}
    assert survivors == set(faultdomains.host_domains(mesh)[0])
    assert _positions(mesh, survivors) == _positions(
        ref, {str(d) for d in r_smaller.devices.flat})
    # ejecting both hosts leaves nothing worth sharding
    assert sharded.mesh_without(
        mesh, [faultdomains.host_label(0), faultdomains.host_label(1)],
    ) is None
    # an unrelated host label passes the mesh through unchanged
    assert sharded.mesh_without(mesh, [faultdomains.host_label(7)]) is mesh


def test_note_host_death_quarantines_slice_and_ledger_row(monkeypatch):
    monkeypatch.setenv(sharded.ENV_LOCAL_DEVICES, "8")
    ref, mesh = _hosts_meshes(2)
    ejected = faultdomains.note_host_death(1, mesh)
    r_ejected = r_fd.note_host_death(1, ref)
    assert _positions(mesh, ejected) == _positions(ref, r_ejected)
    assert set(ejected) == set(faultdomains.host_domains(mesh)[1])
    # the ledger carries the host row AND every sibling slot label
    assert chaos.quarantined_hosts() == r_chaos.quarantined_hosts() == (
        "1",)
    for lab in ejected:
        assert chaos.is_quarantined(lab)
    assert all(not chaos.is_host_label(d)
               for d in chaos.quarantined_devices())
    snap = chaos.resilience_snapshot()
    assert snap["quarantined_hosts"] == ["1"]
    assert set(snap["quarantined_devices"]) == set(ejected)
    # default_mesh re-shards onto the surviving host's slice
    remesh = sharded.default_mesh("cpu")
    assert {str(d) for d in remesh.devices.flat} == set(
        faultdomains.host_domains(mesh)[0])
    assert sharded.mesh_size(remesh) == r_sh.mesh_size(r_sh.default_mesh())
    q = sharded.mesh_stats_snapshot()["resilience"]["quarantined_devices"]
    assert set(q) == set(ejected)
    assert chaos.mesh_ejection_labels() == ("host:1",) + tuple(ejected)


def test_quarantine_label_is_idempotent_and_fires_hooks():
    seen = []
    chaos.add_quarantine_hook(seen.append)
    try:
        assert chaos.quarantine_label("host:9") is True
        assert chaos.quarantine_label("host:9") is False
        assert seen == ["host:9"]
        assert chaos.quarantined_hosts() == ("9",)
    finally:
        chaos.remove_quarantine_hook(seen.append)


def test_mid_batch_host_death_reshard_verdict_parity():
    """The host-death differential: a persistent fault pinned to one
    slot of a 2 x 4 hosts x chips plane quarantines the slot, the
    host-domain policy condemns its WHOLE slice, the batch re-shards
    onto the surviving host, and the verdicts equal the clean run and
    the reference's under the same fault on the same position."""
    ref, mesh = _hosts_meshes(2)
    r_streams, t_streams = _streams(8, n_ops=24)
    target = str(list(mesh.devices.flat)[5])  # host 1's slice
    r_target = str(list(ref.devices.flat)[5])
    assert faultdomains.host_of_label(mesh, target) == 1
    assert r_fd.host_of_label(ref, r_target) == 1

    def run(dp, mesh_arg, streams, **kw):
        plane = dp.DispatchPlane(mesh=mesh_arg, **kw)
        try:
            futs = [plane.submit(s) for s in streams]
            return [f.result(timeout=120) for f in futs], plane.mesh
        finally:
            plane.close()

    clean, _ = run(t_dp, mesh, t_streams, device="cpu")
    chaos.reset_resilience()
    sharded.reset_mesh_stats()
    # two earlier attributed failures: the plane's first on the slot
    # reaches chaos.note_device_failure's threshold of 3, as the
    # reference plane's quarantine_after=1 trips on its first
    for _ in range(2):
        chaos.note_device_failure(target)
    with chaos.chaos_plan(chaos.persistent_device_fault(target)):
        faulted, after = run(
            t_dp, mesh, t_streams, device="cpu",
            retry=chaos.RetryPolicy(max_retries=1, base_delay_s=0.001))
    with r_chaos.chaos_plan(r_chaos.persistent_device_fault(r_target)):
        r_faulted, r_after = run(
            r_dp, ref, r_streams, interpret=True, race=False,
            quarantine_after=1,
            retry=r_chaos.RetryPolicy(max_retries=1, base_delay_s=0.001))
    for c, f, r in zip(clean, faulted, r_faulted):
        assert c["valid?"] == f["valid?"] == r["valid?"], (c, f, r)
        assert f.get("failed_op_index") == r.get("failed_op_index")
    # the whole slice went, not just the evidenced slot
    assert chaos.quarantined_hosts() == r_chaos.quarantined_hosts() == (
        "1",)
    dead = set(faultdomains.host_domains(mesh)[1])
    q = sharded.mesh_stats_snapshot()["resilience"]["quarantined_devices"]
    assert dead <= set(q)
    assert _positions(mesh, q) == _positions(
        ref, r_sh.mesh_stats_snapshot()["resilience"]["quarantined_devices"])
    assert sharded.MESH_STATS["resilience"]["resharded_launches"] == \
        r_sh.MESH_STATS["resilience"]["resharded_launches"] >= 1
    # the plane's shrink is sticky: it kept host 0's slice
    assert _positions(mesh, [str(d) for d in after.devices.flat]) == \
        _positions(ref, [str(d) for d in r_after.devices.flat])


def test_degradation_ladder_rungs(monkeypatch):
    ref, mesh = _hosts_meshes(2)
    assert faultdomains.degradation_ladder(mesh) == \
        r_fd.degradation_ladder(ref) == [
            "pod", "host-quarantined pod", "local host mesh",
            "single device", "oracle"]
    assert faultdomains.degradation_ladder(None) == \
        r_fd.degradation_ladder(None) == ["single device", "oracle"]
    monkeypatch.setenv(sharded.ENV_LOCAL_DEVICES, "8")
    assert faultdomains.degradation_ladder(sharded.default_mesh("cpu")) \
        == r_fd.degradation_ladder(r_sh.default_mesh()) == [
            "host mesh", "single device", "oracle"]


def test_local_host_mesh_single_process(monkeypatch):
    # single process: the local slots are all the slots
    monkeypatch.delenv(sharded.ENV_LOCAL_DEVICES, raising=False)
    assert faultdomains.local_host_mesh("cpu") is None
    monkeypatch.setenv(sharded.ENV_LOCAL_DEVICES, "8")
    mesh = faultdomains.local_host_mesh("cpu")
    assert sharded.mesh_size(mesh) == sharded.mesh_size(
        r_fd.local_host_mesh()) == 8
    chaos.quarantine_label("cpu[3]")
    assert sharded.mesh_size(faultdomains.local_host_mesh("cpu")) == 7


# -- a real two-process pod (subprocess) ------------------------------

_MEMBER = """
import json, random
import torch
import torch.distributed as dist
from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker import sharded, wgl_bitset as bs
from jepsen_tpu_torch.checker.events import events_to_steps, history_to_events
from jepsen_tpu_torch.checker.models import model
from jepsen_tpu_torch.checker.sharded import (
    check_keys, default_mesh, mesh_size)
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats
from jepsen_tpu_torch.pod import topology

streams = []
for seed in range({n_keys}):
    rng = random.Random(seed)
    h = sim.gen_register_history(rng, n_ops=24, n_procs=3, p_crash=0.05)
    if seed % 3 == 0:
        h = sim.corrupt_history(h, rng)
    streams.append(history_to_events(h))
assert topology.is_multiprocess()
mesh = default_mesh("cpu")
assert mesh.axis_names == ("hosts", "chips"), mesh
assert mesh_size(mesh) == 8 and mesh.group is not None
res = check_keys(streams, device="cpu", mesh=mesh)
launch = launch_stats_snapshot()
snap = topology.topology_snapshot()

# the exact tier, launched and collected apart: the gloo gather runs
# inside the launch, the one counted sync at the collect
W, S = bs.plan(model("cas-register"), max(s.window for s in streams),
               max(len(s.value_codes) for s in streams))
reset_launch_stats()
handle = bs.launch_keys_bitset(
    [events_to_steps(s, W=W) for s in streams], S=S, exact=True,
    device="cpu", mesh=mesh)
syncs_at_launch = launch_stats_snapshot()["host_syncs"]
alive = [v[0] for v in bs.collect_keys_bitset(handle)]
split = dict(rows=int(handle[0].shape[0]), syncs_at_launch=syncs_at_launch,
             syncs_at_collect=launch_stats_snapshot()["host_syncs"],
             alive=alive)

# a pod that also made an NCCL group (faked: init_pod makes one only
# when every rank owns distinct cards): a CPU mesh still gathers on gloo
fake = object()
topology._NCCL_GROUP[0] = fake
sharded._mesh_over.cache_clear()
sharded._pod_mesh_over.cache_clear()
cpu_mesh = default_mesh("cpu")
cards = [sharded.Slot(f"p{{r}}/cuda:0", torch.device("cuda", 0), r)
         for r in range(2)]
nccl = dict(cpu_group_is_world=cpu_mesh.group is dist.group.WORLD,
            cards_group_is_nccl=sharded._group_for(cards) is fake,
            res=check_keys(streams, device="cpu", mesh=cpu_mesh))
if snap["process_index"] == 0:
    print(json.dumps({{"res": res, "launch": launch, "topology": snap,
                       "clock": topology.pod_clock(), "split": split,
                       "nccl": nccl}}), flush=True)
"""


@pytest.fixture(scope="module")
def pod_run():
    """ONE real 2-process gloo pod (4 virtual slots a member, a 2 x 4
    hosts x chips mesh) over 16 register keys; member 0's record and
    the streams it generated (the reference's and the port's copies)."""
    ref, port = _streams(16, n_ops=24)
    # the member generates the same streams with the port's generator
    assert [from_reference(s).window for s in ref] == [s.window
                                                       for s in port]
    procs = launcher.launch_pod(2, _MEMBER.format(n_keys=16),
                                n_local_devices=4, timeout_s=120)
    for p in procs:
        assert p.ok, (p.process_id, p.returncode, p.stderr[-2000:])
    rec = json.loads([ln for ln in procs[0].stdout.splitlines() if ln][-1])
    return rec, ref, port


def test_two_process_pod_verdict_parity(pod_run):
    """Member 0's verdicts equal the single-process port's and the
    reference's mesh=False run, each key the oracle's, with the
    single-process run's launches and host syncs (one counted sync per
    check: the verdict rows' all_gather is not a second one); the
    topology names 2 hosts and the clock handshake ran."""
    rec, ref, port = pod_run
    want = r_sh.check_keys(ref, mesh=False)
    reset_launch_stats()
    single = sharded.check_keys(port, device="cpu", mesh=False)
    single_launch = launch_stats_snapshot()
    assert rec["res"] == single
    for r, w, s in zip(rec["res"], want, port):
        assert r["valid?"] == w["valid?"] == oracle_check(s)
        assert r.get("failed_op_index") == w.get("failed_op_index")
    assert rec["launch"] == single_launch
    assert rec["launch"]["host_syncs"] == rec["launch"]["launches"]
    topo = rec["topology"]
    assert topo["initialized"] is True and topo["n_hosts"] == 2
    assert topo["global_devices"] == 8 and topo["local_devices"] == 4
    assert topo["backend"] == "cpu"
    clock = rec["clock"]
    assert set(clock) == {"anchor_ns", "offset_ns", "skew_bound_ns",
                          "anchors_ns"}
    assert clock["skew_bound_ns"] > 0 and len(clock["anchors_ns"]) == 2


def test_pod_gather_waits_at_launch(pod_run):
    """In a gloo pod the all_gather of the verdict rows runs inside the
    launch (a departure: the reference's _replicator is an async
    dispatch): launch_keys_bitset already returns all 16 rows, both
    members' 8, with no counted sync; the collect pays the one."""
    rec, _, port = pod_run
    split = rec["split"]
    assert split["rows"] == 16
    assert split["syncs_at_launch"] == 0
    assert split["syncs_at_collect"] == 1
    assert split["alive"] == [oracle_check(s) for s in port]


def test_cpu_mesh_gathers_on_gloo_in_an_nccl_pod(pod_run):
    """A pod whose ranks own distinct cards also makes an NCCL group; a
    mesh of CPU slots still gathers on the default gloo group (NCCL
    would refuse its host tensors), and only a mesh of card slots takes
    the NCCL group. Faked inside the real pod: the member's verdicts
    on the CPU mesh are the same."""
    rec, _, _ = pod_run
    nccl = rec["nccl"]
    assert nccl["cpu_group_is_world"] is True
    assert nccl["cards_group_is_nccl"] is True
    assert nccl["res"] == rec["res"]


def test_launcher_kills_whole_pod_on_timeout():
    procs = launcher.launch_pod(
        2, "import time\ntime.sleep(60)\n", n_local_devices=1,
        timeout_s=3.0,
    )
    assert len(procs) == 2
    assert all(not p.ok for p in procs)


def test_pod_env_carries_both_seams():
    env = launcher.pod_env("127.0.0.1:1", 2, 1, 3, base_env={
        "CUDA_VISIBLE_DEVICES": "0"})
    assert topology.PodConfig.from_env(env) == topology.PodConfig(
        "127.0.0.1:1", 2, 1)
    assert env[sharded.ENV_LOCAL_DEVICES] == "3"
    assert env["CUDA_VISIBLE_DEVICES"] == "0"  # untouched
    assert topology.PodConfig.from_env(launcher.member_env()) is None
