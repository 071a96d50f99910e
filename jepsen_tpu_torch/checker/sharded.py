"""Multi-key batched checking on one device or over a mesh of slots: the
counterpart of jepsen_tpu.checker.sharded.

The reference parallelizes per-key sub-checks with bounded thread pools
on the control node (jepsen/src/jepsen/independent.clj:266-288). Here
independent keys become the key axis of one launch: per-key step
streams are packed side by side and every kernel runs one block per
key, so a batch of keys pays one launch and one host sync.

check_keys takes the reference's tiers in the reference's order:

  rich-state models: the packed variant where every key fits it, the
      in-envelope keys on the kernels and the rest on the host oracle
      for a mixed batch, else the host oracle for all (check_streams)
  window over 128 slots: the host oracle (check_streams)
  exact bitset batch (kernel A), when bs.plan covers the batch and no
      key is tainted                            gpu-wgl-bitset-batch
  one device: K-frontier batch (kernel B), where _pallas_ok
                                                gpu-wgl-kfrontier-batch
      else the key-batched torch-ops scan       gpu-wgl-batch
  a mesh: the key-batched torch-ops scan per slot
                                                gpu-wgl-sharded

and on the K-frontier tiers an overflow-tainted death escalates that key
alone through check_events_bucketed. Unlike the reference, which takes
its bitset and Pallas tiers only on a TPU or in interpret mode
(sharded.py:518, 555), the tier here does not depend on the device: on
the CPU the same tier runs the kernels' plain versions. So on the CPU
the reference's vmap tier (tpu-wgl-batch) meets this module's kernel-B
tier: the verdicts, frontier_k and escalations agree, the method names
differ. Under a mesh both packages take the sharded scan, as the
reference skips its Pallas batch there (sharded.py:554).

The mesh. JAX's ``jax.sharding.Mesh`` has no PyTorch counterpart, so
this module defines one: a frozen, hashable ``Mesh`` whose ``devices``
is a numpy object array of ``Slot``s, with ``axis_names`` ("keys",) or
("hosts", "chips") and, when it spans processes, the pod's process
group. A real slot is one card (or the CPU); a virtual slot is one of N
slots on the same torch device, each with its own CUDA stream on the
card (none on the CPU). Virtual slots come from the
``JEPSEN_TPU_TORCH_LOCAL_DEVICES`` seam (launcher.pod_env sets it in
each pod child) or from ``virtual_mesh(device, n)``: they are the
port's counterpart of the reference's test seams
(``--xla_force_host_platform_device_count`` and
``launch_pod(n_local_devices=)``), for tests and chip_smoke.py, not a
CLI option. Keys split over the mesh in contiguous blocks (key_block):
slot i holds rows [i*k, (i+1)*k) of the batch padded to a multiple of
the mesh size, and each slot runs its block on its own stream
(pod/slicing.py places the blocks and gathers the outputs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.events import (
    EventStream,
    bucket,
    events_to_steps,
    n_words,
)
from jepsen_tpu_torch.checker.linearizable import (
    K_LADDER,
    _bucket_window,
    _pallas_ok,
    check_events_bucketed,
)
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.checker.wgl_kfrontier import check_keys_kfrontier
from jepsen_tpu_torch.checker.wgl_oracle import check_streams
from jepsen_tpu_torch.checker.wgl_torch import wgl_scan_keys
from jepsen_tpu_torch.device import (
    _host_get,
    device_label,
    record_use,
    resolve_device,
)

#: the local-slot seam: N virtual slots on this process's device (the
#: reference's --xla_force_host_platform_device_count, one level down
#: from launch_pod's n_local_devices)
ENV_LOCAL_DEVICES = "JEPSEN_TPU_TORCH_LOCAL_DEVICES"


# -- slots and the mesh ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Slot:
    """One place a key block runs: a torch device, a label unique across
    the pod (what chaos attributes faults to and quarantine ejects),
    and the process that owns it. Virtual slots share a device and are
    told apart by their labels and streams."""

    label: str
    device: torch.device
    process_index: int = 0

    def __str__(self) -> str:
        return self.label


def _dev_type(device) -> str:
    if device is None:
        pinned = _MESH_POLICY["backend"]
        if pinned:
            return pinned
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def local_slot_count(device_type: str) -> int:
    """How many slots this process owns on ``device_type``: the seam's
    count when it is set, else one per card (none without CUDA) or one
    CPU slot."""
    seam = os.environ.get(ENV_LOCAL_DEVICES)
    if device_type == "cuda" and not torch.cuda.is_available():
        return 0
    if seam:
        return max(int(seam), 0)
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


def _slots_of(rank: int, device_type: str, n: int, pod: bool,
              base: Optional[torch.device] = None) -> Tuple[Slot, ...]:
    """The slots of process ``rank``: n virtual slots on one device when
    the seam is set, else one real slot per card (or the CPU). A pod
    prefixes every label with its process, so labels stay unique."""
    prefix = f"p{rank}/" if pod else ""
    virtual = bool(os.environ.get(ENV_LOCAL_DEVICES))
    if device_type == "cpu":
        dev = torch.device("cpu")
        if not virtual:
            return (Slot(prefix + "cpu", dev, rank),)[:n]
        return tuple(Slot(f"{prefix}cpu[{k}]", dev, rank)
                     for k in range(n))
    if virtual:
        dev = torch.device("cuda", 0 if base is None or base.index is None
                           else base.index)
        return tuple(Slot(f"{prefix}{dev}[{k}]", dev, rank)
                     for k in range(n))
    return tuple(Slot(f"{prefix}cuda:{i}", torch.device("cuda", i), rank)
                 for i in range(n))


def _pod():
    from jepsen_tpu_torch.pod import topology

    return topology


def local_slots(device=None) -> Tuple[Slot, ...]:
    """This process's slots of ``device``'s type (None: the policy's
    backend, else the card when there is one)."""
    t = _dev_type(device)
    topo = _pod()
    pod = topo.is_multiprocess()
    return _slots_of(topo.process_index() if pod else 0, t,
                     local_slot_count(t), pod,
                     torch.device(device) if device is not None else None)


def visible_slots(device=None) -> Tuple[Slot, ...]:
    """Every slot of ``device``'s type this process can name: its own,
    and in a pod every rank's (from the slot table init_pod gathered),
    rank-major."""
    t = _dev_type(device)
    topo = _pod()
    table = topo.slot_table() if topo.is_multiprocess() else None
    if table is None:
        return local_slots(device)
    out: List[Slot] = []
    for rank, row in enumerate(table):
        out.extend(_slots_of(rank, t, int(row[t]), True))
    return tuple(out)


def virtual_mesh(device, n: int, hosts: Optional[int] = None) -> "Mesh":
    """A mesh of n virtual slots on one device: ("keys",), or with
    ``hosts`` a ("hosts", "chips") mesh of hosts rows (virtual host
    domains, pod/faultdomains.py). The slots are the ones the local-slot
    seam would give, so their labels match the ambient mesh's."""
    base = device_label(resolve_device(device))
    dev = torch.device(base)
    slots = tuple(Slot(f"{base}[{k}]", dev) for k in range(n))
    if hosts is None:
        return _mesh_over(slots)
    if n % hosts:
        raise ValueError(f"{n} slots do not split into {hosts} hosts")
    arr = np.empty((hosts, n // hosts), dtype=object)
    for i, s in enumerate(slots):
        arr.flat[i] = s
    return Mesh(arr, ("hosts", "chips"))


def _obj_array(slots) -> np.ndarray:
    arr = np.empty(len(slots), dtype=object)
    for i, s in enumerate(slots):
        arr[i] = s
    return arr


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The port's jax.sharding.Mesh: ``devices`` a numpy object array of
    Slots, one axis per name (``mesh.devices.flat``,
    ``mesh.axis_names`` and ``mesh.shape[ax]`` as in the reference),
    and the pod's process group when the slots span processes. Frozen
    and hashable by its slot labels, layout and group, so the
    lru_cached per-slot programs keyed by a mesh still hit."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("keys",)
    group: Any = None

    def __post_init__(self):
        devs = self.devices
        if not isinstance(devs, np.ndarray) or devs.dtype != object:
            devs = _obj_array(list(np.asarray(devs, dtype=object).flat))
        names = tuple(self.axis_names)
        if devs.ndim != len(names):
            raise ValueError(f"{devs.ndim}-d slots for axes {names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "_key", (
            tuple(str(d) for d in devs.flat), devs.shape, names))

    def __hash__(self) -> int:
        return hash(self._key)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self._key == other._key
                and self.group is other.group)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"[{', '.join(str(d) for d in self.devices.flat)}])")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def local_positions(mesh: Mesh) -> List[int]:
    """Flat positions of the mesh's slots this process owns (all of
    them off-pod)."""
    me = _pod().process_index() if mesh.group is not None else 0
    return [i for i, s in enumerate(mesh.devices.flat)
            if mesh.group is None or s.process_index == me]


def mesh_local_slots(mesh: Mesh) -> List[Slot]:
    flat = list(mesh.devices.flat)
    return [flat[i] for i in local_positions(mesh)]


_STREAMS: dict = {}
_streams_lock = threading.Lock()


def slot_stream(slot: Slot):
    """The slot's own CUDA stream (None on the CPU), made once."""
    if slot.device.type != "cuda":
        return None
    with _streams_lock:
        s = _STREAMS.get(slot.label)
        if s is None:
            s = _STREAMS[slot.label] = torch.cuda.Stream(device=slot.device)
        return s


@contextlib.contextmanager
def slot_scope(slot: Slot):
    """Run a slot's work on its device and stream. The slot's stream
    first waits for the caller's current stream, so what the caller
    queued (uploads, a gathered matrix) is ready; kernels launch under
    ``torch.cuda.device(slot.device)``, as a launch on another card
    needs. A no-op on the CPU."""
    if slot.device.type != "cuda":
        yield
        return
    stream = slot_stream(slot)
    with torch.cuda.device(slot.device):
        stream.wait_stream(torch.cuda.current_stream(slot.device))
        with torch.cuda.stream(stream):
            yield


def caller_waits(slots: Sequence[Slot]) -> None:
    """Make the caller's current stream on each slot's device wait for
    the slot's stream (the gather reads what the slots wrote)."""
    for slot in slots:
        if slot.device.type == "cuda":
            torch.cuda.current_stream(slot.device).wait_stream(
                slot_stream(slot))


def padded_rows(n: int, mesh: Mesh) -> int:
    """n rows padded up to a multiple of the mesh size."""
    nd = mesh_size(mesh)
    return ((n + nd - 1) // nd) * nd


def key_block(mesh: Mesh, rows: int, pos: int) -> slice:
    """The one key-axis layout: keys split over EVERY mesh axis (the
    full slot product) in contiguous blocks, slot ``pos`` (flat
    position) holding rows [pos*k, (pos+1)*k) of the padded batch.
    Placement (slicing.host_shard_put), the gathers and the plane's
    per-slot accounting all follow it."""
    k = rows // mesh_size(mesh)
    return slice(pos * k, (pos + 1) * k)


def stack_streams(
    streams: Sequence[EventStream],
    W: int,
    n_keys: Optional[int] = None,
    model: str = "cas-register",
) -> tuple:
    """Precompile per-key event streams and stack them into padded
    arrays: (occ [n_keys, n, W], f, a, b, slot [n_keys, n], live,
    crashed [n_keys, n, NW], op_index, init_state [n_keys] as kernel
    codes), n = bucket(longest, 64). Missing keys (n_keys >
    len(streams)) become blank rows: init_state -1, no live steps,
    trivially valid."""
    if not streams:
        raise ValueError("no event streams")
    steps = [events_to_steps(s, W=W) for s in streams]
    n = bucket(max(max(len(st) for st in steps), 1), 64)
    steps = [st.padded(n) for st in steps]
    k = n_keys or len(steps)
    if k < len(steps):
        raise ValueError(f"n_keys {k} < {len(steps)} streams")
    while len(steps) < k:
        blank = steps[0]
        steps.append(
            type(blank)(
                occ=np.zeros_like(blank.occ),
                f=np.zeros_like(blank.f),
                a=np.zeros_like(blank.a),
                b=np.zeros_like(blank.b),
                slot=np.zeros_like(blank.slot),
                live=np.zeros_like(blank.live),
                crashed=np.zeros_like(blank.crashed),
                op_index=np.full_like(blank.op_index, -1),
                init_state=-1,
                W=W,
            )
        )
    kic = get_model(model).kernel_init_code
    return tuple(
        np.stack([getattr(st, c) for st in steps])
        for c in ("occ", "f", "a", "b", "slot", "live", "crashed",
                  "op_index")
    ) + (np.asarray([kic(st.init_state) for st in steps], np.int32),)


def _oracle_rows(streams, model) -> List[dict]:
    verdicts, meta = check_streams(streams, model=model)
    return [
        {"valid?": v, "method": f"cpu-oracle-{rung}"}
        for v, rung in zip(verdicts, meta["rungs"])
    ]




#: mesh-path accounting: "sharded_launches" counts sharded dispatches
#: (bitset or vmap tier, graph batches, row-sharded closures),
#: "last_n_devices" the slot count of the most recent one. chip_smoke.py
#: reads these to prove the mesh path engaged: a silent fallback to one
#: device must be loud. "resilience" is the mesh's view of the chaos
#: layer: slots ejected by quarantine and launches that re-sharded onto
#: the survivors.
MESH_STATS = {
    "sharded_launches": 0,
    "last_n_devices": 0,
    "resilience": {"quarantined_devices": [], "resharded_launches": 0},
}

_mesh_stats_lock = threading.Lock()


def note_sharded_launch(n_devices: int) -> None:
    with _mesh_stats_lock:
        MESH_STATS["sharded_launches"] += 1
        MESH_STATS["last_n_devices"] = int(n_devices)


def note_quarantine(label: str) -> None:
    """Record a slot ejection in the mesh's resilience block."""
    with _mesh_stats_lock:
        q = MESH_STATS["resilience"]["quarantined_devices"]
        if label not in q:
            q.append(label)


def note_reshard() -> None:
    """Record one launch that re-sharded onto surviving slots."""
    with _mesh_stats_lock:
        MESH_STATS["resilience"]["resharded_launches"] += 1


def reset_mesh_stats() -> None:
    with _mesh_stats_lock:
        MESH_STATS["sharded_launches"] = 0
        MESH_STATS["last_n_devices"] = 0
        MESH_STATS["resilience"] = {
            "quarantined_devices": [], "resharded_launches": 0,
        }


def mesh_stats_snapshot() -> dict:
    """Locked copy of MESH_STATS (the resilience block holds a mutable
    list, so a shallow copy would alias it), plus the pod topology
    block (hosts, local against global slots, backend), fetched
    OUTSIDE the lock."""
    topo = _pod().topology_snapshot()
    with _mesh_stats_lock:
        res = MESH_STATS["resilience"]
        return {
            "sharded_launches": MESH_STATS["sharded_launches"],
            "last_n_devices": MESH_STATS["last_n_devices"],
            "resilience": {
                "quarantined_devices": list(res["quarantined_devices"]),
                "resharded_launches": res["resharded_launches"],
            },
            "topology": topo,
        }


def mesh_size(mesh: Mesh) -> int:
    """Slot count of a mesh = product over every axis (keys shard over
    the full product; see key_block)."""
    return int(np.prod([mesh.shape[ax] for ax in mesh.axis_names]))


def _group_for(slots) -> Any:
    """The pod's process group when the slots span processes, else
    None: the NCCL group (when init_pod made one) only for a mesh of
    card slots, the default gloo group for a CPU mesh."""
    if len({s.process_index for s in slots}) < 2:
        return None
    topo = _pod()
    if not topo.is_multiprocess():
        return None
    import torch.distributed as dist

    nccl = topo.collective_group()
    if nccl is not None and all(s.device.type == "cuda" for s in slots):
        return nccl
    return dist.group.WORLD


@functools.lru_cache(maxsize=None)
def _mesh_over(devices: tuple) -> Mesh:
    return Mesh(_obj_array(devices), ("keys",), _group_for(devices))


@functools.lru_cache(maxsize=None)
def _pod_mesh_over(rows: tuple) -> Mesh:
    """The global hosts x chips mesh: one row per host (process), one
    column per slot of that host."""
    arr = np.empty((len(rows), len(rows[0])), dtype=object)
    for i, r in enumerate(rows):
        for j, s in enumerate(r):
            arr[i, j] = s
    return Mesh(arr, ("hosts", "chips"),
                _group_for([s for r in rows for s in r]))


#: the CLI's mesh-policy seam (set_mesh_policy): an explicit slot cap
#: and/or backend for the ambient mesh, so mesh shape is reachable from
#: `analyze`/`daemon` flags, not only the local-slot env seam
_MESH_POLICY = {"devices": None, "backend": None}


def set_mesh_policy(devices: Optional[int] = None,
                    backend: Optional[str] = None) -> None:
    """Pin the ambient mesh selection: ``devices`` caps the auto mesh at
    N slots (1 forces the single-device path), ``backend`` selects
    which device type it spans ("cpu" or "cuda"; "gpu" means "cuda").
    None clears the respective pin. Meshes are cached by slot
    tuple, so changing policy mid-process is safe."""
    _MESH_POLICY["devices"] = int(devices) if devices else None
    _MESH_POLICY["backend"] = (
        {"gpu": "cuda"}.get(backend, backend) if backend else None)


def mesh_policy() -> dict:
    return dict(_MESH_POLICY)


def _healthy_devices(device=None) -> list:
    """Visible slots minus quarantine ejections (per-slot labels AND
    host-domain rows: a slot whose owning process is quarantined is
    dead even if its own label never accumulated evidence), under the
    mesh policy's slot cap."""
    from jepsen_tpu_torch.checker.chaos import HOST_PREFIX, is_quarantined

    devs = [
        d for d in visible_slots(device)
        if not is_quarantined(str(d))
        and not is_quarantined(f"{HOST_PREFIX}{d.process_index}")
    ]
    cap = _MESH_POLICY["devices"]
    if cap:
        devs = devs[:cap]
    return devs


def default_mesh(device=None) -> Optional[Mesh]:
    """The ambient execution mesh: a Mesh over every healthy slot of
    ``device``'s type when there is more than one, else None. check_keys
    and the dispatch plane consult this when the caller passes
    mesh=None, so a host with several slots goes sharded by default
    while a one-card host keeps the exact single-device dispatch. Slots
    ejected by the quarantine (checker.chaos) are excluded: a fresh
    auto-mesh re-shards onto the survivors.

    In a pod the mesh generalizes to the global hosts x chips layout:
    one "hosts" row per process. Quarantine can leave hosts ragged
    (different survivor counts per row); the mesh then falls back to
    1-D over the global survivors; keys shard over the full product
    either way (key_block), so verdicts are layout-independent."""
    devs = _healthy_devices(device)
    if len(devs) < 2:
        return None
    by_host: dict = {}
    for d in devs:
        by_host.setdefault(d.process_index, []).append(d)
    if len(by_host) > 1:
        rows = [tuple(by_host[h]) for h in sorted(by_host)]
        if len({len(r) for r in rows}) == 1:
            return _pod_mesh_over(tuple(rows))
    return _mesh_over(tuple(devs))


def mesh_without(mesh: Optional[Mesh], labels) -> Optional[Mesh]:
    """Re-shard a mesh onto the slots NOT in ``labels`` (the quarantine
    ejection path): survivors rebuild as a 1-D mesh, and the batch pad
    absorbs the new uneven key split like any other. ``host:<i>``
    labels eject that host's WHOLE slice (pod.faultdomains expands them
    against this mesh). Fewer than 2 survivors collapses to None (the
    single-device path). A mesh with nothing to eject passes through
    unchanged (the same object, so lru-cached wrappers still hit)."""
    if mesh is None:
        return None
    from jepsen_tpu_torch.pod.faultdomains import expand_host_labels

    dead = expand_host_labels(mesh, labels)
    devs = list(mesh.devices.flat)
    survivors = tuple(d for d in devs if str(d) not in dead)
    if len(survivors) == len(devs):
        return mesh
    if len(survivors) < 2:
        return None
    return _mesh_over(survivors)


def resolve_mesh(mesh, device=None) -> Optional[Mesh]:
    """The one mesh-selection rule: None -> auto (default_mesh over the
    healthy slots of ``device``'s type), False -> the single-device
    path, a Mesh passes through (ValueError when its slots are not of
    ``device``'s type)."""
    if mesh is None:
        return default_mesh(device)
    if mesh is False:
        return None
    if device is not None:
        want = torch.device(device).type
        bad = [str(d) for d in mesh.devices.flat if d.device.type != want]
        if bad:
            raise ValueError(
                f"mesh slots {bad} are not on the {want} device")
    return mesh


# -- the per-slot programs (the reference's shard_map'd jits) ------------------


@functools.lru_cache(maxsize=None)
def make_sharded_bitset(mesh: Mesh, model_name: str, S: int, W: int,
                        exact: bool):
    """Build (and cache) the per-slot launcher of the stacked bitset
    batch: fn(blocks) runs kernel A (wgl_bitset.bitset_scan, so every
    launch is a counted, recordable one) once per local slot on its
    block (win, meta, fr_in), on the slot's stream, and returns each
    slot's (out, fr_out). Keys are independent, so no slot waits for
    another."""
    slots = mesh_local_slots(mesh)

    def run(blocks):
        outs = []
        for slot, args in zip(slots, blocks):
            with slot_scope(slot):
                record_use(args)
                outs.append(bs.bitset_scan(*args, model_name, S, W,
                                           exact=exact))
        return outs

    return run


@functools.lru_cache(maxsize=None)
def make_sharded_checker(mesh: Mesh, model_name: str, K: int, W: int):
    """Build (and cache) the per-slot key-batched torch-ops scan:
    fn(cols) takes the padded host columns of stack_streams and runs
    wgl_torch.wgl_scan_keys on each local slot's block of rows, on the
    slot's stream; it returns each slot's (alive, overflow, died)."""
    slots = mesh_local_slots(mesh)
    pos = local_positions(mesh)

    def run(cols):
        rows = cols[0].shape[0]
        outs = []
        for slot, p in zip(slots, pos):
            blk = key_block(mesh, rows, p)
            with slot_scope(slot):
                outs.append(wgl_scan_keys(
                    tuple(c[blk] for c in cols), model_name, K,
                    slot.device))
        return outs

    return run


@functools.lru_cache(maxsize=None)
def make_sharded_graph(mesh: Mesh, n_iters: int, need1: bool,
                       need2: bool):
    """Batch-axis per-slot closure: fn(blocks) runs the txn graph's
    repeated-squaring counts (txn_graph.graph_counts_torch) on each
    local slot's block of [B, N, N] adjacency stacks; graphs are
    independent components, so no slot waits for another."""
    from jepsen_tpu_torch.checker.txn_graph import graph_counts_torch

    slots = mesh_local_slots(mesh)

    def run(blocks):
        outs = []
        for slot, args in zip(slots, blocks):
            with slot_scope(slot):
                record_use(args)
                outs.append(graph_counts_torch(*args, n_iters, need1,
                                               need2))
        return outs

    return run


@functools.lru_cache(maxsize=None)
def make_sharded_graph_rows(mesh: Mesh, n_iters: int, need1: bool,
                            need2: bool):
    """Row-sharded closure for one oversize component: each slot owns a
    block of rows of the [N, N] reachability matrix and, in each of
    n_iters rounds, squares it against the gathered full matrix
    (R_blk = min(R_blk + R_blk @ R, 1)); the scalar anomaly counts are
    summed over the slots (and over the pod). fn(blocks) takes each
    local slot's (wrww, allm, rw) row block and returns the three int64
    counts, one tensor [3] on the caller's side (the CPU in a pod)."""
    from jepsen_tpu_torch.pod import slicing

    slots = mesh_local_slots(mesh)
    pos = local_positions(mesh)

    def closure(blks):
        blks = [b.to(torch.bfloat16) for b in blks]
        for _ in range(n_iters):
            full = slicing.gather_rows(blks, mesh)
            nxt = []
            for slot, r in zip(slots, blks):
                with slot_scope(slot):
                    f = full.to(slot.device)
                    record_use((f, r))
                    nxt.append((r + r @ f).clamp_max(1.0))
            blks = nxt
        return blks

    def rw_hits(blks, rws):
        cf = slicing.gather_rows(blks, mesh)  # [N, N]
        hits, diag = [], []
        for slot, p, c, rwb in zip(slots, pos, blks, rws):
            rows = c.shape[0]
            with slot_scope(slot):
                f = cf.to(slot.device)
                record_use((f, rwb))
                # this block's rows of closure.T
                ct = f[:, p * rows:(p + 1) * rows].T
                hits.append((rwb & (ct > 0)).sum())
                idx = torch.arange(rows, device=slot.device)
                diag.append((c[idx, p * rows + idx] > 0).sum())
        return hits, diag

    def run(blocks):
        zero = [torch.zeros((), dtype=torch.int64, device=s.device)
                for s in slots]
        rws = [b[2] > 0 for b in blocks]
        g1c = gs = g2 = zero
        if need1:
            gs, g1c = rw_hits(closure([b[0] for b in blocks]), rws)
        if need2:
            g2, _ = rw_hits(closure([b[1] for b in blocks]), rws)
        return slicing.sum_counts(
            [torch.stack([a, b, c]).to(torch.int64)
             for a, b, c in zip(g1c, gs, g2)], mesh)

    return run


def check_keys(
    streams: Sequence[EventStream],
    model: str = "cas-register",
    k_ladder=K_LADDER,
    device=None,
    mesh=None,
) -> List[dict]:
    """Check many independent per-key event streams at once: one kernel
    launch and one host sync for the whole batch on the bitset and
    K-frontier tiers (a fast-tier death on the bitset tier re-runs the
    batch exactly: two of each). Returns one verdict dict per stream,
    in order (see the module docstring for the tiers and their method
    names).

    device: None runs on the CUDA card (raising without one); "cpu"
    runs every kernel's plain PyTorch version. mesh selects the layout
    (resolve_mesh): None takes a mesh over every healthy slot of the
    device's type when there is more than one (default_mesh), False
    forces the single-device path, a Mesh is used as given. With a mesh
    the keys pad to a multiple of the mesh size and each slot runs its
    block: still one counted launch and one host sync for all keys on
    all slots."""
    n_real = len(streams)
    if n_real == 0:
        return []
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    m = get_model(model)
    if not m.jax_capable:
        in_env = (
            [bool(m.packed_ok(s)) for s in streams]
            if m.packed_variant and m.packed_ok is not None
            else [False] * n_real
        )
        if not any(in_env):
            return _oracle_rows(streams, model)
        if not all(in_env):
            # Mixed batch: in-envelope keys keep the kernel path; only
            # the offenders detour to the host oracle. The mesh is
            # resolved: pass False (not None) for the single device, or
            # the recursion would auto-detect again.
            ok_idx = [i for i, e in enumerate(in_env) if e]
            bad_idx = [i for i, e in enumerate(in_env) if not e]
            merged: List[Optional[dict]] = [None] * n_real
            for i, r in zip(ok_idx, check_keys(
                [streams[i] for i in ok_idx], model=m.packed_variant,
                k_ladder=k_ladder, device=dev,
                mesh=mesh if mesh is not None else False,
            )):
                merged[i] = r
            for i, r in zip(bad_idx, _oracle_rows(
                [streams[i] for i in bad_idx], model
            )):
                merged[i] = r
            return merged  # type: ignore[return-value]
        # word-sized bounded encoding: the whole batch rides the kernels
        model = m.packed_variant
        m = get_model(model)
    window = max(max(s.window for s in streams), 1)
    W = _bucket_window(window)
    if W is None:
        # too concurrent for the masks: the host oracle, over the cores
        return _oracle_rows(streams, model)
    K = k_ladder[0]

    # Exact bitset batch first: definite verdicts, no per-key
    # escalation. Every key must fit its envelope at the batch's
    # largest window and state-row buckets. With a mesh the stacked
    # batch splits over the slots inside launch_keys_bitset: the same
    # method, the same one-launch contract.
    bplan = bs.plan(m, window, max(len(s.value_codes) for s in streams))
    if bplan is not None:
        bW, S = bplan
        steps = [events_to_steps(s, W=bW) for s in streams]
        outs = bs.check_keys_bitset(
            steps, model=model, S=S, device=dev,
            mesh=mesh if mesh is not None else False)
        if not any(taint for _, taint, _ in outs):
            res: List[dict] = []
            for alive, _, died in outs:
                r = {
                    "valid?": alive,
                    "method": "gpu-wgl-bitset-batch",
                    "frontier_k": None,
                    "escalations": 0,
                }
                if not alive:
                    r["failed_op_index"] = died
                res.append(r)
            return res

    if mesh is not None:
        # the sharded torch-ops scan, as the reference takes its
        # sharded vmap (not its Pallas batch) under a mesh
        from jepsen_tpu_torch.pod.slicing import global_view

        cols = stack_streams(streams, W=W, n_keys=padded_rows(n_real, mesh),
                             model=model)
        outs = make_sharded_checker(mesh, model, K, W)(cols)
        note_sharded_launch(mesh_size(mesh))
        alive, overflow, died = (np.asarray(a)[:n_real] for a in _host_get(
            global_view(outs, mesh)))
        method = "gpu-wgl-sharded"
    elif _pallas_ok(K, W, n_words(W)):
        # one kernel-B launch, keys as its grid
        kic = m.kernel_init_code
        steps = []
        for s in streams:
            st = events_to_steps(s, W=W)
            ki = kic(s.init_state)
            if ki != st.init_state:
                # packed models re-encode the initial state; copy so
                # the memoized steps stay untouched for other models
                st = dataclasses.replace(st, init_state=ki)
            steps.append(st)
        outs = check_keys_kfrontier(steps, model=model, K=K, device=dev)
        alive, overflow, died = (np.asarray(c) for c in zip(*outs))
        method = "gpu-wgl-kfrontier-batch"
    else:
        cols = stack_streams(streams, W=W, n_keys=n_real, model=model)
        alive, overflow, died = _host_get(
            wgl_scan_keys(cols, model, K, dev)
        )
        method = "gpu-wgl-batch"
    return vmap_verdicts(
        streams, alive, overflow, died,
        model=model, k_ladder=k_ladder, K=K, method=method, device=dev,
    )


def vmap_verdicts(
    streams,
    alive,
    overflow,
    died,
    *,
    model: str,
    k_ladder,
    K: int,
    method: str = "gpu-wgl-batch",
    device=None,
) -> List[dict]:
    """Turn a batched K-frontier scan's (alive, overflow, died) vectors
    back into per-stream verdict dicts: definite results map directly;
    an overflow-tainted death escalates that stream alone up the
    remaining k_ladder rungs (check_events_bucketed), and the batch's
    overflowed rung counts toward its escalations."""
    out: List[dict] = []
    for i, s in enumerate(streams):
        if alive[i] or not overflow[i]:
            r = {
                "valid?": bool(alive[i]),
                "method": method,
                "frontier_k": K,
                "escalations": 0,
            }
            if not alive[i]:
                r["failed_op_index"] = int(died[i])
        else:
            r = check_events_bucketed(
                s, model=model, k_ladder=k_ladder[1:] or k_ladder,
                device=device,
            )
            r["escalations"] = r.get("escalations", 0) + 1
        out.append(r)
    return out
