"""Pod topology: the ``torch.distributed.init_process_group`` seam, a
copy of jepsen_tpu.pod.topology over torch.distributed.

One function, ``init_pod``, owns every process-global decision a
multi-process mesh needs:

- the (coordinator, num_processes, process_id) triple comes from
  explicit config, CLI flags, or the ``JEPSEN_TPU_POD_*`` env seam (the
  reference's names: one operator seam for both packages);
- the default process group is gloo, over TCP to the coordinator
  (``tcp://HOST:PORT``, rank 0 serves it). Every host-side handshake
  (the slot table, the clock, any barrier) runs on it, so none of them
  needs a CUDA tensor;
- an NCCL group for the verdict gathers is added only when every rank
  owns cards no other rank owns. NCCL refuses two ranks on one card
  ("Duplicate GPU detected"), so ranks that share a card gather on gloo.

Each rank publishes its local slot counts (``sharded.local_slot_count``:
the port's ``JEPSEN_TPU_TORCH_LOCAL_DEVICES`` seam, else one slot per
card, one for the CPU), so every rank sees the same global slot table
without another exchange. ``topology_snapshot()`` is the read side:
hosts, local against global slots, backend; it is folded into
``sharded.mesh_stats_snapshot()`` and emitted as a ``pod_init`` span on
the flight recorder at init time.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

from jepsen_tpu_torch.obs import trace as obs_trace

#: env seam: set on every pod child by launcher.pod_env (and readable by
#: operators driving real pods). CLI flags override env.
ENV_COORDINATOR = "JEPSEN_TPU_POD_COORDINATOR"
ENV_NPROCS = "JEPSEN_TPU_POD_NPROCS"
ENV_PROCESS_ID = "JEPSEN_TPU_POD_PROCESS_ID"


@dataclass(frozen=True)
class PodConfig:
    """The (coordinator, num_processes, process_id) triple
    init_process_group needs."""

    coordinator: str
    num_processes: int
    process_id: int

    @classmethod
    def from_env(cls, env=None) -> Optional["PodConfig"]:
        """Read the JEPSEN_TPU_POD_* seam; None when no coordinator is
        set (the ordinary single-process case)."""
        env = os.environ if env is None else env
        addr = env.get(ENV_COORDINATOR)
        if not addr:
            return None
        return cls(
            coordinator=addr,
            num_processes=int(env.get(ENV_NPROCS, "1")),
            process_id=int(env.get(ENV_PROCESS_ID, "0")),
        )


#: what init_pod decided, for the read side. Locked like every stats
#: surface; "initialized" flips exactly once per process. "slots" is
#: the rank-ordered table every rank published at init ({"cpu": n,
#: "cuda": n, "host": name, "cards": [...]}); "collective" names the
#: backend the verdict gathers run on ("gloo" or "nccl").
POD_STATS = {
    "initialized": False,
    "coordinator": None,
    "n_hosts_configured": 1,
    "process_id_configured": 0,
    "clock": None,
    "slots": None,
    "collective": None,
}

_pod_stats_lock = threading.Lock()
_init_lock = threading.Lock()
#: claimed under _init_lock by the thread doing the (slow) coordinator
#: handshake, so the handshake itself runs with no lock held
_init_pending = [False]
#: the NCCL group of the verdict gathers, when every rank owns its cards
_NCCL_GROUP = [None]


def _local_slot_table() -> dict:
    """This rank's row of the slot table: its local slot counts for the
    CPU and the card, and the identities of its cards."""
    import torch

    from jepsen_tpu_torch.checker.sharded import local_slot_count

    row = {"host": socket.gethostname(), "cpu": local_slot_count("cpu"),
           "cuda": 0, "cards": []}
    if torch.cuda.is_available():
        row["cuda"] = local_slot_count("cuda")
        for i in range(torch.cuda.device_count()):
            uuid = getattr(torch.cuda.get_device_properties(i), "uuid", i)
            row["cards"].append(f"{row['host']}/{uuid}")
    return row


def init_pod(config: Optional[PodConfig] = None,
             timeout_s: float = 60.0) -> dict:
    """Join (or skip joining) a pod; returns topology_snapshot().

    config=None reads the JEPSEN_TPU_POD_* env seam; no coordinator
    there (or num_processes < 2) means single-process: nothing is
    touched. Idempotent: a second call in a process returns the
    snapshot without re-initializing. A configured pod that cannot be
    joined raises: it never drops to one process silently.
    """
    with _init_lock:
        if POD_STATS["initialized"] or _init_pending[0]:
            return topology_snapshot()
        cfg = config if config is not None else PodConfig.from_env()
        if cfg is None or cfg.num_processes < 2:
            return topology_snapshot()
        _init_pending[0] = True
    # The handshake (and its span) runs with no lock held: the
    # coordinator connect can block for timeout_s, and span emission
    # takes the recorder's ring-registry lock.
    try:
        from datetime import timedelta

        import torch.distributed as dist

        with obs_trace.span(
            "pod_init", kind="pod",
            coordinator=cfg.coordinator,
            n_hosts=cfg.num_processes,
            process_id=cfg.process_id,
        ):
            dist.init_process_group(
                backend="gloo",
                init_method=f"tcp://{cfg.coordinator}",
                world_size=cfg.num_processes,
                rank=cfg.process_id,
                timeout=timedelta(seconds=timeout_s),
            )
        clock = _clock_handshake(cfg.process_id)
        table = [None] * cfg.num_processes
        dist.all_gather_object(table, _local_slot_table())
        cards = [c for row in table for c in row["cards"]]
        # NCCL only when every rank owns cards and no card is shared
        nccl = (all(row["cuda"] and row["cards"] for row in table)
                and len(cards) == len(set(cards)))
        if nccl:
            _NCCL_GROUP[0] = dist.new_group(backend="nccl")
        with _pod_stats_lock:
            POD_STATS["initialized"] = True
            POD_STATS["coordinator"] = cfg.coordinator
            POD_STATS["n_hosts_configured"] = cfg.num_processes
            POD_STATS["process_id_configured"] = cfg.process_id
            POD_STATS["clock"] = clock
            POD_STATS["slots"] = table
            POD_STATS["collective"] = "nccl" if nccl else "gloo"
    finally:
        with _init_lock:
            _init_pending[0] = False
    return topology_snapshot()


def _clock_handshake(process_id: int) -> Optional[dict]:
    """Exchange perf_counter_ns anchors right after the rendezvous; runs
    in init_pod's lock-free region (it is a collective, on gloo).

    Every member all-gathers its monotonic anchor, taken as close to
    the rendezvous exit as possible, as one int64 (PyTorch keeps int64,
    so the reference's hi/lo split is not needed). ``offset_ns`` rebases
    this member onto member 0's clock domain; ``skew_bound_ns`` is this
    member's own all-gather window (enter to exit), an upper bound on
    how misaligned the anchors can be. None when the collective cannot
    run: tracing then keeps unaligned per-member timelines.
    """
    try:
        import torch
        import torch.distributed as dist

        t_enter = time.perf_counter_ns()
        mine = torch.tensor([t_enter], dtype=torch.int64)
        anchors = [torch.zeros(1, dtype=torch.int64)
                   for _ in range(dist.get_world_size())]
        dist.all_gather(anchors, mine)
        t_exit = time.perf_counter_ns()
        anchors_ns = [int(a[0]) for a in anchors]
        return {
            "anchor_ns": t_enter,
            "offset_ns": anchors_ns[process_id] - anchors_ns[0],
            "skew_bound_ns": t_exit - t_enter,
            "anchors_ns": anchors_ns,
        }
    except Exception:  # pragma: no cover - transport-dependent
        return None


def pod_clock() -> Optional[dict]:
    """The clock-alignment record from init_pod's handshake (None in a
    single process or when the handshake could not run)."""
    with _pod_stats_lock:
        clk = POD_STATS["clock"]
        return dict(clk) if clk else None


def slot_table() -> Optional[list]:
    """The rank-ordered slot table init_pod gathered (None off-pod)."""
    with _pod_stats_lock:
        t = POD_STATS["slots"]
        return [dict(r) for r in t] if t else None


def collective_group():
    """The NCCL group init_pod made when every rank owns distinct cards,
    else None. A mesh of card slots gathers on it; every other mesh on
    the default gloo group (sharded._group_for)."""
    return _NCCL_GROUP[0]


def collective_backend() -> Optional[str]:
    with _pod_stats_lock:
        return POD_STATS["collective"]


def process_index() -> int:
    """This process's rank in the pod (0 off-pod)."""
    if not is_multiprocess():
        return 0
    import torch.distributed as dist

    return int(dist.get_rank())


def _backend() -> str:
    from jepsen_tpu_torch.checker.sharded import mesh_policy

    pinned = mesh_policy()["backend"]
    if pinned:
        return "cpu" if pinned == "cpu" else "cuda"
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def topology_snapshot() -> dict:
    """Hosts, local against global slots, and the backend ("cuda" or
    "cpu"), as this process sees them. Never imports torch on its own:
    stdlib-only consumers (the service door) read the configured block
    for free."""
    with _pod_stats_lock:
        out = {
            "initialized": POD_STATS["initialized"],
            "coordinator": POD_STATS["coordinator"],
            "n_hosts": 1,
            "process_index": 0,
            "local_devices": 0,
            "global_devices": 0,
            "backend": None,
        }
        table = POD_STATS["slots"]
    if "torch" not in sys.modules:
        return out
    try:
        from jepsen_tpu_torch.checker.sharded import local_slot_count

        backend = _backend()
        out["backend"] = backend
        out["local_devices"] = local_slot_count(backend)
        out["global_devices"] = out["local_devices"]
        if table is not None and is_multiprocess():
            out["n_hosts"] = len(table)
            out["process_index"] = process_index()
            out["global_devices"] = sum(int(r[backend]) for r in table)
    except Exception:  # no device answer yet: the configured block
        pass
    return out


def is_multiprocess() -> bool:
    """True inside an initialized pod (more than one process). Safe
    before init and without torch imported: False."""
    with _pod_stats_lock:
        if not POD_STATS["initialized"]:
            return False
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def host_of(slot) -> int:
    """The failure-domain id of a slot: its owning process index."""
    return int(getattr(slot, "process_index", 0))
