"""Placing key blocks on a mesh's slots and gathering their outputs (the
counterpart of jepsen_tpu.pod.slicing).

Two asymmetries separate a pod mesh from a single-process one:

- **Placement**: a process runs only its OWN slots. Every process holds
  the same host batch (deterministic by construction), and
  ``host_shard_put`` uploads only the blocks of this process's slots,
  each on its slot's stream (``device.upload``).
- **Collect**: no process can read another's outputs. ``global_view``
  is the counterpart of the reference's ``_replicator`` (its cached
  identity jit with replicated out_shardings):
  - in one process, a gather of every slot's outputs onto the caller's
    stream of slot 0's device, after that stream waits on each slot's
    stream: device to device, never through the host;
  - in a pod, ONE ``dist.all_gather`` of the verdict rows, every output
    packed into one int64 tensor, on the mesh's group (sharded.
    _group_for: NCCL only for a mesh of card slots whose ranks own
    distinct cards, else gloo). On gloo the rows are staged through the
    host first; on NCCL they stay on the card.

  Either way the check still pays exactly one counted ``_host_get``
  after it: the staging copy is not a second one (the caller's funnel
  then reads tensors already on the host), so ``syncs_per_check ==
  1.0`` holds across the pod as in the reference. The launches call
  global_view, so on gloo the staging copy makes the LAUNCH wait for
  the kernel, where the reference's ``_replicator`` is an async
  dispatch: a pod plane's trains do not overlap (ROADMAP queue 3).

``gather_rows`` and ``sum_counts`` are the row-sharded closure's two
collectives (the reference's ``all_gather`` of the row blocks and
``psum`` of the counts).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch.device import record_use, upload


def _in_pod(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def _via_host(mesh) -> bool:
    """True when the mesh's collectives run on gloo, which takes host
    tensors: the rows are staged through the host."""
    import torch.distributed as dist

    return dist.get_backend(mesh.group) != "nccl"


def host_shard_put(cols: Sequence[np.ndarray], mesh) -> List[Tuple]:
    """Upload the key-axis blocks of host columns (each padded to a
    multiple of the mesh size) to this process's slots: one tuple of
    tensors per local slot, in mesh order, each block uploaded on its
    slot's stream."""
    from jepsen_tpu_torch.checker.sharded import (
        key_block,
        local_positions,
        mesh_local_slots,
        slot_scope,
    )

    rows = cols[0].shape[0]
    out = []
    for slot, p in zip(mesh_local_slots(mesh), local_positions(mesh)):
        blk = key_block(mesh, rows, p)
        with slot_scope(slot):
            out.append(tuple(upload(np.ascontiguousarray(c[blk]),
                                    slot.device) for c in cols))
    return out


def _gather_local(parts: List[Tuple], mesh) -> Tuple:
    """The local slots' outputs, each output concatenated in mesh order
    on the caller's stream of slot 0's device."""
    from jepsen_tpu_torch.checker.sharded import caller_waits, mesh_local_slots

    slots = mesh_local_slots(mesh)
    caller_waits(slots)
    dev0 = slots[0].device
    flat = [t for p in parts for t in p]
    record_use(flat)
    return tuple(
        torch.cat([p[j].to(dev0) for p in parts])
        for j in range(len(parts[0]))
    )


def _all_gather_rows(local: torch.Tensor, mesh) -> torch.Tensor:
    """One all_gather of a [rows, ...] tensor of this process's slots'
    rows; returns the [n_slots * k, ...] tensor in mesh order (on the
    host for gloo, on the card for NCCL). Ranks may own different slot
    counts (a ragged 1-D mesh): each pads to the largest."""
    import torch.distributed as dist

    from jepsen_tpu_torch.checker.sharded import local_positions

    flat = list(mesh.devices.flat)
    k = local.shape[0] // len(local_positions(mesh))
    world = dist.get_world_size()
    owned = [[i for i, s in enumerate(flat) if s.process_index == r]
             for r in range(world)]
    most = max(len(o) for o in owned) * k
    if _via_host(mesh):
        # planelint: disable=JT104 reason=gloo takes host tensors, so a collective's operand is staged here; the reference's collective stays on device and counts no sync, so counting this one would break LAUNCH_STATS parity (an NCCL group skips it)
        local = local.cpu()
    pad = torch.zeros((most,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    pad[:local.shape[0]] = local
    got = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(got, pad, group=mesh.group)
    out = torch.empty((len(flat) * k,) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    for r, positions in enumerate(owned):
        for i, p in enumerate(positions):
            out[p * k:(p + 1) * k] = got[r][i * k:(i + 1) * k]
    return out


def global_view(parts: List[Tuple], mesh) -> Tuple:
    """Every slot's outputs as full tensors in mesh order (rows [i*k,
    (i+1)*k) from slot i): a device-side gather in one process, ONE
    all_gather of the packed verdict rows in a pod. Call it right
    before the ``_host_get`` funnel; it adds no counted sync."""
    local = _gather_local(parts, mesh)
    if not _in_pod(mesh):
        return local
    rows = local[0].shape[0]
    widths = [int(np.prod(t.shape[1:])) for t in local]
    packed = torch.cat([t.reshape(rows, -1).to(torch.int64)
                        for t in local], dim=1)
    full = _all_gather_rows(packed, mesh)
    out, c = [], 0
    for t, w in zip(local, widths):
        out.append(full[:, c:c + w].to(t.dtype).reshape(
            (full.shape[0],) + tuple(t.shape[1:])))
        c += w
    return tuple(out)


def gather_rows(blks: List[torch.Tensor], mesh) -> torch.Tensor:
    """The full [N, N] matrix from every slot's row block: a peer copy
    onto slot 0's device in one process, a dist.all_gather in a pod."""
    local = _gather_local([(b,) for b in blks], mesh)[0]
    if not _in_pod(mesh):
        return local
    dev = local.device
    return _all_gather_rows(local, mesh).to(dev)


def sum_counts(counts: List[torch.Tensor], mesh) -> torch.Tensor:
    """The psum of per-slot count vectors: a sum after the local gather,
    then an all_reduce over the pod (on the host for gloo)."""
    local = _gather_local([(c[None],) for c in counts], mesh)[0].sum(0)
    if not _in_pod(mesh):
        return local
    import torch.distributed as dist

    if _via_host(mesh):
        # planelint: disable=JT104 reason=gloo takes host tensors, so the all_reduce's operand is staged here; the reference's psum stays on device and counts no sync, so counting this one would break LAUNCH_STATS parity (an NCCL group skips it)
        local = local.cpu()
    dist.all_reduce(local, group=mesh.group)
    return local
