"""Host-level failure domains: a dead process ejects its whole slice (a
copy of jepsen_tpu.pod.faultdomains over the port's slots).

Per-slot quarantine is the wrong granularity for a pod: when a HOST
dies, every slot it owns goes with it, and a pod collective that
includes any of them wedges. This module teaches the quarantine ladder
host-scoped ``host:<i>`` labels (chaos.HOST_PREFIX) and maps hosts to
their slot slices, so ``sharded.mesh_without`` ejects a slice in one
step.

Failure domains come from two places, so the same machinery is
testable without killing live pod members (a killed gloo member wedges
the survivors' collectives; the cure is re-sharding BEFORE the next
launch, which is what these labels drive):

- a real pod groups slots by their owning process;
- a single-process mesh with a ``hosts`` axis treats each row along
  that axis as a virtual host domain (a 2 x 4 virtual mesh models a
  two-host pod one level down, as the launcher models one level up).

Degradation ladder with domains (dispatch drives it): full pod ->
host-quarantined pod (survivor slices re-shard) -> local host mesh ->
single device -> host oracle.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from jepsen_tpu_torch.checker import chaos

HOST_PREFIX = chaos.HOST_PREFIX


def host_label(host_id: int) -> str:
    """The quarantine-ledger label of a whole host domain."""
    return f"{HOST_PREFIX}{int(host_id)}"


def host_domains(mesh) -> Dict[int, Tuple[str, ...]]:
    """host id -> slot labels of its slice, for a given mesh.

    Multiprocess: group by owning process (the real failure domain).
    Single-process with a "hosts" axis: rows along that axis (virtual
    domains). Otherwise one domain: per-slot quarantine already covers
    it."""
    if mesh is None:
        return {}
    from jepsen_tpu_torch.pod.topology import host_of, is_multiprocess

    devs = mesh.devices
    if is_multiprocess():
        by_host: Dict[int, list] = {}
        for d in devs.flat:
            by_host.setdefault(host_of(d), []).append(str(d))
        return {h: tuple(v) for h, v in by_host.items()}
    if "hosts" in mesh.axis_names:
        ax = list(mesh.axis_names).index("hosts")
        rows = np.moveaxis(devs, ax, 0)
        return {
            i: tuple(str(d) for d in rows[i].flat)
            for i in range(rows.shape[0])
        }
    return {0: tuple(str(d) for d in devs.flat)}


def host_of_label(mesh, device_label: str) -> Optional[int]:
    """Which host domain a slot label belongs to on this mesh."""
    for h, labels in host_domains(mesh).items():
        if device_label in labels:
            return h
    return None


def expand_host_labels(mesh, labels: Sequence[str]) -> Set[str]:
    """Expand ``host:<i>`` labels into that host's slot labels on
    ``mesh`` (mesh_without's ejection set); plain slot labels pass
    through."""
    dead: Set[str] = set()
    domains: Optional[Dict[int, Tuple[str, ...]]] = None
    for lab in labels:
        if chaos.is_host_label(lab):
            if domains is None:
                domains = host_domains(mesh)
            try:
                h = int(lab[len(HOST_PREFIX):])
            except ValueError:
                continue
            dead.update(domains.get(h, ()))
        else:
            dead.add(lab)
    return dead


def note_host_death(host_id: int, mesh=None) -> Tuple[str, ...]:
    """Declare a whole host dead: its ``host:<i>`` label quarantines at
    once (a ledger row of its own) and every slot of its slice
    quarantines with it, so default_mesh, mesh_without and the plane's
    sticky shrink all re-shard without the slice. Returns the ejected
    slot labels. Without a mesh the slice is the pod's global slots of
    that process (none off-pod)."""
    from jepsen_tpu_torch.checker import sharded
    from jepsen_tpu_torch.pod.topology import host_of

    chaos.quarantine_label(host_label(host_id))
    if mesh is not None:
        ejected = host_domains(mesh).get(int(host_id), ())
    else:
        try:
            ejected = tuple(
                str(d) for d in sharded.visible_slots()
                if host_of(d) == int(host_id)
            )
        except Exception:  # noqa: BLE001 - no slots visible: no slice
            ejected = ()
    for lab in ejected:
        chaos.quarantine_label(lab)
        sharded.note_quarantine(lab)
    return ejected


def escalate_device_to_host(device_label: str, mesh) -> Optional[int]:
    """The dispatch plane's domain policy: a quarantined slot on a mesh
    spanning more than one host domain condemns its WHOLE domain (from
    across hosts a dead card and a dead host look the same, and a
    half-dead slice wedges collectives). Returns the ejected host id,
    or None when the mesh has no multi-host structure."""
    domains = host_domains(mesh)
    if len(domains) < 2:
        return None
    for h, labels in domains.items():
        if device_label in labels:
            note_host_death(h, mesh)
            return h
    return None


def degradation_ladder(mesh) -> List[str]:
    """The named rungs a pod plane degrades through, top first. The
    dispatch ladder implements the transitions; this is the doc and
    test surface naming them."""
    rungs = []
    if mesh is not None and len(host_domains(mesh)) > 1:
        rungs += ["pod", "host-quarantined pod", "local host mesh"]
    elif mesh is not None:
        rungs += ["host mesh"]
    rungs += ["single device", "oracle"]
    return rungs


def local_host_mesh(device=None):
    """A mesh over THIS process's healthy local slots only: the ladder
    rung below a host-quarantined pod (cross-host collectives no longer
    trusted, local slots still good). None below 2 local slots."""
    from jepsen_tpu_torch.checker.sharded import _mesh_over, local_slots

    devs = [
        d for d in local_slots(device)
        if not chaos.is_quarantined(str(d))
    ]
    if len(devs) < 2:
        return None
    return _mesh_over(tuple(devs))
