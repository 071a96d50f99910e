"""Multi-process pods and fleets of the port (the counterpart of
jepsen_tpu.pod):

- ``topology``     — the ``torch.distributed.init_process_group`` seam
  (env or CLI driven, gloo over TCP) plus ``topology_snapshot()``
  feeding the mesh stats and the flight recorder (``pod_init`` spans).
- ``launcher``     — ``launch_pod``: a REAL N-process pod on localhost;
  and the checker-daemon fleet members' spawner.
- ``slicing``      — placing key blocks on a mesh's slots and gathering
  their outputs: a device-side gather in one process, one all_gather of
  the verdict rows in a pod, before the one counted host sync.
- ``faultdomains`` — host-level failure domains: ``host:<i>`` labels
  eject a dead process's whole slice; degradation runs pod ->
  host-quarantined pod -> local host mesh -> single device -> oracle.
"""
