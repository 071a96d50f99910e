"""The ONE consolidated engine-state reader, a copy of
jepsen_tpu.obs.snapshot over the port's own counters.

``engine_snapshot()`` is what the CLI writes into results.json as
``engine_stats`` and what ``--stats-json`` dumps; ``reset_engine_stats()``
zeroes every section it reads, the reference's sections all.

This module imports the checker modules, so the ``obs`` package root
does NOT import it (the checker modules import ``obs.trace`` for
emission). Consumers import ``jepsen_tpu_torch.obs.snapshot``
explicitly.
"""

from __future__ import annotations

from jepsen_tpu_torch.obs import trace as _trace


def engine_snapshot() -> dict:
    """Point-in-time, lock-consistent-per-section copy of every engine
    counter surface plus the flight recorder's own stats.

    Sections (each a plain JSON-able dict):

    - ``dispatch``:  coalescing-plane stats incl. derived ratios
      (``floor_amortization``, ``double_buffer_occupancy``)
    - ``launch``:    device-launch accounting (launches, host_syncs,
      escalations, donated_buffers: always 0 in the port)
    - ``mesh``:      sharded-launch engagement, the mesh-side resilience
      view and the pod topology (sharded.mesh_stats_snapshot)
    - ``resilience``: chaos-layer retries/quarantines
    - ``checkpoint``: save/resume/replay/invalidation accounting
    - ``streaming``: incremental-tail appends and tail launches
    - ``txn_graph``: transactional dependency-graph pipeline counters
    - ``trace``:     flight-recorder meta (enabled, event counts)
    - ``perf``:      the perf plane's disclosure: the resolved knob
      ``config_hash``, whether a tuned profile is active, and where it
      was loaded from
    """
    from jepsen_tpu_torch import device
    from jepsen_tpu_torch.checker import chaos, checkpoint, dispatch
    from jepsen_tpu_torch.checker import sharded, streaming, txn_graph
    from jepsen_tpu_torch.perf import knobs as perf_knobs

    return {
        "dispatch": dispatch.dispatch_stats(),
        "launch": device.launch_stats_snapshot(),
        "mesh": sharded.mesh_stats_snapshot(),
        "resilience": chaos.resilience_snapshot(),
        "checkpoint": checkpoint.checkpoint_stats(),
        "streaming": streaming.stream_stats(),
        "txn_graph": txn_graph.txn_graph_stats(),
        "trace": _trace.trace_stats(),
        "perf": perf_knobs.perf_snapshot(),
    }


def reset_engine_stats() -> None:
    """Zero every counter surface the snapshot reads (CLI runs reset
    before each analysis so per-run numbers are per-run)."""
    from jepsen_tpu_torch import device
    from jepsen_tpu_torch.checker import checkpoint, dispatch
    from jepsen_tpu_torch.checker import sharded, streaming, txn_graph
    from jepsen_tpu_torch.checker.chaos import reset_resilience

    dispatch.reset_dispatch_stats()
    device.reset_launch_stats()
    sharded.reset_mesh_stats()
    reset_resilience()
    checkpoint.reset_checkpoint_stats()
    streaming.reset_stream_stats()
    txn_graph.reset_txn_graph_stats()
    _trace.reset()
