"""The Adya G2 workload's checker, from jepsen_tpu.workloads.adya.

Only the checker is here: the workload's generator (predicate-guarded
insert pairs, adya.clj:12-60) and its in-memory client are harness,
which the port does not have yet. ``_KVG2Checker`` is what the CLI's
``g2`` workload checks a stored run with.
"""

from __future__ import annotations

from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.adya import G2Checker


class _KVG2Checker:
    """G2Checker over KV-wrapped values: unwraps (key, (a, b)) pairs
    into the flat (key, ids) shape the checker counts."""

    def __init__(self, device=None):
        self.device = device

    def check(self, test, history, opts=None):
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        flat = [
            o.with_(value=(o.value.key, o.value.value))
            for o in history.ops
            if isinstance(o.value, independent.KV)
        ]
        return G2Checker(device=self.device).check(
            test, History(flat), opts)
