"""Kernel A's work count reads the history, not the implementation:
the same count from the benchmark's own encoding and from the
program's return steps under two segment plans and two paddings."""

import random

import numpy as np
import pytest

from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.events import events_to_steps, history_to_events
from jepsen_tpu_torch.history.history import History
from portbench.metrics import _kernel_a as ka


def _plain(h):
    return [{k: getattr(o, k) for k in ("type", "f", "value", "process")}
            for o in h.ops]


def _history(seed, n_ops=4000, p_crash=0.002):
    """A register history whose crashes widen its window as it goes
    (seeds 1, 2 and 3: a peak of 14-16)."""
    return _plain(sim.gen_register_history(
        random.Random(seed), n_ops=n_ops, n_procs=10, n_values=5,
        p_crash=p_crash))


def _steps_count(segments, rows, n_events):
    """The count from the program's packed view: (open, fresh) read off
    each live row of each segment, whatever its width."""
    pairs = []
    for st in segments:
        for i in range(len(st)):
            if not st.live[i]:
                continue
            fresh = int(np.unpackbits(
                st.fresh[i].view(np.uint8)).sum())
            pairs.append((int(st.occ[i].sum()), fresh))
    return ka.count_steps(pairs, rows, n_events)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_count_is_the_same_under_any_plan(seed):
    ops = _history(seed)
    want = ka.count_history(ops)
    ev = history_to_events(History(ops), model="cas-register")
    assert 14 <= ev.window <= 16
    rows = len(ev.value_codes) + 1
    for W in (16, 19):
        steps = events_to_steps(ev, W=W)
        plans = [bs.plan_segments(steps, min_len=m) for m in (64, 1024)]
        assert plans[0] != plans[1]
        for plan, pad in zip(plans, (0, 37)):
            segs = [bs._slice_steps(steps, a, b, w) for a, b, w in plan]
            segs[-1] = segs[-1].padded(len(segs[-1]) + pad)
            got = _steps_count(segs, rows, len(ev))
            assert got == want


def test_count_stops_at_the_failing_op():
    ops = _history(4, n_ops=2000)
    idx = next(i for i in range(len(ops) // 2, len(ops))
               if ops[i]["type"] == "ok" and ops[i]["f"] == "read"
               and ops[i]["value"] is not None)
    bad = list(ops)
    bad[idx] = dict(ops[idx], value=None)
    full = ka.count_history(bad)
    part = ka.count_history(bad, upto=idx)
    assert 0 < part[0] < full[0] and part[1] < full[1]


def test_step_ops_grow_with_the_open_window():
    assert ka.step_ops(6, 18, 1) == 2 * 6 * (1 << 18) // 32
    assert ka.step_ops(6, 2, 0) == 1
