"""The port's exact bitset scan (jepsen_tpu_torch.checker.wgl_bitset)
against the JAX package's, bit for bit.

- bitset_scan_plain, the plain PyTorch version of the CUDA kernel,
  against jepsen_tpu's Pallas kernel (_bitset_scan) in interpret mode on
  the same packed inputs: the whole out row and fr_out, both tiers;
- the segmented check against the reference's segmented launch/collect
  on a plan that widens and narrows: verdict, died op index and the
  death frontier,
  and the exact re-run from segment 0 (the reference's regression case);
- the word-level relabelings on mask bit 31 (the sign bit).

The CUDA kernel against the plain version: tests/test_torch_cuda.py.

Tolerance: exact equality (integer and bit arithmetic)."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.history.history import History
from jepsen_tpu.history.ops import info_op, invoke_op, ok_op
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.checker.wgl_oracle import check_events
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one intra-op thread keeps
    torch's pool from oversubscribing the cores under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: every scan input pads to this many steps, so the reference compiles
#: once per (W, S, tier)
N_STEPS = 64

#: (W, S) -> {kind: history params (seed, n_ops, n_procs, p_crash)}
SHAPES = {
    (12, 8): {"valid": (40, 50, 5, 0.0), "invalid": (41, 50, 5, 0.0),
              "crashy": (35, 50, 4, 0.15)},
    (16, 16): {"valid": (42, 60, 12, 0.0), "invalid": (43, 60, 12, 0.0),
               "crashy": (44, 60, 8, 0.2)},
}


def _steps(W, kind, params):
    seed, n_ops, n_procs, p_crash = params
    h = gen_register_history(random.Random(seed), n_ops=n_ops,
                             n_procs=n_procs, n_values=5 if W > 12 else 3,
                             p_crash=p_crash)
    if kind == "invalid":
        h = corrupt_history(h, random.Random(seed),
                            n_values=5 if W > 12 else 3)
    ev = r_ev.history_to_events(h)
    assert ev.window <= W
    st = r_ev.events_to_steps(ev, W=W)
    assert len(st) <= N_STEPS
    return st.padded(N_STEPS)


def _reference_scan(st, S, W, exact):
    win, meta = r_bs.pack_steps(st)
    fr0 = r_bs.init_frontier(st.init_state, S, W)[None]
    out, fr = r_bs._bitset_scan(
        win[None], meta[None], fr0, model_name="cas-register", S=S, W=W,
        interpret=True, exact=exact)
    return np.asarray(out), np.asarray(fr)


def _plain_scan(st, S, W, exact):
    tst = from_reference(st)
    win, meta = t_bs.pack_steps(tst)
    fr0 = t_bs.init_frontier(tst.init_state, S, W)[None]
    out, fr = t_bs.bitset_scan(
        torch.from_numpy(win[None]), torch.from_numpy(meta[None]),
        torch.from_numpy(fr0), "cas-register", S, W, exact=exact)
    return out.numpy(), fr.numpy()


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
@pytest.mark.parametrize("kind", ["valid", "invalid", "crashy"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=["W12S8", "W16S16"])
def test_plain_scan_matches_reference_kernel(shape, kind, exact):
    W, S = shape
    st = _steps(W, kind, SHAPES[shape][kind])
    out_r, fr_r = _reference_scan(st, S, W, exact)
    out_t, fr_t = _plain_scan(st, S, W, exact)
    assert out_t.dtype == out_r.dtype and fr_t.dtype == fr_r.dtype
    assert np.array_equal(out_t, out_r), (out_t, out_r)
    assert np.array_equal(fr_t, fr_r)
    if kind == "valid":
        assert out_t[0, 0, 0] == 1
    if kind == "invalid" and exact:
        assert out_t[0, 0, 0] == 0  # the corruption kills this one


def test_padded_steps_are_noops():
    """live=0 padding changes nothing, however much of it there is."""
    st = _steps(12, "crashy", SHAPES[(12, 8)]["crashy"])
    a = _plain_scan(st, 8, 12, True)
    b = _plain_scan(st.padded(4 * N_STEPS), 8, 12, True)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_sign_bit_relabelings():
    """Mask bit 31 is a real mask bit: the RETURN filter's in-word shift
    is logical (torch's >> on int32 is arithmetic), and adding slot
    bits shifts into the sign bit with the reference's wraparound."""
    rng = np.random.default_rng(1)
    words = rng.integers(-2**31, 2**31, (8, 128), dtype=np.int64).astype(
        np.int32)
    words[0, :4] = [-2**31, -1, 0x7FFFFFFF, 1]
    fr = torch.from_numpy(words)
    u = words.view(np.uint32)
    for r in range(5):
        c1 = np.uint32(t_bs._C1[r] & 0xFFFFFFFF)
        want = ((u & c1) >> np.uint32(1 << r)).view(np.int32)
        assert np.array_equal(t_bs._remove_bit(fr, r).numpy(), want), r
        keep = np.uint32(~t_bs._C1[r] & 0xFFFFFFFF)
        want = ((u[0] & keep) << np.uint32(1 << r)).view(np.int32)
        assert np.array_equal(t_bs._add_bit(fr[0], r).numpy(), want), r
    for r in range(5, 12):
        s = 1 << (r - 5)
        got = t_bs._remove_bit(fr, r).numpy()
        lanes = np.arange(128)
        hi = (lanes >> (r - 5)) & 1
        want = np.where(hi[None] == 0, np.roll(np.where(hi == 1, words, 0),
                                                -s, axis=1), 0)
        assert np.array_equal(got, want), r
        got = t_bs._add_bit(fr[0], r).numpy()
        want = np.roll(np.where(hi == 0, words[0], 0), s)
        assert np.array_equal(got, want), r


def _widen_then_narrow(stale: bool):
    """W12 prefix, a 14-wide middle (fourteen concurrent writes), and a
    W12 suffix: plan_segments(min_len=1) widens and then narrows. With
    stale=True the last read returns an overwritten value and dies in
    the narrowed segment."""
    ops = []
    for _ in range(16):
        ops += [invoke_op(0, "write", 1), ok_op(0, "write", 1)]
    for p in range(1, 15):
        ops.append(invoke_op(p, "write", 1 + p % 2))
    for p in range(1, 15):
        ops.append(ok_op(p, "write", 1 + p % 2))
    for _ in range(20):
        ops += [invoke_op(0, "write", 3), ok_op(0, "write", 3)]
    ops += [invoke_op(0, "read"), ok_op(0, "read", 2 if stale else 3)]
    return r_ev.history_to_events(History(ops))


def _segmented_pair(ev, min_len, reference=True):
    """(reference steps, port steps, reference verdict, port verdict).
    The reference runs its segmented launch/collect on the exact tier
    (the tier the port's fast-tier death escalates to; each reference
    chain plan costs a compile in interpret mode); reference=False
    takes the verdict from the port's Python oracle instead."""
    W, S = r_bs.plan(r_bs.get_model("cas-register"), ev.window,
                     len(ev.value_codes))
    rst = r_ev.events_to_steps(ev, W=W)
    tst = t_ev.events_to_steps(from_reference(ev), W=W)
    if reference:
        want = r_bs.collect_steps_bitset_segmented(
            rst, r_bs.launch_steps_bitset_segmented(
                rst, S=S, interpret=True, exact=True, min_len=min_len))
    else:
        valid, st = check_events(from_reference(ev), return_stats=True)
        died = st["failed_op_index"]
        want = (valid, False, -1 if died is None else died)
    reset_launch_stats()
    got = t_bs.check_steps_bitset_segmented(
        tst, S=S, min_len=min_len, device="cpu")
    return rst, tst, want, got


@pytest.mark.parametrize("stale", [False, True], ids=["alive", "dies"])
def test_segmented_check_widens_and_narrows(stale):
    ev = _widen_then_narrow(stale)
    rst, tst, want, got = _segmented_pair(ev, 1, reference=stale)
    segs = t_bs.plan_segments(tst, 1)
    ws = [w for _, _, w in segs]
    assert ws == [w for _, _, w in r_bs.plan_segments(rst, 1)]
    assert max(ws) > ws[0] and ws[-1] < max(ws)  # widens, then narrows
    assert got == want
    assert got[0] is (not stale)
    fr_t = getattr(tst, "_death_frontier", None)
    assert (fr_t is None) is (not stale)
    if stale:
        assert np.array_equal(fr_t, rst._death_frontier)
    stats = launch_stats_snapshot()
    assert stats["host_syncs"] == (2 if stale else 1)
    assert stats["escalations"] == (1 if stale else 0)


def test_single_segment_plan_pads_like_the_reference():
    h = gen_register_history(random.Random(45), n_ops=40, n_procs=4)
    h = corrupt_history(h, random.Random(45))
    ev = r_ev.history_to_events(h)
    rst, tst, want, got = _segmented_pair(ev, None)
    assert len(t_bs.plan_segments(tst)) == 1
    assert got == want and got[0] is False
    assert np.array_equal(tst._death_frontier, rst._death_frontier)


def test_segmented_escalation_restarts_from_segment_zero():
    """The reference's regression case (tests/test_bitset.py): a fast
    tier death in a later segment is provisional; the exact tier re-runs
    from segment 0 with a fresh frontier and the history is valid."""
    ops = []
    for _ in range(13):
        ops += [invoke_op(0, "write", 1), ok_op(0, "write", 1)]
    ops.append(invoke_op(4, "write", 5))     # d -> slot 0
    ops.append(invoke_op(3, "cas", [3, 4]))  # c -> slot 1
    ops.append(invoke_op(2, "cas", [2, 3]))  # b -> slot 2
    ops.append(invoke_op(1, "cas", [1, 2]))  # a -> slot 3
    ops.append(ok_op(4, "write", 5))
    ops.append(ok_op(1, "cas", [1, 2]))
    ops.append(ok_op(2, "cas", [2, 3]))
    for p in range(5, 17):
        ops.append(invoke_op(p, "cas", [8, 9]))
        ops.append(info_op(p, "cas", [8, 9]))
    ops.append(ok_op(3, "cas", [3, 4]))
    ev = r_ev.history_to_events(History(ops))
    W, S = r_bs.plan(r_bs.get_model("cas-register"), ev.window,
                     len(ev.value_codes))
    tst = t_ev.events_to_steps(from_reference(ev), W=W)
    reset_launch_stats()
    outs, plan = t_bs.launch_steps_bitset_segmented(
        tst, S=S, min_len=1, device="cpu")
    assert len(plan[0]) >= 2
    fast = [t_bs._out_to_verdicts(o.numpy())[0] for o in outs]
    assert fast[0][0] is True and fast[-1][0] is False
    got = t_bs.collect_steps_bitset_segmented(tst, (outs, plan))
    assert check_events(from_reference(ev)) is True
    assert got == (True, False, -1)
    stats = launch_stats_snapshot()
    assert stats["escalations"] == 1 and stats["launches"] == 2
