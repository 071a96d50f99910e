"""The port's durable checks (jepsen_tpu_torch.checker.checkpoint, the
checkpointed group scan in wgl_bitset.py and the plane's durable
routing) against the JAX package's, on the CPU.

Every case of tests/test_checkpoint.py but the service and mesh ones
runs on both packages: the reference with interpret=True, race=False
(its plane DispatchPlane(interpret=True, mesh=False, race=False)), the
port with device="cpu", each on histories built from the same recipe
(burst_history) in its own package. Compared: the verdict tuple, the
death frontier, the checker's verdict fields (method mapped tpu-* ->
gpu-*), the sink's summary (its path aside) and the deltas of
CHECKPOINT_STATS (overhead_s aside, a clock reading), LAUNCH_STATS and
DISPATCH_STATS (the keys both have). steps_content_hash is pinned equal
to the reference's on steps carried across by convert.from_reference,
and a checkpoint file written by either package resumes in the other.

Both packages run with the small_w seam (W buckets 4 and 5 prepended),
as the reference's own tests do, so the interpret-mode kernels compile
few shapes. Tolerance: exact equality."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import checkpoint as r_cp
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import linearizable as r_lin
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.history import ops as r_ops

from jepsen_tpu_torch import device as t_dev
from jepsen_tpu_torch.checker import checkpoint as t_cp
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import linearizable as t_lin
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History as THistory

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_w(monkeypatch):
    """Narrow W buckets in BOTH packages, so the burst recipe segments
    at W4/W5 (the reference test's speed seam)."""
    monkeypatch.setattr(r_bs, "W_BUCKETS", (4, 5) + r_bs.W_BUCKETS)
    monkeypatch.setattr(t_bs, "W_BUCKETS", (4, 5) + t_bs.W_BUCKETS)


def burst_ops(ops, rounds=2, pairs=30, bad_tail=False, nburst=5):
    """tests/test_checkpoint.py's recipe, built with a package's op
    constructors: `pairs` sequential write pairs on process 0 (window
    1), then an nburst-process concurrent write burst, per round;
    bad_tail appends a read of a never-written value."""
    out = []
    for _ in range(rounds):
        for i in range(pairs):
            out.append(ops.invoke_op(0, "write", i % 3))
            out.append(ops.ok_op(0, "write", i % 3))
        for p in range(nburst):
            out.append(ops.invoke_op(p, "write", p % 3))
        for p in range(nburst):
            out.append(ops.ok_op(p, "write", p % 3))
    if bad_tail:
        out.append(ops.invoke_op(0, "read"))
        out.append(ops.ok_op(0, "read", 7))
    return out


def histories(**kw):
    """(reference History, port History) of one recipe."""
    return RHistory(burst_ops(r_ops, **kw)), THistory(burst_ops(t_ops, **kw))


def steps_of(hr, ht):
    evr = r_ev.history_to_events(hr, model="cas-register")
    evt = t_ev.history_to_events(ht, model="cas-register")
    return (r_ev.events_to_steps(evr, W=evr.window),
            t_ev.events_to_steps(evt, W=evt.window))


def run_ref(steps, sink):
    return r_bs.check_steps_bitset_segmented(
        steps, model="cas-register", S=8, interpret=True, checkpoint=sink)


def run_port(steps, sink):
    return t_bs.check_steps_bitset_segmented(
        steps, model="cas-register", S=8, device="cpu", checkpoint=sink)


def reset_all():
    r_cp.reset_checkpoint_stats()
    t_cp.reset_checkpoint_stats()
    r_bs.reset_launch_stats()
    t_dev.reset_launch_stats()
    r_dp.reset_dispatch_stats()
    t_dp.reset_dispatch_stats()


def stats():
    """(reference, port) deltas since reset_all(), on the keys both
    packages count."""
    def ck(d):
        return {k: v for k, v in d.items() if k != "overhead_s"}

    r_l, t_l = r_bs.launch_stats_snapshot(), t_dev.launch_stats_snapshot()
    r_d, t_d = dict(r_dp.DISPATCH_STATS), dict(t_dp.DISPATCH_STATS)
    common = sorted((set(r_d) & set(t_d)) - {"coalesce_wait_us"})
    return (
        (ck(r_cp.checkpoint_stats()), {k: r_l[k] for k in t_l},
         {k: r_d[k] for k in common}),
        (ck(t_cp.checkpoint_stats()), t_l, {k: t_d[k] for k in common}),
    )


def same_stats():
    r, t = stats()
    assert r == t, (r, t)
    return t


def summary(sink):
    return {k: v for k, v in sink.summary().items() if k != "path"}


def sinks(tmp_path, tag, **kw):
    return (r_cp.CheckpointSink(str(tmp_path / "ref" / tag), **kw),
            t_cp.CheckpointSink(str(tmp_path / "port" / tag), **kw))


class Die(Exception):
    """In-process crash nemesis, raised from after_save."""


def die_after(n):
    def hook(sink, st):
        if st.get("verdict") is None and st["segments_done"] >= n:
            raise Die()
    return hook


def both(tmp_path, tag, hist_kw, **sink_kw):
    """The same checkpointed check on both packages in sibling dirs:
    (verdicts, sinks, steps)."""
    sr, st = steps_of(*histories(**hist_kw))
    kr, kt = sinks(tmp_path, tag, seg_min_len=1, **sink_kw)
    return (run_ref(sr, kr), run_port(st, kt)), (kr, kt), (sr, st)


# -- the plan and the content hash ------------------------------------------


def test_plan_and_content_hash_equal_the_reference(small_w):
    """Same plan, and steps_content_hash is the reference's digest on
    steps carried across (so one file format serves both packages); it
    binds model, S and plan."""
    sr, st = steps_of(*histories(rounds=2))
    segs = r_bs.plan_segments(sr, min_len=1)
    assert t_bs.plan_segments(st, min_len=1) == segs
    assert len(segs) >= 3 and len({W for _, _, W in segs}) >= 2
    carried = from_reference(sr)
    for model, S, plan in (("cas-register", 8, segs),
                           ("register", 8, segs),
                           ("cas-register", 16, segs),
                           ("cas-register", 8, segs[:-1])):
        want = r_cp.steps_content_hash(sr, model, S, plan)
        assert t_cp.steps_content_hash(carried, model, S, plan) == want
        assert t_cp.steps_content_hash(st, model, S, plan) == want
    base = t_cp.steps_content_hash(st, "cas-register", 8, segs)
    assert t_cp.steps_content_hash(st, "register", 8, segs) != base
    other = steps_of(*histories(rounds=3))[1]
    assert t_cp.steps_content_hash(
        other, "cas-register", 8, t_bs.plan_segments(other, min_len=1)
    ) != base


def test_payload_hash_and_array_codec_equal_the_reference():
    fr = np.arange(2 * 8 * 128, dtype=np.int32).reshape(2, 8, 128)
    assert t_cp._enc_arr(fr) == r_cp._enc_arr(fr)
    assert np.array_equal(t_cp._dec_arr(r_cp._enc_arr(fr)), fr)
    st = {"version": 1, "frontier": t_cp._enc_arr(fr), "x": [1, 2]}
    assert t_cp._payload_sha(st) == r_cp._payload_sha(st)


# -- cold run, replay, kill-resume, rejection --------------------------------


def test_cold_run_then_replay_with_zero_launches(tmp_path, small_w):
    reset_all()
    (vr, vt), (kr, kt), _ = both(tmp_path, "a", dict(rounds=1))
    assert vr == vt == (True, False, -1)
    assert summary(kr) == summary(kt)
    got = same_stats()
    assert got[1]["launches"] == kt.segments_total
    for k in (kr, kt):
        assert os.path.exists(k.path)
    # a fresh sink over the finished file replays: zero launches
    reset_all()
    sr, st = steps_of(*histories(rounds=1))
    kr2 = r_cp.CheckpointSink(kr.path, seg_min_len=1)
    kt2 = t_cp.CheckpointSink(kt.path, seg_min_len=1)
    assert run_ref(sr, kr2) == run_port(st, kt2) == vt
    assert kt2.replayed and summary(kr2) == summary(kt2)
    got = same_stats()
    assert got[1]["launches"] == 0 and got[0]["replays"] == 1


def test_kill_resume_runs_only_unverified_segments(tmp_path, small_w):
    sr, st = steps_of(*histories(rounds=2))
    n_segs = len(t_bs.plan_segments(st, min_len=1))
    reset_all()
    kr, kt = sinks(tmp_path, "k", seg_min_len=1, after_save=die_after(2))
    with pytest.raises(Die):
        run_ref(sr, kr)
    with pytest.raises(Die):
        run_port(st, kt)
    same_stats()
    reset_all()
    sr, st = steps_of(*histories(rounds=2))
    kr2 = r_cp.CheckpointSink(kr.path, seg_min_len=1)
    kt2 = t_cp.CheckpointSink(kt.path, seg_min_len=1)
    assert run_ref(sr, kr2) == run_port(st, kt2) == (True, False, -1)
    assert kt2.resumed_from == 2 and summary(kr2) == summary(kt2)
    got = same_stats()
    assert got[1]["launches"] == n_segs - 2
    assert got[0]["resumes"] == 1 and got[0]["resumed_segments"] == 2


@pytest.mark.parametrize("damage", ["tamper", "torn"])
def test_damaged_checkpoint_rejects_to_a_cold_run(tmp_path, small_w,
                                                  damage):
    sr, st = steps_of(*histories(rounds=2))
    n_segs = len(t_bs.plan_segments(st, min_len=1))
    kr, kt = sinks(tmp_path, damage, seg_min_len=1,
                   after_save=die_after(2))
    for run, steps, k in ((run_ref, sr, kr), (run_port, st, kt)):
        with pytest.raises(Die):
            run(steps, k)
        if damage == "tamper":
            # a field edited without recomputing payload_sha
            state = json.load(open(k.path))
            state["segments_done"] = 1
            json.dump(state, open(k.path, "w"))
        else:
            data = open(k.path).read()
            open(k.path, "w").write(data[: len(data) // 2])
    reset_all()
    sr, st = steps_of(*histories(rounds=2))
    kr2 = r_cp.CheckpointSink(kr.path, seg_min_len=1)
    kt2 = t_cp.CheckpointSink(kt.path, seg_min_len=1)
    assert run_ref(sr, kr2) == run_port(st, kt2) == (True, False, -1)
    assert kt2.rejected and summary(kr2) == summary(kt2)
    got = same_stats()
    assert got[0]["rejected"] == 1 and got[1]["launches"] == n_segs


def test_foreign_history_checkpoint_rejected_by_content_hash(tmp_path,
                                                            small_w):
    both(tmp_path, "f", dict(rounds=3))
    reset_all()
    sr, st = steps_of(*histories(rounds=4))
    kr = r_cp.CheckpointSink(str(tmp_path / "ref" / "f"), seg_min_len=1)
    kt = t_cp.CheckpointSink(str(tmp_path / "port" / "f"), seg_min_len=1)
    assert run_ref(sr, kr) == run_port(st, kt) == (True, False, -1)
    assert kt.rejected and not kt.replayed
    assert summary(kr) == summary(kt)
    same_stats()


# -- persistence groups ------------------------------------------------------


@pytest.mark.parametrize("rounds", [1, 2])
def test_persistence_groups(tmp_path, small_w, rounds):
    """every=N: one launch and ONE host sync per group of N segments
    (every >= len(plan), as with one round here: the whole check, as
    the plain chain pays), a save per group boundary plus the
    verdict's. Every group here is one W4 and one W5 segment, so the
    reference compiles one chain shape; the plain segmented chain of
    that plan pays one launch and one sync as well."""
    every = 2
    sr, st = steps_of(*histories(rounds=rounds))
    n_segs = len(t_bs.plan_segments(st, min_len=1))
    assert n_segs == 2 * rounds
    if rounds == 1:
        # the plain chain of the same plan: one launch, one sync too
        reset_all()
        want = r_bs.check_steps_bitset_segmented(
            sr, model="cas-register", S=8, interpret=True, min_len=1)
        got = t_bs.check_steps_bitset_segmented(
            st, model="cas-register", S=8, device="cpu", min_len=1)
        assert got == want == (True, False, -1)
        assert same_stats()[1] == {"launches": 1, "escalations": 0,
                                   "host_syncs": 1, "donated_buffers": 0}
        sr, st = steps_of(*histories(rounds=rounds))
    reset_all()
    (vr, vt), (kr, kt), _ = both(tmp_path, str(rounds),
                                 dict(rounds=rounds), every=every)
    assert vr == vt == (True, False, -1)
    got = same_stats()
    assert got[1]["launches"] == got[1]["host_syncs"] == rounds
    assert got[0]["saves"] == n_segs // every + 1
    assert summary(kr) == summary(kt)


def test_saves_are_atomic_and_costed(tmp_path, small_w):
    reset_all()
    (vr, vt), (kr, kt), _ = both(tmp_path, "atomic", dict(rounds=2))
    same_stats()
    d = os.path.dirname(kt.path)
    assert [f for f in os.listdir(d) if ".tmp" in f] == []
    state = json.load(open(kt.path))
    assert state["payload_sha"] == t_cp._payload_sha(state)
    assert set(state) == set(json.load(open(kr.path)))
    assert t_cp.checkpoint_stats()["saves"] >= 2
    assert t_cp.checkpoint_stats()["overhead_s"] > 0


# -- escalation ---------------------------------------------------------------


def test_escalation_invalidates_and_exact_resume_is_sound(tmp_path,
                                                          small_w):
    """A fast-tier death voids every fast checkpoint; a kill during the
    exact pass resumes ON the exact tier with the same death verdict
    and death frontier, and a replay of the death restores it too."""
    kw = dict(rounds=2, bad_tail=True)
    reset_all()
    (vr, vt), _, (sr, st) = both(tmp_path, "cold", kw)
    assert vr == vt and vt[0] is False and vt[2] >= 0
    got = same_stats()
    assert got[1]["escalations"] == 1 and got[0]["invalidations"] == 1
    death = np.asarray(sr._death_frontier)
    assert np.array_equal(st._death_frontier, death)

    def die_on_exact(sink, state):
        if state.get("verdict") is None and state.get("exact") and (
            state["segments_done"] >= 1
        ):
            raise Die()

    kr, kt = sinks(tmp_path, "kill", seg_min_len=1, after_save=die_on_exact)
    for run, (steps, k) in zip((run_ref, run_port),
                               zip(steps_of(*histories(**kw)), (kr, kt))):
        with pytest.raises(Die):
            run(steps, k)
    reset_all()
    sr, st = steps_of(*histories(**kw))
    kr2 = r_cp.CheckpointSink(kr.path, seg_min_len=1)
    kt2 = t_cp.CheckpointSink(kt.path, seg_min_len=1)
    assert run_ref(sr, kr2) == run_port(st, kt2) == vt
    assert kt2.resumed_from >= 1 and summary(kr2) == summary(kt2)
    assert same_stats()[1]["escalations"] == 0
    assert np.array_equal(st._death_frontier, death)
    sr, st = steps_of(*histories(**kw))
    kt3 = t_cp.CheckpointSink(kt.path, seg_min_len=1)
    assert run_port(st, kt3) == vt and kt3.replayed
    assert np.array_equal(st._death_frontier, death)


# -- the checker and the plane ------------------------------------------------


def _map(out):
    out = {k: v for k, v in out.items() if k != "wall_s"}
    out["method"] = out["method"].replace("tpu-", "gpu-")
    if "checkpoint" in out:
        out["checkpoint"] = {k: v for k, v in out["checkpoint"].items()
                             if k != "path"}
    return out


@pytest.mark.parametrize("bad", [False, True])
def test_checker_threads_checkpoint_through(tmp_path, small_w, bad):
    """LinearizableChecker.check(checkpoint=): the verdict with its
    failure report and checkpoint block, then a replay from the
    finished file with the same report."""
    kw = dict(rounds=2, bad_tail=bad)
    hr, ht = histories(**kw)
    reset_all()
    kr, kt = sinks(tmp_path, "c", seg_min_len=1)
    want = r_lin.LinearizableChecker(interpret=True).check(
        {}, hr, checkpoint=kr)
    got = t_lin.LinearizableChecker(device="cpu").check(
        None, ht, checkpoint=kt)
    assert _map(got) == _map(want)
    assert got["valid?"] is (not bad)
    assert got["checkpoint"]["segments_total"] >= 2
    same_stats()
    reset_all()
    hr, ht = histories(**kw)
    want = r_lin.LinearizableChecker(interpret=True).check(
        {}, hr, checkpoint=r_cp.CheckpointSink(kr.path, seg_min_len=1))
    got = t_lin.LinearizableChecker(device="cpu").check(
        None, ht, checkpoint=t_cp.CheckpointSink(kt.path, seg_min_len=1))
    assert _map(got) == _map(want)
    assert got["checkpoint"]["replayed_verdict"]
    assert same_stats()[1]["launches"] == 0


def test_plane_routes_durable_checks(tmp_path, small_w):
    """DispatchPlane.submit(checkpoint=): a multi-segment plan runs the
    group scan on the collecting thread (durable_solo); a
    single-segment plan rides the bitset bucket (durable_coalesced) and
    its finished checkpoint replays at prep with zero launches; the
    stats carry the checkpoint section; owner stamps an un-owned sink."""
    multi = histories(rounds=2)
    single = histories(rounds=1, pairs=20)
    evs = [(r_ev.history_to_events(hr), t_ev.history_to_events(ht))
           for hr, ht in (multi, single)]
    outs = []
    for rnd in range(2):
        reset_all()
        kr_m, kt_m = sinks(tmp_path, "m", seg_min_len=1)
        kr_s, kt_s = sinks(tmp_path, "s")
        with r_dp.DispatchPlane(interpret=True, mesh=False, race=False,
                                owner="member-1") as rp:
            want = [rp.submit(ev, model="cas-register", checkpoint=k)
                    .result() for (ev, _), k in zip(evs, (kr_m, kr_s))]
        with t_dp.DispatchPlane(device="cpu", owner="member-1") as tp:
            got = [tp.submit(ev, model="cas-register", checkpoint=k)
                   .result() for (_, ev), k in zip(evs, (kt_m, kt_s))]
        assert [_map(o) for o in got] == [_map(o) for o in want]
        assert kt_m.owner == "member-1"
        st = same_stats()
        assert st[2]["durable_solo"] == 1
        assert st[2]["durable_coalesced"] == 1
        assert t_dp.dispatch_stats()["checkpoint"] == (
            t_cp.checkpoint_stats())
        outs.append((got, st))
    (first, st1), (again, st2) = outs
    assert all(o["valid?"] is True for o in first + again)
    assert [o["checkpoint"]["replayed_verdict"] for o in again] == [
        True, True]
    assert st2[1]["launches"] == 0


def test_checkpoint_files_interchange_between_packages(tmp_path, small_w):
    """A checkpoint killed at boundary 2 by one package resumes in the
    other at segment 2, with the cold verdict."""
    sr, st = steps_of(*histories(rounds=2))
    n_segs = len(t_bs.plan_segments(st, min_len=1))
    for writer, reader in ((run_ref, "port"), (run_port, "ref")):
        path = str(tmp_path / f"to-{reader}")
        mk = r_cp.CheckpointSink if writer is run_ref else t_cp.CheckpointSink
        with pytest.raises(Die):
            writer(sr if writer is run_ref else st,
                   mk(path, seg_min_len=1, after_save=die_after(2)))
        sr, st = steps_of(*histories(rounds=2))
        reset_all()
        if reader == "port":
            k = t_cp.CheckpointSink(path, seg_min_len=1)
            assert run_port(st, k) == (True, False, -1)
            launches = t_dev.launch_stats_snapshot()["launches"]
        else:
            k = r_cp.CheckpointSink(path, seg_min_len=1)
            assert run_ref(sr, k) == (True, False, -1)
            launches = r_bs.launch_stats_snapshot()["launches"]
        assert k.resumed_from == 2 and not k.rejected
        assert launches == n_segs - 2


# -- real SIGKILL soaks (slow) ----------------------------------------------

_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.checkpoint import CheckpointSink
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.history import ops
from jepsen_tpu_torch.history.history import History
bs.W_BUCKETS = (4, 5) + bs.W_BUCKETS
out = []
for _ in range({rounds}):
    for i in range(30):
        out += [ops.invoke_op(0, "write", i % 3), ops.ok_op(0, "write", i % 3)]
    out += [ops.invoke_op(p, "write", p % 3) for p in range(5)]
    out += [ops.ok_op(p, "write", p % 3) for p in range(5)]
r = LinearizableChecker(device="cpu").check(
    None, History(out), checkpoint=CheckpointSink({path!r}, seg_min_len=1))
print(r["valid?"], r["checkpoint"]["resumed_from_segment"],
      r["checkpoint"]["rejected_stale"], flush=True)
"""


def _child(path, rounds):
    return subprocess.Popen(
        [sys.executable, "-c",
         _CHILD.format(repo=str(REPO), path=path, rounds=rounds)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _kill_at(proc, path, n, deadline_s=300):
    end = time.time() + deadline_s
    seen = 0
    while time.time() < end and proc.poll() is None:
        try:
            seen = json.load(open(path)).get("segments_done", 0)
        except (OSError, ValueError):
            seen = 0
        if seen >= n:
            os.kill(proc.pid, signal.SIGKILL)
            break
        time.sleep(0.01)
    proc.wait(timeout=60)
    return seen


@pytest.mark.slow
@pytest.mark.parametrize("tamper", [False, True])
def test_sigkill_resume(tmp_path, tamper):
    """A child checking through a durable sink is SIGKILLed after its
    third boundary; a fresh process resumes past it (or, over a
    tampered file, runs cold) to the valid verdict."""
    path = str(tmp_path / "checkpoint.json")
    proc = _child(path, rounds=40)
    assert _kill_at(proc, path, 3) >= 3
    assert proc.returncode == -signal.SIGKILL
    if tamper:
        state = json.load(open(path))
        state["segments_done"] = 1
        json.dump(state, open(path, "w"))
    proc = _child(path, rounds=40)
    out, _ = proc.communicate(timeout=600)
    valid, resumed, rejected = out.split()
    assert valid == "True"
    if tamper:
        assert rejected == "True" and resumed == "0"
    else:
        assert rejected == "False" and int(resumed) >= 3
