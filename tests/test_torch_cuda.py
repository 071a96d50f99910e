"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on the card. Marked cuda: each test skips where there
is no GPU (the kernels have no CPU mode). The file imports only the
port, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance: exact equality (integer and bit arithmetic)."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker import events as ev_mod
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker import wgl_kfrontier as kf
from jepsen_tpu_torch.checker import linearizable as lin
from jepsen_tpu_torch.checker import sharded
from jepsen_tpu_torch.checker.linearizable import check_events_bucketed
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _stores(W, S):
    """Every frontier store the kernel can use at (W, S)."""
    out = []
    for placement in bs.STORES:
        try:
            bs.geometry(W, S, placement)
            out.append(placement)
        except ValueError:
            pass
    return out


def _histories(W, nv, seed):
    h = sim.gen_register_history(random.Random(seed), n_ops=48, n_procs=W,
                                 n_values=nv, p_crash=0.0)
    return h, sim.corrupt_history(h, random.Random(seed + 1), n_values=nv)


@pytest.mark.parametrize("W,S", [(W, S) for W in bs.W_BUCKETS
                                 for S in (8, 32)])
def test_bitset_kernel_matches_plain(cuda, W, S):
    nv = 5 if S == 8 else 24
    for h in _histories(W, nv, 10 * W + S):
        st = ev_mod.events_to_steps(ev_mod.history_to_events(h), W=W)
        st = st.padded(ev_mod.bucket(len(st), 64))
        win, meta = bs.pack_steps(st)
        fr0 = bs.init_frontier(st.init_state, S, W)[None]
        args = [torch.from_numpy(a).to(cuda)
                for a in (win[None], meta[None], fr0)]
        for exact in (False, True):
            want = bs.bitset_scan_plain(*args, "cas-register", S, W,
                                        exact=exact)
            for placement in [None] + _stores(W, S):
                got = bs.bitset_scan(*args, "cas-register", S, W,
                                     exact=exact, placement=placement)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (exact, placement)
                assert torch.equal(got[1], want[1]), (exact, placement)


def _synthetic(W, n, seed, ret_slots, death_at=None, nv=5):
    """A packed bitset step stream (win, meta) that exercises chosen
    slots: every step occupies about half the window, always its
    returning slot (cycling through ret_slots), with random reads,
    writes and cas; the returning op is a fresh write, which always
    linearizes. At death_at, slot W-2 (unoccupied until then) returns a
    read of a value no op writes, so the scan dies exactly there."""
    rng = np.random.default_rng(seed)
    occ = (rng.random((n, W)) < 0.5).astype(np.int8)
    f = rng.choice([0, 1, 2], size=(n, W), p=[0.3, 0.4, 0.3])
    a = rng.integers(0, nv, size=(n, W))
    b = rng.integers(0, nv, size=(n, W))
    fresh_bits = (rng.random((n, W)) < 0.5) & (occ == 1)
    slot = np.array([ret_slots[i % len(ret_slots)] for i in range(n)])
    rows = np.arange(n)
    occ[rows, slot] = 1
    f[rows, slot] = 1
    fresh_bits[rows, slot] = True
    if death_at is not None:
        d = W - 2
        assert d not in ret_slots
        occ[:death_at, d] = 0
        fresh_bits[:death_at, d] = False
        slot[death_at] = d
        occ[death_at, d] = 1
        fresh_bits[death_at, d] = True
        f[death_at, d] = 0
        a[death_at, d] = nv
    fresh = (fresh_bits.astype(np.int64) << np.arange(W)).sum(axis=1)
    meta = np.stack([slot, np.ones(n, np.int64), rows,
                     fresh.astype(np.uint32).view(np.int32)], axis=1)
    win = np.stack([occ, f, a, b], axis=1).astype(np.int8)
    return win.reshape(1, -1), meta.astype(np.int32).reshape(1, -1)


def _assert_bitset_parity(cuda, win, meta, S, W, placements, exacts=(False,
                                                                     True)):
    fr0 = bs.init_frontier(-1, S, W)[None]
    args = [torch.from_numpy(x).to(cuda) for x in (win, meta, fr0)]
    outs = []
    for exact in exacts:
        want = bs.bitset_scan_plain(*args, "cas-register", S, W, exact=exact)
        for placement in placements:
            got = bs.bitset_scan(*args, "cas-register", S, W, exact=exact,
                                 placement=placement)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (exact, placement, got[0],
                                                  want[0])
            assert torch.equal(got[1], want[1]), (exact, placement)
        outs.append(want[0][0, 0].tolist())
    return outs


@pytest.mark.parametrize("W,S", [(12, 8), (13, 8), (14, 8), (16, 8),
                                 (17, 8), (15, 16)])
def test_bitset_kernel_slot_class_boundaries(cuda, W, S):
    """Closure and returning slots at each exchange class's edge (w =
    4/5, 9/10, the last column slot and the first cross-warp slot),
    both tiers, every store."""
    for placement in _stores(W, S):
        geo = bs.geometry(W, S, placement)
        edges = {4, 5, 9, 10, 10 + geo.cbits - 1, 10 + geo.cbits, W - 1}
        rets = sorted(w for w in edges if 0 <= w < W)
        classes = {geo.slot_class(w) for w in rets}
        assert {"word", "lane"} <= classes
        assert classes & {"column", "warp"}
        win, meta = _synthetic(W, 96, seed=W * 100 + S, ret_slots=rets)
        outs = _assert_bitset_parity(cuda, win, meta, S, W, [placement])
        assert all(o[0] == 1 for o in outs)  # writes always linearize


@pytest.mark.parametrize("n,death_at", [(40, 31), (40, 32), (80, 63),
                                        (80, 64), (80, 79), (48, None)])
def test_bitset_kernel_chunk_edges(cuda, n, death_at):
    """Deaths at a staged chunk's last and first step (chunks of
    bs.CHUNK = 32 steps), and step counts that are not a multiple of
    the chunk: the died op index and the pre-filter frontier match."""
    assert bs.CHUNK == 32
    for W, S in ((12, 8), (14, 8), (16, 8)):
        win, meta = _synthetic(W, n, seed=n + W, ret_slots=[0, 6, 11, W - 1],
                               death_at=death_at)
        outs = _assert_bitset_parity(cuda, win, meta, S, W,
                                     [None] + _stores(W, S))
        for o in outs:
            assert o[0] == (death_at is None)
            assert o[2] == (-1 if death_at is None else death_at)


@pytest.mark.parametrize("K,W", [(128, 8), (128, 16), (128, 32), (256, 8),
                                 (256, 16)])
def test_kfrontier_kernel_matches_plain(cuda, K, W):
    if W == 32:
        h = sim.gen_cas_counter_history(random.Random(3), n_rounds=2,
                                        n_procs=32)
        hs = [h, sim.corrupt_history(h, random.Random(4), n_values=33)]
    else:
        hs = list(_histories(min(W, 14), 3, W))
    for h in hs:
        st = ev_mod.events_to_steps(ev_mod.history_to_events(h), W=W)
        win, meta = (torch.from_numpy(a[None]).to(cuda)
                     for a in kf.pack_steps(st))
        want = kf.kfrontier_scan_plain(win, meta, "cas-register", K, W)
        got = kf.kfrontier_scan(win, meta, "cas-register", K, W)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("K", [128, 256, 512])
def test_kfrontier_kernel_full_table_and_slot31(cuda, K):
    """A full table (fourteen concurrent clients overflow K=128..512),
    the sign-bit slot 31 (a 32-client counter), and a table larger than
    one block of threads (K=512)."""
    over = sim.gen_register_history(random.Random(23), n_ops=80, n_procs=14,
                                    p_crash=0.0)
    w32 = sim.gen_cas_counter_history(random.Random(24), n_rounds=4,
                                      n_procs=32)
    overflowed = False
    for h, W in ((over, 16), (w32, 32),
                 (sim.corrupt_history(w32, random.Random(25), n_values=33),
                  32)):
        st = ev_mod.events_to_steps(ev_mod.history_to_events(h), W=W)
        win, meta = (torch.from_numpy(a[None]).to(cuda)
                     for a in kf.pack_steps(st))
        if W == 32:
            assert (meta[0, :, 0, 0] < 0).any()  # slot 31 returns
        want = kf.kfrontier_scan_plain(win, meta, "cas-register", K, W)
        got = kf.kfrontier_scan(win, meta, "cas-register", K, W)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        overflowed |= bool(got[0, 0, 1])
    assert overflowed


def test_check_on_card_matches_cpu(cuda):
    cases = [sim.gen_register_history(random.Random(s), n_ops=300,
                                      n_procs=5, p_crash=0.02)
             for s in range(3)]
    cases.append(sim.corrupt_history(cases[0], random.Random(9)))
    counter = sim.gen_cas_counter_history(random.Random(5), n_rounds=3,
                                          n_procs=24)
    cases += [counter,
              sim.corrupt_history(counter, random.Random(6), n_values=25)]
    for h in cases:
        ev = ev_mod.history_to_events(h)
        # race=False: the device path itself (the native racer may win
        # an eligible history on the card)
        assert check_events_bucketed(ev, race=False) == check_events_bucketed(
            ev_mod.history_to_events(h), device="cpu")


def test_wrappers_check_their_inputs(cuda):
    win = torch.zeros((1, 64 * 4 * 12), dtype=torch.int8, device=cuda)
    meta = torch.zeros((1, 64 * 4), dtype=torch.int32, device=cuda)
    fr = torch.zeros((1, 8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        bs.bitset_scan(win.int(), meta, fr, "cas-register", 8, 12)
    with pytest.raises(ValueError):
        bs.bitset_scan(win, meta, fr[:, :4], "cas-register", 8, 12)
    with pytest.raises(ValueError):
        bs.bitset_scan(win, meta, fr, "cas-register", 8, 12,
                       placement="nowhere")
    kwin = torch.zeros((1, 64, 4, 8), dtype=torch.int32, device=cuda)
    kmeta = torch.zeros((1, 64, 1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kf.kfrontier_scan(kwin, kmeta, "cas-register", 1 << 14, 8)
    with pytest.raises(TypeError):
        kf.kfrontier_scan(kwin.long(), kmeta, "cas-register", 128, 8)


# -- the key axis --------------------------------------------------------------


def _key_batch_steps(W, nv, seed):
    """5 register keys of unequal lengths, keys 1 and 3 corrupted, with
    init state codes -1 .. 3 (a different fr0 row each)."""
    steps = []
    for k in range(5):
        h = sim.gen_register_history(random.Random(seed + k),
                                     n_ops=30 + 25 * k, n_procs=4,
                                     n_values=nv, p_crash=0.0)
        if k in (1, 3):
            h = sim.corrupt_history(h, random.Random(seed + 100 + k),
                                    n_values=nv)
        st = ev_mod.events_to_steps(ev_mod.history_to_events(h), W=W)
        steps.append(dataclasses.replace(st, init_state=k - 1))
    return steps


def _stack(arrays, n_blank):
    out = np.stack(arrays)
    return np.concatenate([out, np.zeros((n_blank,) + out.shape[1:],
                                         out.dtype)])


@pytest.mark.parametrize("W,S", [(12, 8), (16, 16), (13, 32)])
def test_bitset_kernel_key_batch_matches_plain(cuda, W, S):
    """One launch over 5 keys of unequal lengths and init states (two
    dying) and 3 blank keys: out and fr_out equal to the plain version,
    both tiers, in every store."""
    steps = _key_batch_steps(W, 5 if S == 8 else 12, 40 * W + S)
    n = ev_mod.bucket(max(len(st) for st in steps), 64)
    packed = [bs.pack_steps(st.padded(n)) for st in steps]
    fr0 = np.stack([bs.init_frontier(st.init_state, S, W) for st in steps]
                   + [bs.init_frontier(0, S, W)] * 3)
    args = [torch.from_numpy(a).to(cuda) for a in (
        _stack([w for w, _ in packed], 3), _stack([m for _, m in packed], 3),
        fr0)]
    for exact in (False, True):
        want = bs.bitset_scan_plain(*args, "cas-register", S, W, exact=exact)
        assert want[0][5:, 0, 0].tolist() == [1, 1, 1]
        for placement in [None] + _stores(W, S):
            got = bs.bitset_scan(*args, "cas-register", S, W, exact=exact,
                                 placement=placement)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (exact, placement)
            assert torch.equal(got[1], want[1]), (exact, placement)


def test_kfrontier_kernel_key_batch_matches_plain(cuda):
    """One launch over the 32 per-value substreams of a queue history
    (window 4, packed model) plus 3 blank keys, and over 5 register keys
    of unequal lengths at W=16: out equal to the plain version."""
    h = sim.gen_queue_history(random.Random(7), n_ops=800, n_procs=5,
                              n_values=32, p_crash=0.01)
    subs = lin.split_queue_history_by_value(h)
    evs = [ev_mod.history_to_events(sub, model="unordered-queue")
           for sub in subs.values()]
    W = lin._bucket_window(max(ev.window for ev in evs))
    queue = [ev_mod.events_to_steps(ev, W=W) for ev in evs]
    for steps, model, W, K in (
        (queue, "unordered-queue-packed", W, 128),
        (_key_batch_steps(16, 5, 900), "cas-register", 16, 128),
    ):
        n = ev_mod.bucket(max(len(st) for st in steps), 64)
        kic = lin.get_model(model).kernel_init_code
        packed = [kf.pack_steps(dataclasses.replace(
            st, init_state=kic(st.init_state)).padded(n)) for st in steps]
        win, meta = (torch.from_numpy(_stack(list(a), 3)).to(cuda)
                     for a in zip(*packed))
        want = kf.kfrontier_scan_plain(win, meta, model, K, W)
        got = kf.kfrontier_scan(win, meta, model, K, W)
        torch.cuda.synchronize()
        assert torch.equal(got, want), model
        assert want[-3:, 0, 0].tolist() == [1, 1, 1]


def test_check_keys_on_card_matches_cpu(cuda):
    """check_keys and the queue route on the card give the CPU's
    verdicts; a batch with dead keys takes two launches and two syncs
    (one exact re-run), a clean one one of each."""
    hists = [sim.gen_register_history(random.Random(950 + k), n_ops=200,
                                      n_procs=5, p_crash=0.01)
             for k in range(6)]
    bad = [sim.corrupt_history(h, random.Random(k)) if k in (1, 4) else h
           for k, h in enumerate(hists)]
    for batch, n in ((hists, 1), (bad, 2)):
        want = sharded.check_keys(
            [ev_mod.history_to_events(h) for h in batch], device="cpu")
        reset_launch_stats()
        got = sharded.check_keys(
            [ev_mod.history_to_events(h) for h in batch])
        assert got == want
        assert launch_stats_snapshot() == {
            "launches": n, "escalations": n - 1, "host_syncs": n,
            "donated_buffers": 0}
    q = sim.gen_queue_history(random.Random(8), n_ops=400, n_procs=5,
                              n_values=20, p_crash=0.02)
    for h in (q, sim.overdraw_queue_history(q, 3)):
        want = lin.LinearizableChecker("unordered-queue",
                                       device="cpu").check(None, h)
        got = lin.LinearizableChecker("unordered-queue").check(None, h)
        for k in ("valid?", "method", "n_values", "failed_value",
                  "failed_op_index", "failure"):
            assert got.get(k) == want.get(k), k


def test_torch_key_batch_on_card_matches_cpu(cuda):
    """The key-batched torch-ops scan (gpu-wgl-batch, windows past one
    mask word) on the card against the CPU, with a blank key."""
    streams = []
    for k, rounds in enumerate((1, 2)):
        h = sim.gen_cas_counter_history(random.Random(960 + k),
                                        n_rounds=rounds, n_procs=34)
        if k:
            h = sim.corrupt_history(h, random.Random(961), n_values=35)
        streams.append(ev_mod.history_to_events(h))
    cols = sharded.stack_streams(streams, W=64, n_keys=3)
    from jepsen_tpu_torch.checker.wgl_torch import wgl_scan_keys

    want = wgl_scan_keys(cols, "cas-register", 8, torch.device("cpu"))
    got = wgl_scan_keys(cols, "cas-register", 8, cuda)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# -- the dispatch plane on the card -------------------------------------------


def _plane_streams():
    """Streams for every bucket kind: four 1k-op register histories (one
    corrupted) for the bitset bucket, a multi-segment (W12 then W18)
    history and its corrupted copy for the segmented solo launch, and
    three register histories with more value codes than the bitset's 32
    state rows (one corrupted) for the vmap bucket."""
    regs = [sim.gen_register_history(random.Random(100 + i), n_ops=1000,
                                     n_procs=5, p_crash=0.01)
            for i in range(4)]
    regs[2] = sim.corrupt_history(regs[2], random.Random(202))
    seg = sim.gen_register_history(random.Random(1), n_ops=2500, n_procs=4,
                                   p_crash=0.004)
    wide = [sim.gen_register_history(random.Random(7600 + i), n_ops=120,
                                     n_procs=4, n_values=64, p_crash=0.0)
            for i in range(3)]
    wide[1] = sim.corrupt_history(wide[1], random.Random(7601), n_values=64)
    hs = regs + [seg, sim.corrupt_history(seg, random.Random(11))] + wide
    return [ev_mod.history_to_events(h) for h in hs]


def _plane_run(device, streams):
    from jepsen_tpu_torch.checker.dispatch import (
        DISPATCH_STATS,
        DispatchPlane,
        reset_dispatch_stats,
    )

    reset_dispatch_stats()
    with DispatchPlane(device=device) as plane:
        futs = [plane.submit(s) for s in streams]
        plane.flush()
        outs = [f.result() for f in futs]
    return outs, dict(DISPATCH_STATS)


def test_plane_on_card_matches_cpu(cuda):
    """The plane's bitset, segmented and vmap buckets on the card give
    the CPU plane's verdicts, field for field, with the same batching."""
    streams = _plane_streams()
    want, want_stats = _plane_run("cpu", streams)
    got, got_stats = _plane_run(None, streams)
    assert got == want
    assert {o["method"] for o in got} >= {
        "gpu-wgl-bitset-batch", "gpu-wgl-bitset", "gpu-wgl-batch"}
    for k in ("requests", "batches", "batched_requests", "solo_launches"):
        assert got_stats[k] == want_stats[k], k


def test_plane_one_host_sync_per_train(cuda):
    """Eight same-shape clean requests on the card: one launch and one
    counted host sync for the whole train, and the event the collect
    waited on has fired."""
    from jepsen_tpu_torch.checker.dispatch import DispatchPlane

    streams = [ev_mod.history_to_events(sim.gen_register_history(
        random.Random(100 + i), n_ops=1000, n_procs=5, p_crash=0.01))
        for i in range(8)]
    reset_launch_stats()
    with DispatchPlane() as plane:
        futs = [plane.submit(s) for s in streams]
        plane.flush()
        launch = futs[0].launch
        assert all(f.launch is launch for f in futs)
        host = launch.host
        outs = [f.result() for f in futs]
        assert host.event.query()
    assert all(o["valid?"] is True for o in outs)
    assert launch_stats_snapshot() == {
        "launches": 1, "escalations": 0, "host_syncs": 1,
        "donated_buffers": 0}


def test_train_wait_poll_is_cut_at_its_deadline(cuda):
    """A launch train whose event has not fired (the stream busy in a
    spin kernel) is not waited on forever: wait_train polls the event
    and raises DeadlineExceeded at its deadline, then returns once the
    stream drains."""
    import time

    from jepsen_tpu_torch.checker.chaos import DeadlineExceeded
    from jepsen_tpu_torch.device import copy_to_host_async, wait_train

    stream = torch.cuda.Stream()
    x = torch.arange(16, device=cuda)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(2_000_000_000)  # about a second of spinning
        copy = copy_to_host_async([x * 2], stream)
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceeded):
        wait_train(copy, deadline_s=0.05)
    assert time.perf_counter() - t0 < 0.5
    assert not copy.event.query()
    wait_train(copy)
    assert copy.arrays[0].tolist() == list(range(0, 32, 2))


def test_card_plane_fails_instead_of_degrading(cuda):
    """On the card a spent fault budget fails the riders with the
    structured PlaneFault; the host oracle answers only on a plane built
    with degrade=True, and then says so on the verdict."""
    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker.dispatch import DispatchPlane

    streams = [ev_mod.history_to_events(sim.gen_register_history(
        random.Random(100 + i), n_ops=1000, n_procs=5, p_crash=0.01))
        for i in range(2)]
    chaos.reset_resilience()
    try:
        with chaos.chaos_plan(chaos.persistent_device_fault("cuda")):
            with DispatchPlane() as plane:
                assert plane.degrade is False
                futs = [plane.submit(s) for s in streams]
                plane.flush()
                for f in futs:
                    with pytest.raises(chaos.PlaneFault) as ei:
                        f.result()
                    assert ei.value.kind == "fatal"
            assert chaos.RESILIENCE_STATS["oracle_fallbacks"] == 0
            with DispatchPlane(degrade=True) as plane:
                futs = [plane.submit(s) for s in streams]
                plane.flush()
                outs = [f.result() for f in futs]
        assert all(o["valid?"] is True and o["degraded"]["kind"] == "fatal"
                   for o in outs)
        assert chaos.RESILIENCE_STATS["oracle_fallbacks"] == len(streams)
    finally:
        chaos.reset_resilience()


def test_card_checker_does_not_race_by_default(cuda):
    """The default checker on the card returns the kernel's verdict: no
    native racer starts unless the caller asks for one."""
    h = sim.gen_register_history(random.Random(100), n_ops=1000, n_procs=5,
                                 p_crash=0.01)
    lin.reset_race_stats()
    out = lin.LinearizableChecker().check(None, h)
    assert out["valid?"] is True and out["method"] == "gpu-wgl-bitset"
    assert "race_winner" not in out
    assert sum(lin.RACE_STATS.values()) == 0


def _burst_history(rounds=2, bad=False):
    """Sequential write pairs and a 13-process burst per round: a plan
    that widens W12 -> W13 and narrows back (min_len=1)."""
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.history.ops import invoke_op, ok_op

    ops = []
    for _ in range(rounds):
        for i in range(40):
            ops += [invoke_op(0, "write", i % 3), ok_op(0, "write", i % 3)]
        ops += [invoke_op(p, "write", p % 3) for p in range(13)]
        ops += [ok_op(p, "write", p % 3) for p in range(13)]
    if bad:
        ops += [invoke_op(0, "read"), ok_op(0, "read", 7)]
    return History(ops)


@pytest.mark.parametrize("bad", [False, True])
def test_checkpointed_scan_on_card_matches_cpu(cuda, tmp_path, bad):
    """The checkpointed group scan on the card (kernel A from each
    group's boundary frontier) gives the CPU's verdict, death frontier,
    launch counts and the same durable file, byte for byte; a resume
    from a kill at boundary 2 on the card runs only the rest."""
    from jepsen_tpu_torch.checker.checkpoint import CheckpointSink

    def run(device, path, **kw):
        path.mkdir(parents=True, exist_ok=True)
        ev = ev_mod.history_to_events(_burst_history(bad=bad))
        st = ev_mod.events_to_steps(ev, W=ev.window)
        reset_launch_stats()
        v = bs.check_steps_bitset_segmented(
            st, S=8, device=device,
            checkpoint=CheckpointSink(str(path), seg_min_len=1, **kw))
        return v, getattr(st, "_death_frontier", None), \
            launch_stats_snapshot()

    want = run("cpu", tmp_path / "cpu")
    got = run(None, tmp_path / "cuda")
    assert got[0] == want[0] and got[2] == want[2]
    if bad:
        assert np.array_equal(got[1], want[1])
    assert (open(tmp_path / "cpu" / "checkpoint.json").read()
            == open(tmp_path / "cuda" / "checkpoint.json").read())
    if not bad:
        class Die(Exception):
            pass

        def hook(sink, st):
            if st.get("verdict") is None and st["segments_done"] >= 2:
                raise Die()

        with pytest.raises(Die):
            run(None, tmp_path / "kill", after_save=hook)
        v, _, stats = run(None, tmp_path / "kill")
        assert v == want[0]
        assert stats["launches"] == want[2]["launches"] - 2


def test_launch_tails_mixed_seeds_match_plain(cuda):
    """launch_tails_bitset on the card with rows seeded from None, a
    host [S, M] array, a host [1, S, M] array and a device row of an
    earlier stacked launch: every row equals bitset_scan_plain on that
    row's inputs, out and fr_out."""
    tails = []
    for i in range(4):
        h = sim.gen_register_history(random.Random(60 + i), n_ops=40,
                                     n_procs=4, p_crash=0.0)
        tails.append(ev_mod.events_to_steps(ev_mod.history_to_events(h),
                                            W=12))
    _, (fr_first, *_) = bs.launch_tails_bitset(tails, [None] * 4, S=8)
    seeds = [None, fr_first[1].cpu().numpy(),
             fr_first[2].cpu().numpy()[None], fr_first[3]]
    out, (fr_out, *_) = bs.launch_tails_bitset(tails, seeds, S=8)
    torch.cuda.synchronize()
    n = ev_mod.bucket(max(len(t) for t in tails), 64)
    for i, (st, seed) in enumerate(zip(tails, seeds)):
        win, meta = bs.pack_steps(st.padded(n))
        f0 = (bs.init_frontier(st.init_state, 8, 12) if seed is None
              else (seed.cpu().numpy() if isinstance(seed, torch.Tensor)
                    else np.asarray(seed)).reshape(8, -1))
        o, f = bs.bitset_scan_plain(
            torch.from_numpy(win[None]).to(cuda),
            torch.from_numpy(meta[None]).to(cuda),
            torch.from_numpy(np.ascontiguousarray(f0)[None]).to(cuda),
            "cas-register", 8, 12)
        assert torch.equal(out[i], o[0]) and torch.equal(fr_out[i], f[0])


def test_stream_keeps_its_frontier_when_the_plane_fails(cuda):
    """Two streams on a card plane: after two coalesced appends each
    frontier is a device row; a persistent fault on the stream bucket's
    launch moves the third append to the solo chain (kernel A, from
    that row) with the verdict of the whole history, as on the CPU."""
    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker.dispatch import DispatchPlane
    from jepsen_tpu_torch.checker.streaming import (
        StreamingCheck,
        reset_stream_stats,
        stream_stats,
    )

    hists = [sim.gen_register_history(random.Random(70 + i), n_ops=300,
                                      n_procs=4, p_crash=0.0)
             for i in range(2)]
    hists[1] = sim.corrupt_history(hists[1], random.Random(3))

    def run(device):
        reset_stream_stats()
        chaos.reset_resilience()
        outs = []
        with DispatchPlane(device=device) as plane:
            for h in hists:
                sc = StreamingCheck(device=device, plane=plane)
                ops = list(h.ops)
                cut = [0, len(ops) // 3, 2 * len(ops) // 3, len(ops)]
                for r in range(3):
                    chunk = ops[cut[r]:cut[r + 1]]
                    if r < 2:
                        sc.append(chunk)
                        continue
                    assert sc._fr_dev is None or (
                        sc._fr_dev.device.type == torch.device(
                            device or "cuda").type)
                    with chaos.chaos_plan(chaos.persistent_device_fault(
                            "cuda" if device is None else "cpu")):
                        sc.append(chunk)
                outs.append(sc.result())
        st = stream_stats()
        chaos.reset_resilience()
        return [{k: o.get(k) for k in ("valid?", "failed_op_index")}
                for o in outs], st

    want, want_st = run("cpu")
    got, got_st = run(None)
    assert got == want
    assert got_st == want_st and got_st["plane_fallbacks"] >= 1


# -- the columnar checkers' device programs (torch ops on the card) ----------


@pytest.mark.parametrize("torn", [False, True])
def test_bank_on_card_matches_numpy_and_cpu(cuda, torn):
    """BankChecker(force_device=True) on the card: the numpy route's
    and the CPU torch route's result dicts, one counted fetch."""
    from jepsen_tpu_torch.checker import bank

    h = sim.gen_bank_history(random.Random(60 + torn), n_ops=4_000,
                             torn=torn)
    test = {"accounts": list(range(8)), "total_amount": 100}
    plane = bank.BankChecker.encode(test, h)
    want = bank.BankChecker(device="cpu").check(test, plane)
    cpu = bank.BankChecker(device="cpu", force_device=True).check(test, plane)
    reset_launch_stats()
    got = bank.BankChecker(force_device=True).check(test, plane)
    assert launch_stats_snapshot()["host_syncs"] == 1
    assert got == want == cpu
    assert got["valid?"] is not torn
    out = bank.bank_reduce_torch(torch.from_numpy(plane.bal).to(cuda), 100.0)
    ref = bank.bank_reduce_torch(torch.from_numpy(plane.bal), 100.0)
    assert torch.equal(out.cpu(), ref)


def _counter_history(seed, n, bad=False):
    """Quarter and whole deltas (every partial sum exact in float64,
    whatever the order of a parallel scan); when bad, the middle read
    returns 1,000 more than the counter held."""
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.history.ops import invoke_op, ok_op

    rng = random.Random(seed)
    ops, val = [], 0.0
    for _ in range(n // 2):
        p = rng.randrange(8)
        if rng.random() < 0.5:
            d = rng.randrange(1, 40) / 4 if rng.random() < 0.3 else \
                rng.randrange(0, 9)
            ops += [invoke_op(p, "add", d), ok_op(p, "add", d)]
            val += d
        else:
            ops += [invoke_op(p, "read"),
                    ok_op(p, "read", int(val) if val.is_integer() else val)]
    if bad:
        reads = [i for i, o in enumerate(ops) if o.is_ok and o.f == "read"]
        i = reads[len(reads) // 2]
        ops[i] = ops[i].with_(value=ops[i].value + 1000)
    return History(ops)


@pytest.mark.parametrize("bad", [False, True])
def test_counter_on_card_matches_numpy_and_cpu(cuda, bad):
    """The counter's default route on the card past the 100k gate: the
    numpy route's and the CPU torch route's result dicts, bounds equal
    in float64, one counted fetch."""
    from jepsen_tpu_torch.checker import reductions as red

    h = _counter_history(70 + bad, 120_000, bad)
    want = red.CounterChecker(device="cpu").check({}, h, force_device=False)
    cpu = red.CounterChecker(device="cpu").check({}, h, force_device=True)
    reset_launch_stats()
    got = red.CounterChecker().check({}, h)
    assert launch_stats_snapshot()["host_syncs"] == 1
    assert got == want == cpu
    assert got["valid?"] is not bad
    assert len(got["errors"]) == int(bad)


@pytest.mark.parametrize("forked", [False, True])
def test_fork_product_on_card_matches_numpy_and_cpu(cuda, forked):
    """LongForkChecker on the card: the CPU torch product's result dict
    and fork matrix, and the numpy product's, one launch and one
    fetch."""
    from jepsen_tpu_torch.checker import longfork as lf

    h = sim.gen_long_fork_history(random.Random(80 + forked), n_groups=64,
                                  ops_per_group=200, forked=forked)
    want = lf.LongForkChecker(device="cpu").check({}, h)
    reset_launch_stats()
    got = lf.LongForkChecker().check({}, h)
    stats = launch_stats_snapshot()
    assert (stats["launches"], stats["host_syncs"]) == (1, 1)
    assert got == want
    assert got["valid?"] is not forked
    V, live = lf.LongForkChecker().state_matrix(
        lf.LongForkChecker().group_states(h)[1])
    card = lf.fork_pairs_torch(torch.from_numpy(V).to(cuda),
                               torch.from_numpy(live).to(cuda)).cpu().numpy()
    missed = np.einsum("grk,gsk->grs", V, 1 - V) > 0.5
    plain = missed & missed.transpose(0, 2, 1) & live[:, :, None] & \
        live[:, None, :]
    np.testing.assert_array_equal(card, plain)


@pytest.mark.parametrize("N", [4, 12, 32, 48, 96])
def test_graph_counts_on_card_match_cpu(cuda, N):
    """graph_counts_torch on the card (its bfloat16 product on the tensor
    cores) against the same ops on CPU copies."""
    from jepsen_tpu_torch.checker import txn_graph as tg

    rng = np.random.default_rng(N)
    for p in (0.05, 0.2, 0.5):
        wrww = (rng.random((64, N, N)) < p).astype(np.float32)
        rw = rng.random((64, N, N)) < p / 2
        allm = np.maximum(wrww, rw.astype(np.float32))
        host = [torch.from_numpy(a) for a in (wrww, allm, rw)]
        for need in ((True, True), (True, False), (False, True)):
            want = tg.graph_counts_torch(*host, tg._n_iters(N), *need)
            got = tg.graph_counts_torch(*(t.to(cuda) for t in host),
                                        tg._n_iters(N), *need)
            for w, g in zip(want, got):
                assert torch.equal(g.cpu(), w), (p, need)


@pytest.mark.parametrize("anom", [None, "g1c", "g-single", "g2-item"])
def test_txn_graph_checker_on_card_matches_cpu(cuda, anom):
    """TxnGraphChecker on the card's default plane: the CPU checker's
    verdict, every key but wall_s, and the same launches."""
    from jepsen_tpu_torch.checker import txn_graph as tg

    for seed, kw in ((0, {}), (7, {"txns_per_group": 48}),
                     (23, {"buckets": (4,)})):
        buckets = kw.pop("buckets", None)
        h = sim.gen_txn_graph_history(random.Random(seed), n_txns=400,
                                      anomaly=anom, cycle_len=3, **kw)
        reset_launch_stats()
        want = tg.TxnGraphChecker(device="cpu", buckets=buckets).check({}, h)
        n = launch_stats_snapshot()["launches"]
        reset_launch_stats()
        got = tg.TxnGraphChecker(buckets=buckets).check({}, h)
        assert launch_stats_snapshot()["launches"] == n
        assert got == want
        assert got["method"] == "gpu-txn-graph" and "degraded" not in got
        assert got["valid?"] is (anom is None)


def test_graph_plane_on_card_one_launch_one_sync(cuda):
    """Two checkers pinned to one bucket on a card plane: one graph
    launch, one counted host sync for the train."""
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.checker import txn_graph as tg

    hs = [sim.gen_txn_graph_history(random.Random(s), n_txns=12)
          for s in (1, 2)]
    reset_launch_stats()
    dp.reset_dispatch_stats()
    with dp.DispatchPlane() as plane:
        c = tg.TxnGraphChecker(plane=plane, buckets=(16,))
        rs = [c.check_async({}, h) for h in hs]
        plane.flush()
        outs = [r() for r in rs]
    assert dp.DISPATCH_STATS["graph_batches"] == 1
    assert launch_stats_snapshot() == {
        "launches": 1, "escalations": 0, "host_syncs": 1,
        "donated_buffers": 0}
    assert outs == [tg.TxnGraphChecker(device="cpu", buckets=(16,))
                    .check({}, h) for h in hs]


def test_card_graph_fault_raises_unless_degrade(cuda):
    """A device fault on the graph launch: the card's plane fails the
    check with the PlaneFault; a degrade=True plane answers from the
    host census, ``degraded`` on the verdict."""
    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.checker import txn_graph as tg

    h = sim.gen_txn_graph_history(random.Random(4), n_txns=36,
                                  anomaly="g-single", cycle_len=3)
    oracle = tg.fold_txn_graph(h)
    chaos.reset_resilience()
    try:
        with chaos.chaos_plan(chaos.persistent_device_fault("cuda")):
            with dp.DispatchPlane() as plane:
                with pytest.raises(chaos.PlaneFault):
                    tg.TxnGraphChecker(plane=plane).check({}, h)
            with dp.DispatchPlane(degrade=True) as plane:
                got = tg.TxnGraphChecker(plane=plane).check({}, h)
        assert got["degraded"] is True and got["method"] == "cpu-txn-fold"
        assert {k: v for k, v in got.items() if k != "degraded"} == oracle
    finally:
        chaos.reset_resilience()


# -- the perf layer on the card ------------------------------------------


@pytest.fixture
def profile_dir(tmp_path, monkeypatch):
    """A private profile directory, and no active profile before or
    after (the port's registry only: this file imports no jax)."""
    from jepsen_tpu_torch.perf import autotune, knobs

    monkeypatch.setenv(autotune.PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    monkeypatch.delenv(autotune.PROFILE_ENV, raising=False)
    monkeypatch.delenv(autotune.FAKE_CLOCK_ENV, raising=False)
    knobs._reset_for_tests()
    yield tmp_path
    knobs._reset_for_tests()


def test_sweep_on_card_holds_parity_and_keys_the_card(cuda, profile_dir):
    """Two knobs swept on cuda:0 (the linear probe through kernel A):
    every rung's verdict equals the baseline's, and the key names the
    card and the torch and CUDA versions."""
    from jepsen_tpu_torch.perf import autotune, knobs

    before = bs.bitset_scan.launches
    only = ["dispatch.coalesce_hold_s", "wgl_bitset.rows_bucket_growth"]
    res = autotune.run_sweep(budget_s=10, only=only, device="cuda:0")
    assert bs.bitset_scan.launches > before
    assert res["key"] == {
        "backend": "cuda", "n_devices": torch.cuda.device_count(),
        "device_name": torch.cuda.get_device_name(0),
        "torch_version": torch.__version__,
        "cuda_version": str(torch.version.cuda)}
    assert sorted(res["evidence"]) == sorted(only)
    for name, rows in res["evidence"].items():
        assert len(rows) == len(knobs.KNOBS[name].domain), name
        assert all(r["parity"] for r in rows), (name, rows)
    assert not knobs.tuned()


def test_analyze_profile_on_card_keeps_the_verdict(cuda, profile_dir):
    """`analyze --profile` on the card: the profile is disclosed in
    engine_stats["perf"], and the verdict is the untuned run's."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.perf import autotune
    from jepsen_tpu_torch.store import Store

    root = str(profile_dir / "store")
    st = Store(root)
    h = sim.corrupt_history(
        sim.gen_register_history(random.Random(701), n_ops=200,
                                 n_procs=5, p_crash=0.02),
        random.Random(701))
    runs = [st.save_1({"name": f"r{i}", "workload": "register",
                       "history": History(h.ops, indexed=True)})
            for i in range(2)]
    assert cli.main(["analyze", runs[0], "--store", root]) == 1
    path = autotune.write_profile(
        {"wgl_bitset.w_buckets": (13, 15, 17, 19),
         "wgl_bitset.rows_bucket_growth": 16, "dispatch.max_batch": 64},
        key=autotune.current_key(), path=str(profile_dir / "p.json"))
    assert cli.main(["analyze", runs[1], "--store", root,
                     "--profile", path]) == 1
    untuned, tuned = (st.load_results(r) for r in runs)
    assert tuned["engine_stats"]["perf"]["tuned"] is True
    assert tuned["engine_stats"]["perf"]["profile"] == path
    keys = ("valid?", "failed_op_index", "failure")
    assert {k: tuned.get(k) for k in keys} == {
        k: untuned.get(k) for k in keys}


# -- the mesh on the card ------------------------------------------------------


def _zk_streams(n, corrupt=()):
    out = []
    for k in range(n):
        h = sim.gen_register_history(random.Random(1000 + k), n_ops=200,
                                     n_procs=5, p_crash=0.005)
        if k in corrupt:
            h = sim.corrupt_history(h, random.Random(2000 + k))
        out.append(ev_mod.history_to_events(h))
    return out


@pytest.mark.parametrize("n_keys", [16, 5])
def test_virtual_mesh_on_card_matches_cpu_mesh(cuda, n_keys):
    """check_keys over 2 virtual slots on the card (kernel A once per
    slot, each on its own stream, the verdict rows gathered onto the
    caller's stream): the verdicts of the same mesh on the CPU and of
    one device, one counted launch and one host sync (two of each with
    the corrupted keys' exact re-run), each slot launching once per
    launch."""
    streams = _zk_streams(n_keys, corrupt=(3,))
    want = sharded.check_keys(streams, device="cpu",
                              mesh=sharded.virtual_mesh("cpu", 2))
    single = sharded.check_keys(streams, mesh=False)
    reset_launch_stats()
    sharded.reset_mesh_stats()
    bs.bitset_scan.launches = 0
    got = sharded.check_keys(streams, mesh=sharded.virtual_mesh(cuda, 2))
    assert got == want == single
    stats = launch_stats_snapshot()
    assert stats["launches"] == stats["host_syncs"] == 2
    assert stats["escalations"] == 1
    assert bs.bitset_scan.launches == 4
    assert sharded.MESH_STATS["sharded_launches"] == 2
    assert sharded.MESH_STATS["last_n_devices"] == 2


def test_virtual_mesh_plane_on_card(cuda):
    """A plane over 2 virtual slots on the card: one stacked launch, one
    wait for the train, per-slot accounting; a persistent fault on slot
    1 collapses the plane to one device with the verdicts unchanged."""
    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker import dispatch as dp

    streams = _zk_streams(6)
    want = sharded.check_keys(streams, mesh=False)
    dp.reset_dispatch_stats()
    reset_launch_stats()
    mesh = sharded.virtual_mesh(cuda, 2)
    with dp.DispatchPlane(mesh=mesh) as plane:
        futs = [plane.submit(s) for s in streams]
        plane.flush()
        got = [f.result() for f in futs]
        assert launch_stats_snapshot()["host_syncs"] == 1
        assert list(dp.dispatch_stats()["per_device"]) == [
            "cuda:0[0]", "cuda:0[1]"]
        chaos.reset_resilience()
        # two earlier attributed failures: the plane's first on the slot
        # reaches chaos.note_device_failure's threshold of 3
        for _ in range(2):
            chaos.note_device_failure("cuda:0[1]")
        with chaos.chaos_plan(chaos.persistent_device_fault("cuda:0[1]")):
            futs = [plane.submit(s) for s in streams]
            plane.flush()
            faulted = [f.result() for f in futs]
        assert plane.mesh is None
    chaos.reset_resilience()
    assert [r["valid?"] for r in got] == [r["valid?"] for r in want]
    assert [r["valid?"] for r in faulted] == [r["valid?"] for r in want]


def test_mesh_over_two_cards(cuda):
    """Real slots, one card each: every block launches under its own
    card (torch.cuda.device around the launch) and the rows gather
    onto the first card. Needs 2 cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA GPUs")
    streams = _zk_streams(8, corrupt=(5,))
    slots = tuple(sharded.Slot(f"cuda:{i}", torch.device("cuda", i))
                  for i in range(2))
    mesh = sharded._mesh_over(slots)
    got = sharded.check_keys(streams, mesh=mesh)
    assert got == sharded.check_keys(streams, mesh=False)
