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
        assert check_events_bucketed(ev) == check_events_bucketed(
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
            "launches": n, "escalations": n - 1, "host_syncs": n}
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
