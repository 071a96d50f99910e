"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on the card. Marked cuda: each test skips where there
is no GPU (the kernels have no CPU mode). The file imports only the
port, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance: exact equality (integer and bit arithmetic)."""

import random

import pytest
import torch

from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker import events as ev_mod
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker import wgl_kfrontier as kf
from jepsen_tpu_torch.checker.linearizable import check_events_bucketed

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _histories(W, nv, seed):
    h = sim.gen_register_history(random.Random(seed), n_ops=48, n_procs=W,
                                 n_values=nv, p_crash=0.0)
    return h, sim.corrupt_history(h, random.Random(seed + 1), n_values=nv)


@pytest.mark.parametrize("W,S", [(12, 8), (16, 32), (17, 8), (19, 32)])
def test_bitset_kernel_matches_plain(cuda, W, S):
    nv = 5 if S == 8 else 24
    for h in _histories(W, nv, 10 * W + S):
        st = ev_mod.events_to_steps(ev_mod.history_to_events(h), W=W)
        st = st.padded(ev_mod.bucket(len(st), 64))
        win, meta = bs.pack_steps(st)
        fr0 = bs.init_frontier(st.init_state, S, W)[None]
        args = [torch.from_numpy(a).to(cuda)
                for a in (win[None], meta[None], fr0)]
        fits = S * bs.bitset_words(W) * 4 <= bs.SMEM_FRONTIER_BYTES
        for exact in (False, True):
            want = bs.bitset_scan_plain(*args, "cas-register", S, W,
                                        exact=exact)
            for placement in ("shared", "global") if fits else ("global",):
                got = bs.bitset_scan(*args, "cas-register", S, W,
                                     exact=exact, placement=placement)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (exact, placement)
                assert torch.equal(got[1], want[1]), (exact, placement)


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
        kf.kfrontier_scan(kwin, kmeta, "cas-register", 4096, 8)
    with pytest.raises(TypeError):
        kf.kfrontier_scan(kwin.long(), kmeta, "cas-register", 128, 8)
