"""The port's K-frontier scans against the JAX package's, exactly.

- kfrontier_scan_plain, the plain PyTorch version of the single-word
  CUDA kernel, against jepsen_tpu's Pallas megakernel (_pallas_scan) in
  interpret mode on the same packed inputs: the whole out row (alive,
  overflow, died op, rounds, first tainted step) at K=128 and W in
  {8, 16, 32}, including a history that overflows K and a window whose
  slot 31 makes the returning slot's bit the int32 sign bit;
- wgl_torch.check_steps_torch against wgl_jax.check_steps_jax with two
  mask words (W=64).

The CUDA kernel against the plain version: tests/test_torch_cuda.py."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import wgl_pallas as r_pallas
from jepsen_tpu.checker.wgl_jax import check_steps_jax
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import wgl_kfrontier as t_kf
from jepsen_tpu_torch.checker import wgl_torch as t_wgl
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.history.history import History as THistory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one intra-op thread keeps
    torch's pool from oversubscribing the cores under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 128


def _register(seed, n_ops, n_procs, p_crash, corrupt=False):
    h = gen_register_history(random.Random(seed), n_ops=n_ops,
                             n_procs=n_procs, p_crash=p_crash)
    return corrupt_history(h, random.Random(seed)) if corrupt else h


def _counter(corrupt=False):
    """32 clients: slots 0..31 open at once; the port's generator, fed
    to both packages as op dicts."""
    h = t_sim.gen_cas_counter_history(random.Random(24), n_rounds=2,
                                      n_procs=32)
    if corrupt:
        h = t_sim.corrupt_history(h, random.Random(25), n_values=33)
    from jepsen_tpu.history.history import History

    return History(h.to_dicts())


#: id -> (W, padded steps, history factory)
CASES = {
    "w8-crashy": (8, 64, lambda: _register(21, 60, 4, 0.05)),
    "w8-invalid": (8, 64, lambda: _register(21, 60, 4, 0.05, True)),
    "w16-crashy": (16, 128, lambda: _register(22, 60, 5, 0.1)),
    "w16-overflow": (16, 128, lambda: _register(23, 80, 14, 0.0)),
    "w32-counter": (32, 128, lambda: _counter()),
    "w32-counter-invalid": (32, 128, lambda: _counter(True)),
}


def _steps(case):
    W, n, make = CASES[case]
    ev = r_ev.history_to_events(make())
    assert ev.window <= W
    st = r_ev.events_to_steps(ev, W=W)
    assert len(st) <= n
    return st.padded(n), W


@pytest.mark.parametrize("case", list(CASES))
def test_plain_scan_matches_reference_megakernel(case):
    st, W = _steps(case)
    win, meta = r_pallas.pack_steps(st)
    want = np.asarray(r_pallas._pallas_scan(
        win[None], meta[None], model_name="cas-register", K=K, W=W,
        interpret=True))
    tw, tm = t_kf.pack_steps(from_reference(st))
    got = t_kf.kfrontier_scan(torch.from_numpy(tw[None]),
                              torch.from_numpy(tm[None]), "cas-register",
                              K, W).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want), (got, want)
    if case == "w16-overflow":
        assert got[0, 0, 1] == 1  # the taint fired: K was too small
    if case.startswith("w32"):
        assert int(tm[:, 0, 0].min()) == -2**31  # slot 31's bit
        assert got[0, 0, 0] == (0 if case.endswith("invalid") else 1)


def test_check_steps_kfrontier_entry():
    st, W = _steps("w8-invalid")
    want = r_pallas.check_steps_pallas(st, K=K, interpret=True)
    got = t_kf.check_steps_kfrontier(from_reference(st), K=K, device="cpu")
    assert got == want


def _wide(kind):
    """Windows of 33..64 slots (two mask words)."""
    if kind == "crashy":
        h = gen_register_history(random.Random(8), n_ops=80, n_procs=40,
                                 p_crash=0.3)
    else:
        h = t_sim.gen_cas_counter_history(random.Random(9), n_rounds=1,
                                          n_procs=40)
        if kind == "invalid":
            h = t_sim.corrupt_history(h, random.Random(9), n_values=41)
        from jepsen_tpu.history.history import History

        h = History(h.to_dicts())
    ev = r_ev.history_to_events(h)
    assert 32 < ev.window <= 64
    st = r_ev.events_to_steps(ev, W=64).padded(128)
    assert st.NW == 2
    return st


@pytest.mark.parametrize("kind", ["valid", "invalid", "crashy"])
def test_multiword_torch_scan_matches_jax(kind):
    st = _wide(kind)
    want = check_steps_jax(st, K=K)
    got = t_wgl.check_steps_torch(from_reference(st), K=K, device="cpu")
    assert got == want
    if kind != "crashy":
        assert got == ((True, False, -1) if kind == "valid"
                       else (False, False, got[2]))


def test_torch_history_feeds_both_packages():
    """Op dicts from either package's History give identical steps."""
    h = _counter()
    a = r_ev.events_to_steps(r_ev.history_to_events(h), W=32)
    from jepsen_tpu_torch.checker import events as t_ev

    b = t_ev.events_to_steps(
        t_ev.history_to_events(THistory(h.to_dicts())), W=32)
    for name in ("occ", "f", "a", "b", "slot", "crashed", "op_index"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
