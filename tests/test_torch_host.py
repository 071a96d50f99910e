"""Host-side parity of the PyTorch port with the JAX package: every
copied host function gives the reference's result, field by field, on
the same seeded histories; the torch twins of the model transitions
equal the jax ones elementwise. Exact equality throughout (integer
and bit arithmetic)."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import models as r_models
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.checker import wgl_oracle as r_oracle
from jepsen_tpu.checker import wgl_pallas as r_pallas
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import models as t_models
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.checker import wgl_kfrontier as t_kf
from jepsen_tpu_torch.checker import wgl_oracle as t_oracle
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.history.history import History as THistory
from jepsen_tpu_torch import sim as t_sim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one intra-op thread keeps
    torch's pool from oversubscribing the cores under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (seed, n_ops, n_procs, p_crash, corrupt): crash-free, crashy,
#: crash-heavy, valid and invalid
CASES = [
    (1, 120, 5, 0.0, False),
    (2, 120, 5, 0.0, True),
    (3, 150, 4, 0.05, False),
    (4, 150, 4, 0.05, True),
    (5, 200, 5, 0.15, False),
    (6, 200, 6, 0.2, True),
]


def _history(seed, n_ops, n_procs, p_crash, corrupt):
    h = gen_register_history(random.Random(seed), n_ops=n_ops,
                             n_procs=n_procs, p_crash=p_crash)
    if corrupt:
        h = corrupt_history(h, random.Random(seed))
    return h


def _both_events(case):
    h = _history(*case)
    return r_ev.history_to_events(h), t_ev.history_to_events(
        THistory(h.to_dicts()))


def _assert_same_fields(a, b, cls):
    for f in dataclasses.fields(cls):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("case", CASES)
def test_history_to_events_and_steps(case):
    rev, tev = _both_events(case)
    _assert_same_fields(rev, tev, t_ev.EventStream)
    assert np.array_equal(r_ev.crashed_invokes(rev),
                          t_ev.crashed_invokes(tev))
    for W in sorted({max(rev.window, 1), 16, 32, 64}):
        if W < rev.window:
            continue
        rst, tst = r_ev.events_to_steps(rev, W), t_ev.events_to_steps(tev, W)
        _assert_same_fields(rst, tst, t_ev.ReturnSteps)
        # memo_on: the second request is the memoized object
        assert t_ev.events_to_steps(tev, W) is tst
        n = t_ev.bucket(max(len(tst), 1), 64)
        assert n == r_ev.bucket(max(len(rst), 1), 64)
        _assert_same_fields(rst.padded(n), tst.padded(n), t_ev.ReturnSteps)


def test_bucket_and_slot_bits():
    for n in (0, 1, 63, 64, 65, 1000, 4097):
        assert t_ev.bucket(n) == r_ev.bucket(n)
        assert t_ev.bucket(n, 8) == r_ev.bucket(n, 8)
    for W in (1, 12, 31, 32, 33, 64, 128):
        a, b = r_ev.slot_bit_table(W), t_ev.slot_bit_table(W)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_bitset_host_helpers(case):
    rev, tev = _both_events(case)
    m_r = r_models.model("cas-register")
    m_t = t_models.model("cas-register")
    got = t_bs.plan(m_t, tev.window, len(tev.value_codes))
    assert got == r_bs.plan(m_r, rev.window, len(rev.value_codes))
    W = got[0] if got else 19
    if rev.window > W:
        return
    rst, tst = r_ev.events_to_steps(rev, W), t_ev.events_to_steps(tev, W)
    for a, b in zip(r_bs.pack_steps(rst), t_bs.pack_steps(tst)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for S in (8, 16):
        assert np.array_equal(r_bs.init_frontier(rst.init_state, S, W),
                              t_bs.init_frontier(tst.init_state, S, W))
    assert np.array_equal(r_bs.required_buckets(rst),
                          t_bs.required_buckets(tst))
    for w_low in (4, 8, 12, W):
        assert r_bs.split_point(rst, w_low) == t_bs.split_point(tst, w_low)
    for min_len in (None, 1, 16, 64):
        assert r_bs.plan_segments(rst, min_len) == t_bs.plan_segments(
            tst, min_len)


@pytest.mark.parametrize("case", CASES[:4])
def test_kfrontier_pack_steps(case):
    rev, tev = _both_events(case)
    W = 32
    if rev.window > W:
        pytest.skip("window beyond one mask word")
    rst, tst = r_ev.events_to_steps(rev, W), t_ev.events_to_steps(tev, W)
    for a, b in zip(r_pallas.pack_steps(rst), t_kf.pack_steps(tst)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_plan_gates_on_envelope_edges():
    m_r = r_models.model("cas-register")
    m_t = t_models.model("cas-register")
    for window in (1, 11, 12, 13, 16, 19, 20, 40):
        for codes in (1, 6, 7, 15, 30, 31, 40):
            assert t_bs.plan(m_t, window, codes) == r_bs.plan(
                m_r, window, codes)
    for name in ("register", "mutex", "unordered-queue"):
        assert t_bs.plan(t_models.model(name), 10, 3) == r_bs.plan(
            r_models.model(name), 10, 3)


def test_decode_frontier_matches():
    rev, tev = _both_events((11, 80, 5, 0.05, True))
    W = 12
    rst, tst = r_ev.events_to_steps(rev, W), t_ev.events_to_steps(tev, W)
    rng = np.random.default_rng(0)
    fr = np.zeros((8, r_bs.bitset_words(W)), np.int32)
    fr[rng.integers(0, 8, 12), rng.integers(0, 4, 12)] = rng.integers(
        -2**31, 2**31 - 1, 12, dtype=np.int64).astype(np.int32)
    dec_r = {c: k for k, c in rev.value_codes.items()}
    for died in (int(rst.op_index[len(rst) // 2]), -7):
        a = r_bs.decode_frontier(fr, rst, died, "cas-register",
                                 decode_value=dec_r.get)
        b = t_bs.decode_frontier(fr, tst, died, "cas-register",
                                 decode_value=dec_r.get)
        assert a == b


@pytest.mark.parametrize("case", CASES[:4])
def test_python_oracle(case):
    rev, tev = _both_events(case)
    assert rev.window <= 14  # the oracle is exponential in the window
    va, sa = r_oracle.check_events(rev, return_stats=True)
    vb, sb = t_oracle.check_events(tev, return_stats=True)
    assert va == vb and sa == sb  # verdict, death configs, open ops


def test_from_reference_round_trip():
    rev, tev = _both_events(CASES[3])
    got = from_reference(rev)
    _assert_same_fields(got, tev, t_ev.EventStream)
    rst = r_ev.events_to_steps(rev, 16)
    st = from_reference(rst)
    _assert_same_fields(st, t_ev.events_to_steps(tev, 16), t_ev.ReturnSteps)
    st.occ[:] = False  # a copy: the reference's arrays are untouched
    assert rst.occ.any()
    with pytest.raises(TypeError):
        from_reference(object())


def test_sim_copies_generate_the_same_histories():
    for seed in range(3):
        a = gen_register_history(random.Random(seed), n_ops=50, n_procs=4,
                                 p_crash=0.1)
        b = t_sim.gen_register_history(random.Random(seed), n_ops=50,
                                       n_procs=4, p_crash=0.1)
        assert a.to_dicts() == b.to_dicts()
        ca = corrupt_history(a, random.Random(seed + 10))
        cb = t_sim.corrupt_history(b, random.Random(seed + 10))
        assert ca.to_dicts() == cb.to_dicts()


@pytest.mark.parametrize("name", ["cas-register", "register", "mutex",
                                  "unordered-queue-packed"])
def test_model_step_twins(name):
    """step_torch == step_jax elementwise over a [K, 1] x [1, W] grid of
    states and ops, and the bitset slot transitions likewise."""
    rng = np.random.default_rng(5)
    K, W = 16, 12
    if name == "unordered-queue-packed":
        state = rng.integers(0, 1 << 24, (K, 1)).astype(np.int32)
        a = rng.integers(-1, 7, (1, W)).astype(np.int32)
    else:
        state = rng.integers(-1, 6, (K, 1)).astype(np.int32)
        a = rng.integers(-1, 6, (1, W)).astype(np.int32)
    f = rng.integers(0, 3 if "register" in name else 2, (1, W)).astype(
        np.int32)
    b = rng.integers(-1, 6, (1, W)).astype(np.int32)
    ok_r, s_r = r_models.model(name).step_jax(
        jnp.asarray(state), jnp.asarray(f), jnp.asarray(a), jnp.asarray(b))
    ok_t, s_t = t_models.model(name).step_torch(
        torch.from_numpy(state), torch.from_numpy(f), torch.from_numpy(a),
        torch.from_numpy(b))
    ok_r = np.broadcast_to(np.asarray(ok_r), (K, W))
    ok_t = np.broadcast_to(ok_t.numpy(), (K, W))
    assert np.array_equal(ok_r, ok_t)
    s_r = np.broadcast_to(np.asarray(s_r), (K, W))
    s_t = np.broadcast_to(s_t.numpy(), (K, W))
    assert np.array_equal(s_r[ok_r], s_t[ok_t])
    slot_r = r_models.model(name).bitset_slot_jax
    slot_t = t_models.model(name).bitset_slot
    assert (slot_r is None) == (slot_t is None)
    if slot_r is not None:
        for x, y in zip(
            slot_r(jnp.asarray(f[0]), jnp.asarray(a[0]), jnp.asarray(b[0])),
            slot_t(torch.from_numpy(f[0]), torch.from_numpy(a[0]),
                   torch.from_numpy(b[0])),
        ):
            x = np.broadcast_to(np.asarray(x), (W,))
            y = np.broadcast_to(np.asarray(y), (W,))
            assert np.array_equal(x.astype(np.int64), y.astype(np.int64))
