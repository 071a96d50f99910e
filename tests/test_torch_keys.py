"""The multi-key batch of the port (jepsen_tpu_torch.checker.sharded,
wgl_bitset.check_keys_bitset, wgl_kfrontier.check_keys_kfrontier,
wgl_torch.wgl_scan_keys) against the JAX package's, on the CPU:

- the batched plain kernels against the reference's Pallas kernels in
  interpret mode on 3-key inputs of unequal length, different init
  states and a blank key, bit for bit;
- the key-batched torch-ops scan against the reference's _wgl_vmap and
  against the port's single-key scan, key by key, blank padding keys
  included;
- check_keys against the reference's check_keys(mesh=False,
  interpret=True): per key valid?, failed_op_index, frontier_k and
  escalations, the method (mapped tpu-* -> gpu-*), and the launch and
  host-sync counts.

On the CPU the reference takes its vmap tier (tpu-wgl-batch) where the
port takes kernel B's plain version (gpu-wgl-kfrontier-batch): the
port's tier does not depend on the device, the reference's does
(sharded.py:518, 555). There only the method may differ, and the
host-sync count where a key escalates (the reference's single-key jax
rung fetches without its counted funnel).

Tolerance: exact equality (integer and bit arithmetic). Every
interpret-mode input of kernel A pads to 64 steps at W=12, S=8 in a
batch of 3, so the reference compiles it once a tier; kernel B's runs
once, at K=32."""

import importlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import sharded as r_sh
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.checker import wgl_pallas as r_pl
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import events as t_ev
from jepsen_tpu_torch.checker import sharded as t_sh
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.checker import wgl_kfrontier as t_kf
from jepsen_tpu_torch.checker import wgl_torch as t_wt
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats

r_lin = importlib.import_module("jepsen_tpu.checker.linearizable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one intra-op thread keeps
    torch's pool from oversubscribing the cores under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference's batch method names -> the port's
METHOD = {
    "tpu-wgl-bitset-batch": "gpu-wgl-bitset-batch",
    "tpu-wgl-pallas-batch": "gpu-wgl-kfrontier-batch",
    "tpu-wgl-batch": "gpu-wgl-batch",
    "tpu-wgl-bitset": "gpu-wgl-bitset",
    "tpu-wgl-pallas": "gpu-wgl-kfrontier",
    "tpu-wgl": "gpu-wgl",
    "cpu-oracle-native": "cpu-oracle-native",
    "cpu-oracle-python": "cpu-oracle-python",
}

#: where the reference's CPU tier is its vmap (or jax) scan and the
#: port's is kernel B
CPU_TIER_DIFFERS = {
    ("gpu-wgl-batch", "gpu-wgl-kfrontier-batch"),
    ("gpu-wgl", "gpu-wgl-kfrontier"),
}

#: (seed, n_ops, n_procs, p_crash, n_values, corrupt, init_value) of the
#: register keys: windows <= 12, at most 64 return steps each
KEYS = (
    (300, 30, 4, 0.05, 3, False, None),
    (301, 50, 5, 0.0, 3, True, 1),
    (302, 40, 3, 0.1, 4, False, 2),
)


def _register(seed, n_ops, n_procs, p_crash, n_values, corrupt):
    h = gen_register_history(random.Random(seed), n_ops=n_ops,
                             n_procs=n_procs, n_values=n_values,
                             p_crash=p_crash)
    if corrupt:
        h = corrupt_history(h, random.Random(seed), n_values=n_values)
    return h


def _streams(keys, corrupt=True):
    """Reference and port event streams of the same histories; with
    corrupt=False the histories are left valid: uncorrupted, from the
    generator's initial value."""
    ref, port = [], []
    for seed, n_ops, n_procs, p_crash, nv, bad, init in keys:
        h = _register(seed, n_ops, n_procs, p_crash, nv, bad and corrupt)
        ev = r_ev.history_to_events(h, init_value=init if corrupt else None)
        ref.append(ev)
        port.append(from_reference(ev))
    return ref, port


def _compare(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        mapped = METHOD[w["method"]]
        if (mapped, g["method"]) not in CPU_TIER_DIFFERS:
            assert g["method"] == mapped, (i, g, w)
        for k in ("valid?", "failed_op_index", "frontier_k", "escalations"):
            assert g.get(k) == w.get(k), (i, k, g, w)


# -- kernel A ------------------------------------------------------------------


def test_batched_bitset_plain_matches_reference_interpret():
    """Kernel A's plain version on a [3, ...] batch: two keys of
    different lengths and init states, one dying, and a blank key (no
    live steps, the reference's mesh padding row), both tiers: out and
    fr_out equal to the reference's interpret-mode kernel."""
    W, S, n = 12, 8, 64
    ref, _ = _streams(KEYS[:2])
    wins, metas, frs = [], [], []
    for ev in ref:
        st = r_ev.events_to_steps(ev, W=W)
        assert len(st) < n
        win, meta = r_bs.pack_steps(st.padded(n))
        t_win, t_meta = t_bs.pack_steps(from_reference(st).padded(n))
        assert np.array_equal(win, t_win) and np.array_equal(meta, t_meta)
        wins.append(win)
        metas.append(meta)
        frs.append(r_bs.init_frontier(st.init_state, S, W))
    assert len({ev.init_state for ev in ref}) == 2
    wins.append(np.zeros_like(wins[0]))
    metas.append(np.zeros_like(metas[0]))
    frs.append(r_bs.init_frontier(0, S, W))
    win, meta, fr0 = np.stack(wins), np.stack(metas), np.stack(frs)
    dead = []
    for exact in (False, True):
        want_o, want_f = (np.asarray(x) for x in r_bs._bitset_scan(
            jnp.asarray(win), jnp.asarray(meta), jnp.asarray(fr0),
            model_name="cas-register", S=S, W=W, interpret=True,
            exact=exact))
        got_o, got_f = t_bs.bitset_scan_plain(
            torch.from_numpy(win), torch.from_numpy(meta),
            torch.from_numpy(fr0), "cas-register", S, W, exact=exact)
        assert np.array_equal(got_o.numpy(), want_o), exact
        assert np.array_equal(got_f.numpy(), want_f), exact
        dead.append([int(o) for o in want_o[:, 0, 0]])
    assert dead[1] == [1, 0, 1]  # the corrupted key dies, the blank lives


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
def test_check_keys_bitset_batch_matches_reference(corrupt):
    """The exact bitset batch: one launch and one host sync for the
    clean batch, and one exact re-run of the whole batch (two of each,
    one escalation) when a key dies on the fast tier; every key's
    verdict equal to the reference's, as are the counts."""
    ref, port = _streams(KEYS, corrupt=corrupt)
    r_bs.reset_launch_stats()
    want = r_sh.check_keys(ref, mesh=False, interpret=True)
    r_stats = dict(r_bs.LAUNCH_STATS)
    reset_launch_stats()
    got = t_sh.check_keys(port, device="cpu")
    stats = launch_stats_snapshot()
    _compare(got, want)
    assert {r["method"] for r in got} == {"gpu-wgl-bitset-batch"}
    assert any(not r["valid?"] for r in got) == corrupt
    n = 2 if corrupt else 1
    assert stats == {"launches": n, "escalations": n - 1, "host_syncs": n,
                     "donated_buffers": 0}
    assert {k: r_stats[k] for k in stats} == stats


def test_launch_keys_bitset_memoizes_per_pad_length():
    """Per-key packing is memoized on the steps, keyed by the batch's
    pad length: a second batch repacks nothing."""
    _, port = _streams(KEYS[:2])
    steps = [t_ev.events_to_steps(ev, W=12) for ev in port]
    t_bs.check_keys_bitset(steps, S=8, device="cpu")
    packed = [st._batch_args[64] for st in steps]
    t_bs.check_keys_bitset(steps, S=8, device="cpu")
    assert all(st._batch_args[64] is p for st, p in zip(steps, packed))


# -- kernel B and the torch-ops batch ----------------------------------------


def _wide_value_streams():
    """Register keys at a window of one mask word, key 2 with more
    distinct values than the bitset's 32 state rows (so bs.plan
    declines the batch): kernel B's tier. Key 1 is corrupted; keys
    differ in length. At K=32 key 0 lives with an overflow, key 1 dies
    without one and key 2 dies with one."""
    ref, port = [], []
    for seed, n_ops in ((310, 70), (311, 90), (312, 160)):
        h = gen_register_history(random.Random(seed), n_ops=n_ops,
                                 n_procs=4, n_values=60, p_crash=0.05)
        if seed == 311:
            h = corrupt_history(h, random.Random(seed), n_values=60)
        ev = r_ev.history_to_events(h)
        ref.append(ev)
        port.append(from_reference(ev))
    return ref, port


def test_batched_kfrontier_plain_matches_reference_interpret():
    """Kernel B's plain version on a 3-key batch of unequal lengths
    (padded to one bucket, one key dying) against the reference's
    interpret-mode kernel at the batch's window bucket, K=32: out
    equal."""
    ref, _ = _wide_value_streams()
    W = r_lin._bucket_window(max(ev.window for ev in ref))
    steps = [r_ev.events_to_steps(ev, W=W) for ev in ref]
    assert len({len(st) for st in steps}) == 3
    n = r_ev.bucket(max(len(st) for st in steps), 64)
    packed = [r_pl.pack_steps(st.padded(n)) for st in steps]
    for st, (w, m) in zip(steps, packed):
        tw, tm = t_kf.pack_steps(from_reference(st).padded(n))
        assert np.array_equal(w, tw) and np.array_equal(m, tm)
    win = np.stack([w for w, _ in packed])
    meta = np.stack([m for _, m in packed])
    want = np.asarray(r_pl._pallas_scan(
        jnp.asarray(win), jnp.asarray(meta), model_name="cas-register",
        K=32, W=W, interpret=True))
    got = t_kf.kfrontier_scan_plain(torch.from_numpy(win),
                                    torch.from_numpy(meta),
                                    "cas-register", 32, W)
    assert np.array_equal(got.numpy(), want)
    assert want[:, 0, :2].tolist() == [[1, 1], [0, 0], [0, 1]]


@pytest.mark.parametrize("k_ladder", [(128, 256, 1024), (32, 128)],
                         ids=["definite", "escalating"])
def test_check_keys_kfrontier_batch_matches_reference(k_ladder):
    """Keys outside the bitset envelope, inside _pallas_ok: one kernel-B
    launch and one host sync for the batch; with a first rung of K=32
    the overflow-tainted death escalates that key alone through
    check_events_bucketed, counting the batch rung."""
    ref, port = _wide_value_streams()
    r_bs.reset_launch_stats()
    want = r_sh.check_keys(ref, mesh=False, interpret=True,
                           k_ladder=k_ladder)
    r_syncs = r_bs.LAUNCH_STATS["host_syncs"]
    reset_launch_stats()
    before = t_kf.kfrontier_scan.launches
    got = t_sh.check_keys(port, k_ladder=k_ladder, device="cpu")
    stats = launch_stats_snapshot()
    _compare(got, want)
    assert t_kf.kfrontier_scan.launches == before  # the plain version
    assert {r["method"] for r in want} <= {"tpu-wgl-batch", "tpu-wgl"}
    assert got[1]["valid?"] is False
    escalated = [r for r in got if r["escalations"]]
    if k_ladder[0] == 32:
        assert escalated
        assert {r["method"] for r in escalated} == {"gpu-wgl-kfrontier"}
    else:
        assert not escalated
        assert {r["method"] for r in got} == {"gpu-wgl-kfrontier-batch"}
        assert stats["host_syncs"] == r_syncs == 1
    # one batch fetch, then one per escalated key's rung
    assert stats["host_syncs"] == 1 + len(escalated)


def _counter_streams(n_procs, corrupt_key):
    ref, port = [], []
    for k, rounds in enumerate((1, 2)):
        h = t_sim.gen_cas_counter_history(random.Random(320 + k),
                                          n_rounds=rounds, n_procs=n_procs)
        if k == corrupt_key:
            h = t_sim.corrupt_history(h, random.Random(330),
                                      n_values=n_procs + 1)
        from jepsen_tpu.history.history import History

        ev = r_ev.history_to_events(History(h.to_dicts()))
        ref.append(ev)
        port.append(from_reference(ev))
    return ref, port


@pytest.mark.parametrize("W,K,n_procs", [(8, 4, 5), (64, 8, 34)],
                         ids=["one-word", "two-words"])
def test_torch_key_batch_matches_vmap_and_single_key(W, K, n_procs):
    """wgl_scan_keys on stack_streams' columns (a blank padding key
    appended) against the reference's _wgl_vmap on the reference's
    stacked columns, and against the single-key wgl_scan_steps per key;
    K small enough that some key overflows."""
    ref, port = _counter_streams(n_procs, corrupt_key=1)
    r_cols = r_sh.stack_streams(ref, W=W, n_keys=3)
    t_cols = t_sh.stack_streams(port, W=W, n_keys=3)
    for a, b in zip(r_cols, t_cols):
        assert np.array_equal(np.asarray(a), b)
    want = [np.asarray(x) for x in r_sh._wgl_vmap(
        *(jnp.asarray(c) for c in r_cols), model_name="cas-register",
        K=K, W=W)]
    got = [x.numpy() for x in t_wt.wgl_scan_keys(
        t_cols, "cas-register", K, torch.device("cpu"))]
    assert [list(map(int, g)) for g in got] == [
        list(map(int, w)) for w in want]
    assert [int(g) for g in got[0]][2] == 1  # the blank key is alive
    assert any(got[1])  # some key overflowed
    for i, ev in enumerate(port):
        st = t_ev.events_to_steps(ev, W=W)
        single = t_wt.wgl_scan_steps(st.padded(t_cols[0].shape[1]),
                                     "cas-register", K, torch.device("cpu"))
        assert single == (bool(got[0][i]), bool(got[1][i]), int(got[2][i]))


def test_check_keys_torch_batch_matches_reference():
    """Windows past kernel B's one word: the torch-ops batch
    (gpu-wgl-batch), one host fetch for the batch's verdicts."""
    ref, port = _counter_streams(34, corrupt_key=None)
    want = r_sh.check_keys(ref, mesh=False, k_ladder=(48, 128))
    reset_launch_stats()
    got = t_sh.check_keys(port, k_ladder=(48, 128), device="cpu")
    _compare(got, want)
    assert {r["method"] for r in got} == {"gpu-wgl-batch"}
    assert all(r["valid?"] for r in got)
    assert launch_stats_snapshot()["host_syncs"] == 1


def test_mixed_envelope_queue_batch_matches_reference():
    """A rich-state (unordered-queue) batch with keys inside and outside
    the packed envelope: the in-envelope keys ride kernel B under the
    packed variant, the rest go to the host oracle (check_streams)."""
    from jepsen_tpu.history.history import History

    ref, port = [], []
    for seed, nv in ((340, 3), (341, 9), (342, 4)):
        h = t_sim.gen_queue_history(random.Random(seed), n_ops=30,
                                    n_procs=3, n_values=nv, p_crash=0.05)
        ev = r_ev.history_to_events(History(h.to_dicts()),
                                    model="unordered-queue")
        ref.append(ev)
        port.append(from_reference(ev))
    want = r_sh.check_keys(ref, model="unordered-queue", mesh=False)
    got = t_sh.check_keys(port, model="unordered-queue", device="cpu")
    _compare(got, want)
    assert got[1]["method"] == "cpu-oracle-python"  # tuple state: no C++
    assert got[0]["method"] == "gpu-wgl-kfrontier-batch"


def test_check_keys_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = _streams(KEYS[:1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_sh.check_keys(port)
    assert t_sh.check_keys([], device="cpu") == []
