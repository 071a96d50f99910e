"""The transactional dependency-graph checker of the port
(jepsen_tpu_torch.checker.txn_graph) against the JAX package's
(jepsen_tpu.checker.txn_graph), on the CPU.

Each package builds its own histories with its own generator
(gen_txn_graph_history; same seed, same ops), then:

- the edge rules: extract_edges, fold_edges and fold_txn_graph on the
  edge-rule cases of tests/test_txn_graph.py and on seeded histories,
  every edge array, warning and verdict equal;
- the device program: graph_counts_torch on CPU tensors against the
  reference's _graph_counts_body on JAX-CPU, random [B, N, N] stacks for
  N in {4, 12, 32, 48} (the reference's packed branch and its matmul)
  and every need pair;
- the checker: TxnGraphChecker(device="cpu") against the reference's
  TxnGraphChecker and fold_txn_graph, every key equal but ``method``
  and ``wall_s`` (the components extra, matmul_rounds, witnesses and
  census included), and the stats both packages count;
- the oversize solo route, coalescing on a CPU plane, and the fault
  departures (a degrading plane answers from the host census, a Python
  error and a non-degrading plane's PlaneFault reach the caller).

Tolerance: exact (integer counts and edge arrays)."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import sim as r_sim
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import txn_graph as rtg
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.history.ops import invoke_op as r_invoke, ok_op as r_ok

from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import chaos
from jepsen_tpu_torch.checker import dispatch as t_dp
from jepsen_tpu_torch.checker import txn_graph as ttg
from jepsen_tpu_torch.device import launch_stats_snapshot, reset_launch_stats
from jepsen_tpu_torch.history.history import History as THistory
from jepsen_tpu_torch.history.ops import invoke_op as t_invoke, ok_op as t_ok

pytestmark = pytest.mark.txn_graph

ANOMS = (None, "g1c", "g-single", "g2-item")

#: the TXN_GRAPH_STATS both packages count (the port has no
#: row-sharded launches)
STATS = ("encodes", "extracts", "extract_memo_hits", "graph_prog_compiles",
         "graph_prog_hits", "edges_wr", "edges_ww", "edges_rw",
         "device_graphs", "matmul_rounds", "oversize_components",
         "host_fallback_components", "oracle_folds")


def _strip(v: dict) -> dict:
    return {k: x for k, x in v.items() if k not in ("method", "wall_s")}


def _histories(seed, **kw):
    """The same seeded history from each package's generator."""
    return (r_sim.gen_txn_graph_history(random.Random(seed), **kw),
            t_sim.gen_txn_graph_history(random.Random(seed), **kw))


def _H(txns):
    """ok txn histories (reference, port) from completed micro-op lists."""
    out = []
    for History, invoke_op, ok_op in ((RHistory, r_invoke, r_ok),
                                      (THistory, t_invoke, t_ok)):
        ops = []
        for i, mops in enumerate(txns):
            ops.append(invoke_op(i % 5, "txn", [list(m) for m in mops]))
            ops.append(ok_op(i % 5, "txn", [list(m) for m in mops]))
        out.append(History(ops))
    return out


def _same_edges(a, b):
    for cls in ttg.EDGE_CLASSES:
        got, want = getattr(a, cls), getattr(b, cls)
        assert got.dtype == want.dtype and np.array_equal(got, want), cls
    assert a.n_txns == b.n_txns
    assert a.keys == b.keys and a.warnings == b.warnings
    assert np.array_equal(a.op_index, b.op_index)


def _both_checks(rh, th, **kw):
    """(reference verdict, port verdict, reference stats, port stats)."""
    rtg.reset_txn_graph_stats()
    ttg.reset_txn_graph_stats()
    r = rtg.TxnGraphChecker(**kw).check({}, rh)
    t = ttg.TxnGraphChecker(device="cpu", **kw).check({}, th)
    rs = {k: rtg.TXN_GRAPH_STATS[k] for k in STATS}
    ts = {k: ttg.TXN_GRAPH_STATS[k] for k in STATS}
    return r, t, rs, ts


# -- the edge rules ------------------------------------------------------------

EDGE_CASES = {
    "wr_from_observed_append": [
        [("append", "a", 1)],
        [("r", "a", [1])],
    ],
    "ww_from_append_chain": [
        [("append", "a", 1)],
        [("append", "a", 2)],
        [("r", "a", [1, 2])],
    ],
    "rw_from_prefix_read": [
        [("append", "a", 1)],
        [("append", "a", 2)],
        [("r", "a", [1, 2])],
        [("r", "a", [1])],
    ],
    "rw_from_empty_read_single_append": [
        [("append", "a", 1)],
        [("r", "a", [])],
    ],
    "register_edges": [
        [("w", "k", 5), ("w", "k2", 9)],
        [("r", "k", 5)],
        [("r", "k", 5), ("w", "k", 7)],
        [("r", "k2", None)],
    ],
    "incompatible_prefix": [
        [("append", "a", 1)],
        [("append", "a", 2)],
        [("r", "a", [1, 2])],
        [("r", "a", [2])],
    ],
    "write_skew": [
        [("r", "x", None), ("w", "y", 1)],
        [("r", "y", None), ("w", "x", 1)],
    ],
    "mixed_key_mode_and_phantom": [
        [("append", "a", 1), ("w", "b", 3)],
        [("r", "a", [1, 9]), ("r", "b", [3])],
        [("r", "a", [1])],
    ],
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_rules_match_reference(case):
    rh, th = _H(EDGE_CASES[case])
    _same_edges(ttg.extract_edges(ttg.encode_txn_graph(th)),
                rtg.extract_edges(rtg.encode_txn_graph(rh)))
    _same_edges(ttg.fold_edges(th), rtg.fold_edges(rh))
    want = rtg.fold_txn_graph(rh)
    assert _strip(ttg.fold_txn_graph(th)) == _strip(want)
    r, t, rs, ts = _both_checks(rh, th)
    assert _strip(t) == _strip(r) and ts == rs
    assert t["method"] == "gpu-txn-graph"


def test_encoded_plane_matches_reference():
    rh, th = _histories(5, n_txns=40, anomaly="g1c", cycle_len=4)
    rp, tp = rtg.encode_txn_graph(rh), ttg.encode_txn_graph(th)
    for f in ("op_index", "txn_id", "op", "key", "ver", "pos", "obs_ptr",
              "obs_len", "obs_ver", "ver_key", "append_key"):
        got, want = getattr(tp, f), getattr(rp, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (tp.n_txns, tp.keys, tp.ver_val, tp.warnings) == \
        (rp.n_txns, rp.keys, rp.ver_val, rp.warnings)


@pytest.mark.parametrize("seed", range(6))
def test_fold_extract_parity_seeded(seed):
    for anom in ANOMS:
        rh, th = _histories(seed, n_txns=60, anomaly=anom,
                            cycle_len=2 + seed % 6)
        a = ttg.extract_edges(ttg.encode_txn_graph(th))
        _same_edges(a, ttg.fold_edges(th))
        _same_edges(a, rtg.extract_edges(rtg.encode_txn_graph(rh)))


@pytest.mark.parametrize("seed,anom", [(s, a) for s in (0, 3)
                                       for a in ANOMS])
def test_gen_txn_graph_history_matches_reference(seed, anom):
    rh, th = _histories(seed, n_txns=50, anomaly=anom, cycle_len=3,
                        keys_per_group=2 + seed, txns_per_group=7)
    assert [o.to_dict() for o in th.ops] == [o.to_dict() for o in rh.ops]


# -- the device program --------------------------------------------------------


@pytest.mark.parametrize("N", [4, 12, 32, 48])
@pytest.mark.parametrize("need", [(True, True), (True, False),
                                  (False, True)])
def test_graph_counts_match_reference_body(N, need):
    rng = np.random.default_rng(N)
    B = 5
    for p in (0.05, 0.2, 0.5):
        wrww = (rng.random((B, N, N)) < p).astype(np.float32)
        rw = rng.random((B, N, N)) < p / 2
        allm = np.maximum(wrww, rw.astype(np.float32))
        n_iters = ttg._n_iters(N)
        assert n_iters == rtg._n_iters(N)
        want = rtg._graph_counts_body(jnp.asarray(wrww), jnp.asarray(allm),
                                      jnp.asarray(rw), n_iters, *need)
        got = ttg.graph_counts_torch(torch.from_numpy(wrww),
                                     torch.from_numpy(allm),
                                     torch.from_numpy(rw), n_iters, *need)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32 and g.shape == (B,)
            assert np.array_equal(np.asarray(w), g.numpy()), (p, need)


def test_graph_counts_lane_31():
    """A 32-txn cycle through node 31, the last lane of the word the
    reference packs each row of a 32-wide graph into: the same counts
    as the reference's body."""
    N = 32
    wrww = np.zeros((1, N, N), np.float32)
    for i in range(N):
        wrww[0, i, (i + 1) % N] = 1.0
    rw = np.zeros((1, N, N), bool)
    rw[0, 0, 31] = True
    allm = np.maximum(wrww, rw)
    got = ttg.graph_counts_torch(*(torch.from_numpy(a)
                                   for a in (wrww, allm, rw)), 5, True, True)
    want = rtg._graph_counts_body(*(jnp.asarray(a)
                                    for a in (wrww, allm, rw)), 5, True, True)
    assert [int(t[0]) for t in got] == [int(w[0]) for w in want] == [32, 1, 1]


def test_launch_graph_batch_counts_and_refuses_a_mesh():
    reset_launch_stats()
    ttg.reset_txn_graph_stats()
    z = torch.zeros(3, 12, 12)
    out = ttg.launch_graph_batch(z, z, z > 0, True, False)
    assert [t.tolist() for t in out] == [[0, 0, 0]] * 3
    assert launch_stats_snapshot()["launches"] == 1
    # the graphs and rounds are the callers' to count, before their guard
    assert ttg.TXN_GRAPH_STATS["device_graphs"] == 0
    ttg.note_graph_launch(3, 12, True, False)
    assert ttg.TXN_GRAPH_STATS["device_graphs"] == 3
    assert ttg.TXN_GRAPH_STATS["matmul_rounds"] == ttg._n_iters(12)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        ttg.launch_graph_batch(z, z, z > 0, mesh=object())
    es = ttg.extract_edges(ttg.encode_txn_graph(_H([
        [("append", "a", 1)], [("r", "a", [1])]])[1]))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        ttg._oversize_counts(es, np.arange(2), np.zeros(2, np.int64), 0,
                             True, True, object(), "cpu")


# -- the checker ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 23])
@pytest.mark.parametrize("anom", ANOMS)
def test_checker_matches_reference_seeded(seed, anom):
    rh, th = _histories(seed, n_txns=80, anomaly=anom, cycle_len=3)
    r, t, rs, ts = _both_checks(rh, th)
    assert r["method"] == "tpu-txn-graph" and t["method"] == "gpu-txn-graph"
    assert _strip(t) == _strip(r)
    assert ts == rs
    # the oracle: same verdict but for the device extras
    f = ttg.fold_txn_graph(th)
    assert f["method"] == "cpu-txn-fold"
    assert _strip(f) == _strip(rtg.fold_txn_graph(rh))
    assert {k: v for k, v in _strip(t).items()
            if k not in ("components", "matmul_rounds")} == _strip(f)
    assert (t["valid?"] is True) == (anom is None)


@pytest.mark.parametrize("L", range(2, 9))
def test_planted_cycle_lengths_match_reference(L):
    for anom in ("g1c", "g-single", "g2-item"):
        rh, th = _histories(40 + L, n_txns=24, anomaly=anom, cycle_len=L)
        r, t, _, _ = _both_checks(rh, th)
        assert t["valid?"] is False
        assert _strip(t) == _strip(r), anom
        for a in t["anomalies"].values():
            assert a["cycle_len"] == L and a["cycle"][0] == a["cycle"][-1]


@pytest.mark.parametrize("classes", [("G1c",), ("G-single",), ("G2-item",),
                                     ("G1c", "G2-item")])
def test_checker_classes_match_reference(classes):
    rh, th = _histories(11, n_txns=40, anomaly="g-single", cycle_len=4)
    r, t, rs, ts = _both_checks(rh, th, classes=classes)
    assert _strip(t) == _strip(r) and ts == rs
    o = ttg.TxnGraphChecker(classes=classes, oracle=True).check({}, th)
    assert _strip(o) == _strip(rtg.TxnGraphChecker(
        classes=classes, oracle=True).check({}, rh))


def test_checker_accepts_plane_and_memoizes_its_program():
    rh, th = _histories(3, n_txns=48, anomaly="g2-item", cycle_len=3)
    tp, rp = ttg.encode_txn_graph(th), rtg.encode_txn_graph(rh)
    ttg.reset_txn_graph_stats()
    chk = ttg.TxnGraphChecker(device="cpu")
    v1, v2 = chk.check({}, tp), chk.check({}, tp)
    assert v1 == v2 and v1["n_txns"] == tp.n_txns
    assert _strip(v1) == _strip(rtg.TxnGraphChecker().check({}, rp))
    st = ttg.txn_graph_stats()
    assert (st["graph_prog_compiles"], st["graph_prog_hits"]) == (1, 1)
    assert (st["extracts"], st["extract_memo_hits"]) == (1, 1)
    assert st["device_graphs"] > 0 and st["matmul_rounds"] > 0
    o = ttg.TxnGraphChecker(oracle=True).check({}, tp)
    assert o["method"] == "cpu-txn-fold"
    assert _strip(o) == _strip(rtg.TxnGraphChecker(oracle=True).check({}, rp))


def test_empty_and_edgeless_histories_match_reference():
    for txns in ([], [[("append", "a", 1)], [("append", "b", 2)]]):
        rh, th = _H(txns)
        r, t, rs, ts = _both_checks(rh, th)
        assert _strip(t) == _strip(r) and ts == rs
        assert t["method"] == "gpu-txn-graph"


def test_oversize_solo_route_matches_reference():
    """buckets=(4,) sends every wider component down the oversize path:
    a solo [1, N, N] launch each (the reference, on one device, the
    same with mesh=False)."""
    rh, th = _histories(13, n_txns=40, anomaly="g1c", cycle_len=8)
    rtg.reset_txn_graph_stats()
    ttg.reset_txn_graph_stats()
    r = rtg.TxnGraphChecker(buckets=(4,), mesh=False).check({}, rh)
    t = ttg.TxnGraphChecker(buckets=(4,), device="cpu").check({}, th)
    assert _strip(t) == _strip(r)
    assert t["components"]["oversize"] > 0
    assert ttg.TXN_GRAPH_STATS["oversize_components"] == \
        rtg.TXN_GRAPH_STATS["oversize_components"] > 0
    assert ttg.TXN_GRAPH_STATS["host_fallback_components"] == 0
    assert ttg.TXN_GRAPH_STATS["matmul_rounds"] == \
        rtg.TXN_GRAPH_STATS["matmul_rounds"]


def test_oversize_host_census_past_the_solo_cap(monkeypatch):
    """Past _SOLO_MAX_N a component takes the host census in both
    packages: the same verdict, no device graph for it."""
    rh, th = _histories(13, n_txns=40, anomaly="g1c", cycle_len=8)
    monkeypatch.setattr(rtg, "_SOLO_MAX_N", 4)
    monkeypatch.setattr(ttg, "_SOLO_MAX_N", 4)
    rtg.reset_txn_graph_stats()
    ttg.reset_txn_graph_stats()
    r = rtg.TxnGraphChecker(buckets=(4,), mesh=False).check({}, rh)
    t = ttg.TxnGraphChecker(buckets=(4,), device="cpu").check({}, th)
    assert _strip(t) == _strip(r)
    assert ttg.TXN_GRAPH_STATS["host_fallback_components"] == \
        rtg.TXN_GRAPH_STATS["host_fallback_components"] > 0


def test_weak_components_without_scipy_give_scipy_labels():
    rng = np.random.default_rng(1)
    for n, m in ((1, 0), (10, 4), (60, 40), (200, 150)):
        pairs = rng.integers(0, n, size=(m, 2)).astype(np.int64)
        want = ttg._weak_components(n, pairs)
        got = ttg._weak_components_uf(n, pairs)
        assert got[1] == want[1]
        assert np.array_equal(got[0], want[0])
    assert ttg._weak_components_uf(0, np.zeros((0, 2), np.int64))[1] == 0


def test_exports():
    import jepsen_tpu_torch.checker as checker

    assert checker.TxnGraphChecker is ttg.TxnGraphChecker
    assert checker.fold_txn_graph is ttg.fold_txn_graph
    assert checker.txn_graph_checker is ttg.txn_graph_checker
    assert isinstance(ttg.txn_graph_checker(device="cpu"),
                      ttg.TxnGraphChecker)
    with pytest.raises(ValueError, match="unknown anomaly"):
        ttg.TxnGraphChecker(classes=("G0",))
    with pytest.raises(ValueError, match="not both"):
        ttg.TxnGraphChecker(plane=object(), device="cpu")


def test_checker_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, th = _histories(1, n_txns=12, anomaly="g1c")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttg.TxnGraphChecker().check({}, th)
    assert ttg.TxnGraphChecker(device="cpu").check({}, th)["valid?"] is False


# -- the plane's graph bucket ----------------------------------------------------


def test_concurrent_submitters_share_one_graph_launch():
    """Two checkers' adjacency batches land in one bucket of a CPU plane
    and ride ONE launch, collected with one wait."""
    (rh1, th1), (rh2, th2) = (_histories(s, n_txns=12) for s in (1, 2))
    reset_launch_stats()
    t_dp.reset_dispatch_stats()
    with t_dp.DispatchPlane(device="cpu") as plane:
        c = ttg.TxnGraphChecker(plane=plane, buckets=(16,))
        r1 = c.check_async({}, th1)
        r2 = c.check_async({}, th2)
        plane.flush()
        v1, v2 = r1(), r2()
    for v, rh in ((v1, rh1), (v2, rh2)):
        assert _strip(v) == _strip(rtg.TxnGraphChecker(
            buckets=(16,)).check({}, rh))
    st = t_dp.dispatch_stats()
    assert st["graph_requests"] == 2 and st["graph_batches"] == 1
    assert st["batches"] == 1 and st["batched_requests"] == 2
    assert launch_stats_snapshot() == {"launches": 1, "escalations": 0,
                                       "host_syncs": 1}


def test_multi_bucket_check_collects_with_one_wait():
    _, th = _histories(7, n_txns=80, anomaly="g1c", cycle_len=3)
    reset_launch_stats()
    t_dp.reset_dispatch_stats()
    # room for every launch in flight: no backpressure collect
    with t_dp.DispatchPlane(device="cpu", max_inflight_trains=8) as plane:
        v = ttg.TxnGraphChecker(plane=plane).check({}, th)
    n = len(v["components"]["buckets"])
    assert n > 1
    assert t_dp.DISPATCH_STATS["graph_batches"] == n
    assert launch_stats_snapshot() == {"launches": n, "escalations": 0,
                                       "host_syncs": 1}


def test_graph_launch_cap_splits_the_group(monkeypatch):
    _, th1 = _histories(1, n_txns=12)
    _, th2 = _histories(2, n_txns=12)
    monkeypatch.setattr(t_dp.DispatchPlane, "GRAPH_LAUNCH_ELEMS", 16 * 16)
    t_dp.reset_dispatch_stats()
    with t_dp.DispatchPlane(device="cpu") as plane:
        c = ttg.TxnGraphChecker(plane=plane, buckets=(16,))
        rs = [c.check_async({}, h) for h in (th1, th2)]
        vs = [r() for r in rs]
    assert [v["valid?"] for v in vs] == [True, True]
    assert t_dp.DISPATCH_STATS["graph_batches"] == 2


def test_submit_graph_checks_its_stacks():
    with t_dp.DispatchPlane(device="cpu") as plane:
        t = torch.zeros(2, 4, 4)
        with pytest.raises(ValueError, match="one \\[B, N, N\\] shape"):
            plane.submit_graph(t, t[:1], t > 0)
        with pytest.raises(ValueError, match="float32/float32/bool"):
            plane.submit_graph(t.double(), t, t > 0)
        with pytest.raises(ValueError, match="float32/float32/bool"):
            plane.submit_graph(t, t, t.to(torch.int8))
        fut = plane.submit_graph(t, t, t > 0, (True, False))
        assert fut.key == ("graph", 4, True, False)
        assert [a.tolist() for a in fut.result()] == [[0, 0]] * 3


# -- the fault departures ------------------------------------------------------------


def test_cpu_plane_fault_degrades_to_the_host_census():
    """A device fault spends the launch's budget: the CPU plane degrades,
    so the checker answers from its host census, the verdict equal to
    the reference's degraded one."""
    rh, th = _histories(4, n_txns=36, anomaly="g-single", cycle_len=3)

    def boom(*a, **kw):
        raise RuntimeError("injected graph-launch fault")

    real = rtg.launch_graph_batch
    rtg.launch_graph_batch = boom
    try:
        want = rtg.TxnGraphChecker().check({}, rh)
    finally:
        rtg.launch_graph_batch = real
    assert want["degraded"] is True
    chaos.reset_resilience()
    with chaos.chaos_plan(chaos.persistent_device_fault("cpu")):
        with t_dp.DispatchPlane(device="cpu") as plane:
            got = ttg.TxnGraphChecker(plane=plane).check({}, th)
    assert got["method"] == "cpu-txn-fold" == want["method"]
    assert _strip(got) == _strip(want)
    res = chaos.resilience_snapshot()
    assert res["oracle_fallbacks"] == 1 and res["plane_faults"] >= 1


def _solo_only(seed):
    """Histories whose one component is a planted 3-txn G-single cycle:
    under buckets=(2,) it takes the oversize solo launch, and no bucket
    launch runs."""
    return _histories(seed, n_txns=0, anomaly="g-single", cycle_len=3)


def test_python_error_in_the_launch_reaches_the_caller(monkeypatch):
    _, th = _histories(4, n_txns=36, anomaly="g-single", cycle_len=3)

    def boom(*a, **kw):
        raise RuntimeError("injected graph-launch fault")

    monkeypatch.setattr(ttg, "launch_graph_batch", boom)
    with t_dp.DispatchPlane(device="cpu") as plane:
        with pytest.raises(RuntimeError, match="injected graph-launch"):
            ttg.TxnGraphChecker(plane=plane).check({}, th)
        # the oversize solo launch: the same
        _, th = _solo_only(4)
        t_dp.reset_dispatch_stats()
        ttg.reset_txn_graph_stats()
        with pytest.raises(RuntimeError, match="injected graph-launch"):
            ttg.TxnGraphChecker(plane=plane, buckets=(2,)).check({}, th)
    assert t_dp.DISPATCH_STATS["graph_requests"] == 0
    assert ttg.TXN_GRAPH_STATS["oversize_components"] == 1


@pytest.mark.parametrize("buckets", [None, (2,)])
def test_non_degrading_plane_fault_reaches_the_caller(buckets):
    """degrade=False (the card's default): the PlaneFault is raised,
    from a bucket launch and from an oversize solo launch alike (with
    buckets=(2,) the history's one component takes the solo launch, and
    no bucket launch runs)."""
    if buckets is None:
        _, th = _histories(4, n_txns=36, anomaly="g-single", cycle_len=3)
    else:
        _, th = _solo_only(4)
    chaos.reset_resilience()
    t_dp.reset_dispatch_stats()
    ttg.reset_txn_graph_stats()
    with chaos.chaos_plan(chaos.persistent_device_fault("cpu")):
        with t_dp.DispatchPlane(device="cpu", degrade=False) as plane:
            with pytest.raises(chaos.PlaneFault) as ei:
                ttg.TxnGraphChecker(plane=plane,
                                    buckets=buckets).check({}, th)
    assert ei.value.kind == "fatal" and ei.value.site == "launch"
    assert chaos.resilience_snapshot()["oracle_fallbacks"] == 0
    solo = buckets is not None
    assert (t_dp.DISPATCH_STATS["graph_requests"] == 0) is solo
    assert (ttg.TXN_GRAPH_STATS["oversize_components"] == 1) is solo


@pytest.mark.parametrize("buckets", [None, (2,)])
def test_transient_fault_inside_a_graph_launch_counts_once(monkeypatch,
                                                           buckets):
    """A transient device error inside a guarded graph launch (the
    bucket launch, or with buckets=(2,) the oversize solo launch): the
    plane's guard runs it again, and the verdict and TXN_GRAPH_STATS
    equal the reference's fault-free check (the graphs and rounds count
    once, not once an attempt)."""
    rh, th = _solo_only(4)
    real = ttg.graph_counts_torch
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise chaos.transient_fault().build()
        return real(*a, **kw)

    monkeypatch.setattr(ttg, "graph_counts_torch", flaky)
    chaos.reset_resilience()
    t_dp.reset_dispatch_stats()
    rtg.reset_txn_graph_stats()
    ttg.reset_txn_graph_stats()
    # a plane of its own: after a check whose first launch raised (the
    # degrade test's), the reference's default plane still holds that
    # check's other buckets and launches them with the next check's
    with r_dp.DispatchPlane(interpret=True, mesh=False, race=False) as rp:
        want = rtg.TxnGraphChecker(plane=rp, buckets=buckets,
                                   mesh=False).check({}, rh)
    with t_dp.DispatchPlane(device="cpu", degrade=False) as plane:
        got = ttg.TxnGraphChecker(plane=plane, buckets=buckets).check({}, th)
    assert len(calls) == 2 and chaos.resilience_snapshot()["retries"] == 1
    assert got["method"] == "gpu-txn-graph" and "degraded" not in got
    assert _strip(got) == _strip(want) and got["valid?"] is False
    assert {k: ttg.TXN_GRAPH_STATS[k] for k in STATS} == \
        {k: rtg.TXN_GRAPH_STATS[k] for k in STATS}
    solo = buckets is not None
    assert (ttg.TXN_GRAPH_STATS["oversize_components"] == 1) is solo
    assert (t_dp.DISPATCH_STATS["graph_requests"] == 0) is solo


# -- soak ------------------------------------------------------------------------


@pytest.mark.slow
def test_soak_checker_matches_reference():
    rng = random.Random(777)
    for _ in range(30):
        anom = rng.choice(ANOMS)
        kw = dict(n_txns=rng.randrange(20, 200),
                  keys_per_group=rng.randrange(2, 5),
                  txns_per_group=rng.randrange(4, 30), anomaly=anom,
                  cycle_len=rng.randrange(2, 9))
        rh, th = _histories(rng.randrange(1 << 30), **kw)
        r, t, rs, ts = _both_checks(rh, th)
        assert _strip(t) == _strip(r), (anom, kw)
        assert ts == rs
