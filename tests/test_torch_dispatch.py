"""The port's dispatch plane (jepsen_tpu_torch.checker.dispatch) against
the JAX package's, on the CPU.

The differentials hold the port's DispatchPlane(device="cpu") against
the reference's DispatchPlane(interpret=True, mesh=False, race=False)
(mesh=False matters: tests/conftest.py gives jax 8 virtual devices) on
the same event streams: homogeneous, mid-batch-escalating and
heterogeneous (registers plus a queue history's per-value substreams)
batches, check_queue_by_value through the plane, and the async prep
worker. Every verdict field must agree, the method after mapping
tpu-* -> gpu-* (both planes take the same bucket kinds on the CPU), and
so must LAUNCH_STATS and DISPATCH_STATS (all but the coalesce wait, a
clock reading). Then the plane's own invariants, on the port alone: N
same-shape requests make 1 launch and 1 host sync, targeted flushes,
train pruning, backpressure, the segmented solo launch, check_async,
the stats under contention and the bounded prep memos.

Tolerance: exact equality. Every register stream here has at most 64
return steps at W=12, S=8 and rides a batch of 4, so the reference's
interpret-mode kernels compile one shape a tier; its results are
computed once per case (module cache)."""

import os
import random
import sys
import threading

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import events as r_ev
from jepsen_tpu.checker import linearizable as r_lin
from jepsen_tpu.checker import wgl_bitset as r_bs
from jepsen_tpu.history.history import History as RefHistory
from jepsen_tpu.sim import corrupt_history as r_corrupt
from jepsen_tpu.sim import gen_register_history as r_gen

from jepsen_tpu_torch.checker import dispatch as dp
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.dispatch import (
    DISPATCH_STATS,
    DispatchPlane,
    _bump,
    dispatch_stats,
    reset_dispatch_stats,
)
from jepsen_tpu_torch.checker.events import (
    _memo_lock,
    _memo_owners,
    clear_memos,
    events_to_steps,
    history_to_events,
    memo_on,
    memo_stats,
    reset_memo_stats,
    set_memo_limit,
)
from jepsen_tpu_torch.checker.linearizable import (
    RACE_STATS,
    LinearizableChecker,
    _bump_race,
    _harvest_failure,
    check_events_bucketed,
    check_queue_by_value,
    reset_race_stats,
)
from jepsen_tpu_torch.convert import from_reference
from jepsen_tpu_torch.device import (
    LAUNCH_STATS,
    _bump_launch,
    launch_stats_snapshot,
    reset_launch_stats,
)
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.sim import (
    corrupt_history,
    gen_queue_history,
    gen_register_history,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _map_method(m: str) -> str:
    return ",".join(
        "gpu-" + p[4:] if p.startswith("tpu-") else p
        for p in m.replace("per-value:tpu-", "per-value:gpu-").split(",")
    ).replace("xtpu-", "xgpu-")


def _strip(out):
    return {k: v for k, v in out.items() if k not in ("method", "wall_s")}


def _same(got, want):
    assert _strip(got) == _strip(want), (got, want)
    assert got["method"] == _map_method(want["method"]), (got, want)


#: the register stream families: 4 streams, <= 64 return steps, W=12,
#: S=8 (seed 7120 with every second stream corrupted really has invalid
#: streams)
FAMILIES = {
    "clean": dict(seed=7000, p_crash=0.0, corrupt_every=0),
    "escalating": dict(seed=7120, p_crash=0.05, corrupt_every=2),
}


def _register_histories(seed, p_crash, corrupt_every, n=4, n_ops=40):
    out = []
    for i in range(n):
        rng = random.Random(seed + i)
        h = r_gen(rng, n_ops=n_ops, n_procs=4, p_crash=p_crash)
        if corrupt_every and i % corrupt_every == corrupt_every - 1:
            h = r_corrupt(h, rng)
        out.append(h)
    return out


def _streams(family):
    """(reference streams, port streams) of a family, the port's carried
    across from the reference's (from_reference)."""
    ref = [r_ev.history_to_events(h, model="cas-register")
           for h in _register_histories(**FAMILIES[family])]
    return ref, [from_reference(s) for s in ref]


def _queue_history():
    ops = gen_queue_history(random.Random(42), n_ops=160, n_procs=4,
                            n_values=8)
    return (RefHistory([o.to_dict() for o in ops]),
            History([o.to_dict() for o in ops]))


_REF_CACHE: dict = {}


def _ref_stats():
    return (
        {k: v for k, v in r_dp.DISPATCH_STATS.items()
         if k in DISPATCH_STATS and k != "coalesce_wait_us"},
        {k: r_bs.LAUNCH_STATS[k] for k in LAUNCH_STATS},
    )


def _port_stats():
    return (
        {k: v for k, v in DISPATCH_STATS.items()
         if k != "coalesce_wait_us"},
        launch_stats_snapshot(),
    )


def _reset():
    r_dp.reset_dispatch_stats()
    r_bs.reset_launch_stats()
    reset_dispatch_stats()
    reset_launch_stats()


def _plane_run(family, queue=False, ref=True, **kw):
    """Submit a family's streams (plus, with queue, the queue history's
    per-value substreams) to one plane before resolving any. Returns
    (register verdicts, queue verdict or None, stats)."""
    ref_streams, port_streams = _streams(family)
    rq, pq = _queue_history()
    _reset()
    if ref:
        with r_dp.DispatchPlane(interpret=True, mesh=False, race=False,
                                **kw) as plane:
            futs = [plane.submit(s) for s in ref_streams]
            q = (r_lin.check_queue_by_value(rq, "unordered-queue",
                                            plane=plane)
                 if queue else None)
            outs = [f.result() for f in futs]
        return outs, q, _ref_stats()
    with DispatchPlane(device="cpu", **kw) as plane:
        futs = [plane.submit(s) for s in port_streams]
        q = (check_queue_by_value(pq, "unordered-queue", plane=plane)
             if queue else None)
        outs = [f.result() for f in futs]
    return outs, q, _port_stats()


def _reference(family, queue=False):
    key = (family, queue)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = _plane_run(family, queue=queue)
    return _REF_CACHE[key]


# -- differentials against the reference's plane ------------------------------


@pytest.mark.parametrize("family,queue", (
    ("clean", False),
    ("escalating", False),
    ("escalating", True),
))
def test_plane_matches_reference_plane(family, queue):
    """Homogeneous, mid-batch-escalating (a fast-tier death re-runs the
    batch exactly, then the dead stream re-checks solo for its report)
    and heterogeneous (cas-register streams and the per-value queue
    substreams on the vmap bucket, all submitted before any resolve):
    every verdict, LAUNCH_STATS and DISPATCH_STATS equal."""
    want, want_q, want_stats = _reference(family, queue)
    got, got_q, got_stats = _plane_run(family, queue=queue, ref=False)
    for g, w in zip(got, want):
        _same(g, w)
    if queue:
        _same(got_q, want_q)
        assert got_q["n_values"] == 8
    assert got_stats == want_stats
    if family == "escalating":
        assert not all(o["valid?"] for o in got)  # escalation fired
        assert got_stats[1]["escalations"] >= 1


def test_coalesced_batch_single_launch():
    """N same-shape clean requests: ONE bucket, ONE launch, ONE host
    sync, zero escalations."""
    got, _, _ = _plane_run("clean", ref=False)
    assert all(o["valid?"] is True for o in got)
    assert {o["method"] for o in got} == {"gpu-wgl-bitset-batch"}
    assert launch_stats_snapshot() == {
        "launches": 1, "escalations": 0, "host_syncs": 1,
        "donated_buffers": 0,
    }
    st = dispatch_stats()
    assert st["requests"] == 4 and st["batches"] == 1
    assert st["batched_requests"] == 4 and st["solo_launches"] == 0
    assert st["mean_batch_occupancy"] == 4.0
    assert st["floor_amortization"] == 4.0
    assert st["per_device"]["cpu"] == {
        "launches": 1, "requests": 4, "floor_amortization": 4.0,
        "occupancy": 1.0,
    }


def test_async_prep_worker_matches_reference():
    """async_prep=True moves prep onto the worker thread; with the
    coalesce window far above prep time the burst still forms one
    launch, and the verdicts equal the reference plane's."""
    want, _, _ = _reference("clean")
    _, port_streams = _streams("clean")
    reset_launch_stats()
    with DispatchPlane(device="cpu", async_prep=True,
                       coalesce_wait_us=10_000_000) as plane:
        futs = [plane.submit(s) for s in port_streams]
        plane.flush()
        got = [f.result() for f in futs]
    for g, w in zip(got, want):
        _same(g, w)
    assert LAUNCH_STATS["launches"] == 1
    assert DISPATCH_STATS["worker_errors"] == 0


def test_queue_by_value_through_plane_matches_reference():
    """check_queue_by_value(plane=...): the substreams submit one by one
    and coalesce into shared launches, with the same merged verdict as
    the reference's."""
    rq, pq = _queue_history()
    want = r_lin.check_queue_by_value(rq, "unordered-queue",
                                      plane=_reference_plane())
    reset_dispatch_stats()
    with DispatchPlane(device="cpu") as plane:
        got = check_queue_by_value(pq, "unordered-queue", plane=plane)
    _same(got, want)
    st = dispatch_stats()
    assert st["requests"] == 8
    assert st["batches"] >= 1 and st["mean_batch_occupancy"] > 1.0
    seq = check_queue_by_value(pq, "unordered-queue", device="cpu")
    assert _strip(seq) == _strip(got)


def _reference_plane():
    plane = r_dp.DispatchPlane(interpret=True, mesh=False, race=False)
    _REF_CACHE.setdefault("planes", []).append(plane)
    return plane


@pytest.fixture(autouse=True, scope="module")
def _close_reference_planes():
    yield
    for plane in _REF_CACHE.get("planes", []):
        plane.close()


# -- the plane's own invariants -----------------------------------------------


def _port_register_streams(n, n_ops=40, seed=7000, p_crash=0.0,
                           corrupt_every=0):
    out = []
    for i in range(n):
        rng = random.Random(seed + i)
        h = gen_register_history(rng, n_ops=n_ops, n_procs=4,
                                 p_crash=p_crash)
        if corrupt_every and i % corrupt_every == corrupt_every - 1:
            h = corrupt_history(h, rng)
        out.append(history_to_events(h))
    return out


def test_checker_and_check_async_through_plane():
    """LinearizableChecker(plane=...) routes check() through the plane;
    check_async() returns a resolver so many histories submit before
    any sync. Verdicts equal the plane-less checker's."""
    rng = random.Random(44)
    hs = [History(gen_register_history(rng, n_ops=40, n_procs=4).ops)
          for _ in range(4)]
    base = LinearizableChecker(device="cpu")
    seq = [base.check(None, h) for h in hs]
    reset_launch_stats()
    with DispatchPlane(device="cpu") as plane:
        c = LinearizableChecker(plane=plane)
        direct = c.check(None, hs[0])
        resolvers = [c.check_async(None, h) for h in hs]
        plane.flush()
        outs = [r() for r in resolvers]
    assert _strip(direct) == _strip(seq[0])
    for s, p in zip(seq, outs):
        assert {k: p[k] for k in ("valid?", "n_ops", "window")} == {
            k: s[k] for k in ("valid?", "n_ops", "window")}
        assert p["wall_s"] > 0
    # the four async checks shared one launch
    assert LAUNCH_STATS["launches"] == 2


def test_check_async_requires_plane():
    c = LinearizableChecker(device="cpu")
    with pytest.raises(ValueError):
        c.check_async(None, History([]))


def test_plane_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DispatchPlane()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dp.default_plane()


def test_check_keys_bitset_runs_through_default_plane():
    """check_keys_bitset (and so sharded.check_keys) rides the default
    plane's train: one launch, one host sync, one batch in the plane's
    stats; a fast-tier death adds one exact re-run and its fetch."""
    from jepsen_tpu_torch.checker.sharded import check_keys

    for corrupt_every, n in ((0, 1), (2, 2)):
        streams = _port_register_streams(
            4, seed=7120, p_crash=0.05, corrupt_every=corrupt_every)
        reset_launch_stats()
        reset_dispatch_stats()
        res = check_keys(streams, device="cpu")
        assert launch_stats_snapshot() == {
            "launches": n, "escalations": n - 1, "host_syncs": n,
            "donated_buffers": 0,
        }
        assert DISPATCH_STATS["batches"] == 1
        assert DISPATCH_STATS["requests"] == 4
        seq = [check_events_bucketed(s, device="cpu") for s in streams]
        assert [r["valid?"] for r in res] == [s["valid?"] for s in seq]
    assert dp.default_plane(device="cpu") is dp.default_plane(
        device="cpu")


def test_segmented_solo_launch_rides_the_train():
    """A multi-segment plan (W12 then W18) is dispatched solo: one
    launch, one host sync, the sequential verdict; its corrupted copy
    escalates and carries the same failed_op_index and report."""
    h = gen_register_history(random.Random(1), n_ops=2500, n_procs=4,
                             p_crash=0.004)
    hc = corrupt_history(h, random.Random(11))
    streams = [history_to_events(x) for x in (h, hc)]
    steps = events_to_steps(streams[0], W=18)
    assert len(bs._plan_for(steps, None)) == 2
    seq = [check_events_bucketed(s, device="cpu") for s in streams]
    assert seq[0]["valid?"] is True and seq[1]["valid?"] is False
    reset_launch_stats()
    reset_dispatch_stats()
    with DispatchPlane(device="cpu") as plane:
        fut = plane.submit(streams[0])
        got = fut.result()
        assert launch_stats_snapshot() == {
            "launches": 1, "escalations": 0, "host_syncs": 1,
            "donated_buffers": 0,
        }
        bad = plane.submit(streams[1]).result()
    assert got == {**seq[0]}
    assert bad == seq[1]
    assert DISPATCH_STATS["solo_launches"] == 2


def test_stats_thread_safety_stress():
    """LAUNCH_STATS, RACE_STATS and DISPATCH_STATS are bumped from the
    prep worker, collecting threads and racer threads at once: with
    more threads than cores and a short switch interval, no increment
    is lost."""
    N_THREADS, N_BUMPS = max(8, 2 * (os.cpu_count() or 4)), 1000
    reset_launch_stats()
    reset_race_stats()
    reset_dispatch_stats()

    def hammer():
        for _ in range(N_BUMPS):
            _bump_launch("launches")
            _bump_race("gpu_wins")
            _bump("requests")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer)
                   for _ in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert LAUNCH_STATS["launches"] == N_THREADS * N_BUMPS
    assert RACE_STATS["gpu_wins"] == N_THREADS * N_BUMPS
    assert DISPATCH_STATS["requests"] == N_THREADS * N_BUMPS
    reset_launch_stats()
    reset_race_stats()
    reset_dispatch_stats()


def test_memo_lru_eviction_and_stats():
    """The prep-memo registry is LRU-bounded: past the bound the oldest
    owner's caches are evicted (hits, misses and evictions counted), and
    an evicted stream rebuilds on its next touch."""
    streams = _port_register_streams(6, n_ops=40, seed=7300)
    for s in streams:
        clear_memos(s)
    old = set_memo_limit(3)
    reset_memo_stats()
    try:
        first = events_to_steps(streams[0], W=streams[0].window)
        for s in streams:
            events_to_steps(s, W=s.window)
        st = memo_stats()
        assert st["misses"] >= 6
        assert st["evictions"] >= 3
        assert not hasattr(streams[0], "_steps_cache")
        again = events_to_steps(streams[0], W=streams[0].window)
        assert again.occ.shape == first.occ.shape and again.W == first.W
        h0 = memo_stats()["hits"]
        events_to_steps(streams[0], W=streams[0].window)
        assert memo_stats()["hits"] == h0 + 1
    finally:
        set_memo_limit(old)
        reset_memo_stats()


def test_eviction_keeps_inflight_death_frontier():
    s = _port_register_streams(1, n_ops=40, seed=7700)[0]
    st = events_to_steps(s, W=s.window)
    st._death_frontier = np.zeros(1, np.uint32)
    old = set_memo_limit(0)
    try:
        assert not hasattr(s, "_steps_cache")
        assert hasattr(st, "_death_frontier")
    finally:
        set_memo_limit(old)
    clear_memos(st)
    assert not hasattr(st, "_death_frontier")


def test_memo_reinstall_reregisters_owner():
    class Obj:
        pass

    o = Obj()

    def factory():
        clear_memos(o)  # deregisters o mid-build, like an eviction
        return "v"

    assert memo_on(o, "_bitset_args", None, factory) == "v"
    with _memo_lock:
        assert id(o) in _memo_owners


def test_dispatch_stats_derived_fields():
    reset_dispatch_stats()
    streams = _port_register_streams(4)
    with DispatchPlane(device="cpu") as plane:
        futs = [plane.submit(s) for s in streams]
        plane.flush()
        [f.result() for f in futs]
    st = dispatch_stats()
    for key in (
        "requests", "batches", "batched_requests", "solo_launches",
        "fallbacks", "mean_batch_occupancy", "floor_amortization",
        "mean_coalesce_wait_us", "double_buffer_occupancy", "per_device",
        "n_devices", "launch", "resilience",
    ):
        assert key in st, key
    assert st["floor_amortization"] == 4.0
    assert st["n_devices"] == 1
    assert isinstance(st["launch"], dict)


def test_launch_train_prunes_after_collect():
    """Resolved launches leave the train and drop their handles, host
    buffers and riders' steps."""
    streams = _port_register_streams(3, seed=7400)
    with DispatchPlane(device="cpu") as plane:
        for s in streams:
            fut = plane.submit(s)
            plane.flush()
            launch_before = fut.launch
            assert fut.result()["valid?"] is True
            assert fut.launch is None and fut.steps is None
            assert launch_before.handle is None
            assert launch_before.host is None
            assert launch_before.futs == []
        with plane._lock:
            assert plane._launched == []


def test_targeted_flush_leaves_other_buckets_parked():
    """result() dispatches only the bucket the driven future rides:
    another, different-shape bucket keeps coalescing until its own
    futures are driven."""
    a = _port_register_streams(3, n_ops=40, seed=7400)
    b = _port_register_streams(2, n_ops=120, seed=7500)
    with DispatchPlane(device="cpu", coalesce_wait_us=10_000_000) as plane:
        fa = [plane.submit(s) for s in a]
        fb = [plane.submit(s) for s in b]
        assert all(f.result()["valid?"] is True for f in fa)
        with plane._lock:
            parked = sum(len(bk.futs) for bk in plane._buckets.values())
        assert parked == len(fb)
        assert all(f.result()["valid?"] is True for f in fb)


def test_backpressure_collects_oldest_train():
    """With max_inflight_trains=1 a second registered train collects
    the first before it is queued: bounded device memory, same
    verdicts."""
    a = _port_register_streams(2, n_ops=40, seed=7400)
    b = _port_register_streams(2, n_ops=120, seed=7500)
    reset_dispatch_stats()
    with DispatchPlane(device="cpu", max_inflight_trains=1) as plane:
        futs = [plane.submit(s) for s in a + b]
        plane.flush()
        outs = [f.result() for f in futs]
    assert all(o["valid?"] is True for o in outs)
    assert DISPATCH_STATS["backpressure_collects"] >= 1
    assert DISPATCH_STATS["train_registers"] == 2


def test_harvest_failure_attaches_report():
    rng = random.Random(7650)
    h = corrupt_history(gen_register_history(rng, n_ops=40, n_procs=3),
                        rng)
    ev = history_to_events(h)
    out = {"valid?": False, "failed_op_index": 3}
    _harvest_failure(ev, out, "cas-register")
    assert out["failure"]["configs"]
    untouched = {"valid?": True}
    _harvest_failure(ev, untouched, "cas-register")
    assert "failure" not in untouched


def test_check_async_invalid_carries_failure_report():
    """An invalid verdict from the index-only vmap bucket (more value
    codes than the bitset's 32 state rows) still carries the harvested
    failure report, and the sequential verdict's index."""
    rng = random.Random(7600)
    h = gen_register_history(rng, n_ops=120, n_procs=4, n_values=64,
                             p_crash=0.0)
    h = corrupt_history(h, rng, n_values=64)
    seq = LinearizableChecker(device="cpu").check(None, h)
    assert seq["valid?"] is False and "failure" in seq
    with DispatchPlane(device="cpu") as plane:
        out = LinearizableChecker(plane=plane).check_async(None, h)()
    assert out["method"] == "gpu-wgl-batch"
    assert out["valid?"] is False and "failure" in out
    assert out["failed_op_index"] == seq["failed_op_index"]


def test_fallback_requests_resolve_on_the_host():
    """A joint queue stream with more values than the packed encoding
    holds is host-only (rich state): the plane resolves it through
    check_events_bucketed on the collecting thread (no launch) with the
    sequential verdict, counted as a fallback."""
    h = gen_queue_history(random.Random(5), n_ops=40, n_procs=3,
                          n_values=12)
    ev = history_to_events(h, model="unordered-queue")
    seq = check_events_bucketed(ev, model="unordered-queue", device="cpu")
    assert seq["method"].startswith("cpu-oracle")
    reset_dispatch_stats()
    reset_launch_stats()
    with DispatchPlane(device="cpu") as plane:
        got = plane.submit(ev, model="unordered-queue").result()
    assert got == seq
    assert DISPATCH_STATS["fallbacks"] == 1
    assert LAUNCH_STATS["launches"] == 0


@pytest.mark.slow
def test_dispatch_differential_soak():
    """40 mixed register streams (clean, corrupted, crash-heavy) and 3
    queue histories through one plane with the prep worker on: the same
    verdicts (minus method/wall) as the sequential path."""
    streams = []
    for i in range(40):
        rng = random.Random(9000 + i)
        h = gen_register_history(
            rng, n_ops=60 + (i % 5) * 30, n_procs=4,
            p_crash=0.3 if i % 7 == 0 else 0.02,
        )
        if i % 4 == 1:
            h = corrupt_history(h, rng)
        streams.append(history_to_events(h))
    qhs = [History(gen_queue_history(random.Random(9500 + i), n_ops=120,
                                     n_procs=4, n_values=6).ops)
           for i in range(3)]
    seq = [check_events_bucketed(s, device="cpu", race=False)
           for s in streams]
    seq_q = [check_queue_by_value(q, "unordered-queue", device="cpu")
             for q in qhs]
    reset_dispatch_stats()
    with DispatchPlane(device="cpu", async_prep=True) as plane:
        futs = [plane.submit(s) for s in streams]
        q_outs = [check_queue_by_value(q, "unordered-queue", plane=plane)
                  for q in qhs]
        outs = [f.result() for f in futs]
    for i, (s, p) in enumerate(zip(seq, outs)):
        assert _strip(s) == _strip(p), (i, s, p)
    for s, p in zip(seq_q, q_outs):
        assert s["valid?"] == p["valid?"]
    assert DISPATCH_STATS["worker_errors"] == 0
